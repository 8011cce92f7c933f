"""Process fan-out: one worker a slot, locally or over ssh (port of
``horovod_tpu/run/launcher.py``; reference: horovod/run/gloo_run.py:211-301).

For every allocated slot the launcher builds the worker's environment (the
slot's contract, the world's store, the rendezvous KV store, the knobs),
spawns the command (exec locally, ssh for a remote host), streams its
output with a ``[rank]<stream>:`` prefix (and, with ``output_dir``, into
``<output_dir>/rank.N/``), and ends the whole job when a worker exits
non-zero (gloo_run.py:256-262) or the launcher gets SIGINT or SIGTERM.

The port's worker contract (``core/basics.py``): ``hvd.init()`` joins the
world at ``HOROVOD_COORDINATOR_ADDR``, the c10d ``TCPStore`` that
``torch.distributed.rendezvous`` makes from a ``tcp://`` address, whose
master is rank 0. So the launcher points that address at rank 0's host and
a port it found free on its own host (for a local job, the same host; for
a remote rank 0 the port is a guess that a busy port there defeats). The
launcher hosts the rendezvous KV store (``HOROVOD_RENDEZVOUS_HTTP_ADDR`` and
``_PORT``), through which the elastic layer re-forms and the workers ship
their flight-recorder dumps and step profiles. The workers reach that
store at the address ``get_driver_ip`` finds: loopback for a local job,
else the launcher's outbound interface. The NIC-discovery ring that proves
an address every remote host reaches is not ported, so a remote host must
reach the launcher at that address (name the hosts with ``-H`` as they
resolve from the launcher). No socket controller and no ``jax.distributed``
variables are written. A worker takes ``cuda:<HOROVOD_LOCAL_RANK>`` unless its program
asks ``hvd.init`` for the CPU.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.run import util
from horovod_tpu_torch.run.hosts import SlotInfo
from horovod_tpu_torch.run.rendezvous import RendezvousServer

LOCAL_HOSTNAMES = {"localhost", "127.0.0.1", "::1"}
RESTART_LINEAGE_FILE = "restart-lineage.json"


def is_local_host(hostname: str) -> bool:
    if hostname in LOCAL_HOSTNAMES:
        return True
    try:
        return hostname in (socket.gethostname(), socket.getfqdn())
    except OSError:
        return False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        return s.getsockname()[1]


def _announce_net_chaos() -> None:
    """Log the armed network-fault clauses once at launch: a chaos run
    whose faults fail to parse tests nothing."""
    from horovod_tpu_torch.utils import resilience

    spec = os.environ.get("HOROVOD_FAULT_INJECT", "")
    if not spec:
        return
    try:
        faults = resilience.parse_net_faults(spec)
    except ValueError as exc:
        print(f"tpurun-torch: ignoring malformed HOROVOD_FAULT_INJECT net "
              f"clause: {exc}", file=sys.stderr)
        return
    if faults:
        print("tpurun-torch: network chaos armed: "
              + "; ".join(str(f) for f in faults), file=sys.stderr)


def get_driver_ip(slots: List[SlotInfo]) -> str:
    """The address remote workers reach the launcher's host at."""
    if all(is_local_host(s.hostname) for s in slots):
        return "127.0.0.1"
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # no packet is sent
            return s.getsockname()[0]
    except OSError:
        return socket.gethostname()


def coordinator_host(slots: List[SlotInfo]) -> str:
    """Rank 0's host, where the world's ``TCPStore`` listens."""
    host = next(s.hostname for s in slots if s.rank == 0)
    return "127.0.0.1" if is_local_host(host) else host


def build_worker_env(slot: SlotInfo, base_env: Dict[str, str],
                     driver_ip: str, http_port: int,
                     coordinator_addr: str) -> Dict[str, str]:
    """A worker's whole environment: the slot's contract (reference:
    gloo_run.py:211-240), the world's store at ``coordinator_addr``
    (``host:port`` on rank 0's host) and the launcher's rendezvous KV
    store."""
    env = dict(base_env)
    env.update(slot.to_env())
    # one launcher setting fans out to a path a rank (--profile-dir's
    # timeline-rank-N.json)
    if "{rank}" in env.get("HOROVOD_TIMELINE", ""):
        env["HOROVOD_TIMELINE"] = env["HOROVOD_TIMELINE"].format(
            rank=slot.rank)
    env.update({
        "HOROVOD_COORDINATOR_ADDR": coordinator_addr,
        "HOROVOD_RENDEZVOUS_HTTP_ADDR": driver_ip,
        "HOROVOD_RENDEZVOUS_HTTP_PORT": str(http_port),
    })
    return env


def launch_job(command: str, slots: List[SlotInfo],
               env: Optional[Dict[str, str]] = None,
               ssh_port: Optional[int] = None,
               output_dir: Optional[str] = None,
               prefix_output: bool = True,
               elastic: bool = False,
               min_workers: int = 1,
               max_workers: Optional[int] = None,
               discovery_script: Optional[str] = None,
               flight_recorder_dir: Optional[str] = None,
               profile_dir: Optional[str] = None) -> int:
    """Run ``command`` on every slot; the job's exit code (the first
    failed worker's, else 0). The rendezvous KV store lives for the job.

    ``elastic``: a worker's non-zero exit no longer ends the job; the
    survivors re-form on their own and the job fails only when fewer than
    ``min_workers`` could remain. With a ``discovery_script`` the port's
    :class:`~horovod_tpu_torch.elastic.driver.ElasticDriver` polls it and
    publishes host-change notices through the store.

    ``flight_recorder_dir``: the workers write their flight dumps there and
    ship copies to the store; the launcher writes the shipped copy of a
    rank that left no file and, when the job failed, prints the merged
    postmortem naming the suspected rank.

    ``profile_dir``: the step profiler on every worker
    (``HOROVOD_PROFILE_DIR`` and a per-rank ``HOROVOD_TIMELINE``); after
    the job the launcher writes the shipped profiles, merges every rank's
    timeline, markers and device trace onto one clock and prints the
    cross-rank step report."""
    from horovod_tpu_torch.run.backends import command_for_slot

    base_env = dict(os.environ if env is None else env)
    if flight_recorder_dir:
        base_env["HOROVOD_FLIGHT_RECORDER_DIR"] = flight_recorder_dir
    if profile_dir:
        base_env["HOROVOD_PROFILE_DIR"] = profile_dir
        base_env["HOROVOD_TIMELINE"] = os.path.join(
            profile_dir, "timeline-rank-{rank}.json")
        try:
            os.makedirs(profile_dir, exist_ok=True)
        except OSError as exc:
            print(f"tpurun-torch: cannot create profile dir "
                  f"{profile_dir!r}: {exc}", file=sys.stderr)
    driver_ip = get_driver_ip(slots)
    coordinator_addr = f"{coordinator_host(slots)}:{_free_port()}"

    rendezvous = RendezvousServer(
        host="127.0.0.1" if driver_ip == "127.0.0.1" else "0.0.0.0")
    http_port = rendezvous.start()
    _announce_net_chaos()

    elastic_driver = None
    if elastic and discovery_script:
        from horovod_tpu_torch.elastic.driver import (ElasticDriver,
                                                      HostDiscoveryScript)

        elastic_driver = ElasticDriver(
            rendezvous, HostDiscoveryScript(discovery_script),
            min_workers=min_workers, max_workers=max_workers)
        elastic_driver.start()

    exit_codes: List[Optional[int]] = [None] * len(slots)
    failure = threading.Event()
    first_failure: List[Optional[int]] = [None]
    failure_lock = threading.Lock()

    def run_slot(i: int, slot: SlotInfo) -> None:
        worker_env = build_worker_env(slot, base_env, driver_ip, http_port,
                                      coordinator_addr)
        if elastic:
            worker_env["HOROVOD_ELASTIC"] = "1"
            worker_env["HOROVOD_ELASTIC_MIN_WORKERS"] = str(min_workers)
        cmd = command_for_slot(slot, command, worker_env, ssh_port)
        stdout = stderr = None
        files = []
        try:
            if output_dir:
                rank_dir = os.path.join(output_dir, f"rank.{slot.rank}")
                os.makedirs(rank_dir, exist_ok=True)
                stdout = open(os.path.join(rank_dir, "stdout"), "w")
                stderr = open(os.path.join(rank_dir, "stderr"), "w")
                files = [stdout, stderr]
            code = util.execute(
                cmd, env=worker_env,
                stdout=stdout or sys.stdout, stderr=stderr or sys.stderr,
                index=slot.rank, events=[failure],
                prefix_output=prefix_output)
            exit_codes[i] = code
            if code not in (0, None):
                with failure_lock:
                    failed = sum(1 for c in exit_codes if c not in (0, None))
                    # elastic: the survivors re-form on their own; the job
                    # ends only once fewer than min_workers could remain.
                    # Otherwise the first failed worker's code is the
                    # job's, not those of the workers torn down after it.
                    if not elastic or len(slots) - failed < min_workers:
                        if not failure.is_set():
                            first_failure[0] = code
                        failure.set()
        finally:
            for f in files:
                f.close()

    threads = [threading.Thread(target=run_slot, args=(i, s), daemon=True)
               for i, s in enumerate(slots)]

    prev_handlers = {}

    def on_signal(signum, frame):
        failure.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            prev_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread
            pass

    shipped: Dict[str, bytes] = {}
    shipped_profile: Dict[str, bytes] = {}
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        if elastic_driver is not None:
            elastic_driver.stop()
        # the store lives in this process: collect before stopping it
        if flight_recorder_dir:
            shipped = _harvest(rendezvous, flight_recorder.RENDEZVOUS_SCOPE)
        if profile_dir:
            from horovod_tpu_torch import profiler

            shipped_profile = _harvest(rendezvous, profiler.RENDEZVOUS_SCOPE)
        rendezvous.stop()

    code = _job_exit_code(exit_codes, first_failure[0], elastic, min_workers)
    if flight_recorder_dir:
        _finalize_flight_dumps(flight_recorder_dir, shipped, code)
    if profile_dir:
        _finalize_profile(profile_dir, shipped_profile)
    return code


def _harvest(rendezvous: RendezvousServer, scope: str) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    try:
        for key in rendezvous.live_keys(scope):
            value = rendezvous.get(scope, key)
            if value:
                out[key] = value
    except Exception as exc:
        print(f"tpurun-torch: could not collect the shipped {scope} "
              f"dumps: {exc}", file=sys.stderr)
    return out


def _job_exit_code(exit_codes: List[Optional[int]],
                   first_failure: Optional[int], elastic: bool,
                   min_workers: int) -> int:
    if elastic and sum(1 for c in exit_codes if c == 0) >= min_workers:
        # enough workers finished cleanly: the lost ones were absorbed by
        # the survivors' re-form
        return 0
    if first_failure is not None:
        return first_failure
    for code in exit_codes:
        if code not in (0, None):
            return code
    return 1 if elastic or any(c is None for c in exit_codes) else 0


def launch_supervised(command: str, slots: List[SlotInfo],
                      restart_budget: int = 3,
                      env: Optional[Dict[str, str]] = None,
                      **kwargs) -> int:
    """``launch_job`` under supervision: a failed job (an exit the elastic
    layer could not absorb) is launched again, up to ``restart_budget``
    times; a checkpoint directory (``HOROVOD_CKPT_DIR``) makes the relaunch
    resume. Each attempt runs with ``HOROVOD_RESTART_ATTEMPT=<n>``, and the
    lineage (each attempt's exit code and wall times) goes to
    ``restart-lineage.json`` in the flight-recorder directory, where
    ``--postmortem`` folds it into the report."""
    from horovod_tpu_torch.ckpt import io as ckpt_io

    base_env = dict(os.environ if env is None else env)
    flight_dir = kwargs.get("flight_recorder_dir")
    lineage: List[dict] = []
    attempt = 0
    while True:
        base_env["HOROVOD_RESTART_ATTEMPT"] = str(attempt)
        t0 = time.time()
        code = launch_job(command, slots, env=dict(base_env), **kwargs)
        lineage.append({"attempt": attempt, "exit_code": code,
                        "started": t0, "ended": time.time(),
                        "restart_budget": restart_budget})
        if flight_dir:
            try:
                os.makedirs(flight_dir, exist_ok=True)
                ckpt_io.atomic_write(
                    os.path.join(flight_dir, RESTART_LINEAGE_FILE),
                    json.dumps({"attempts": lineage}, indent=1).encode(),
                    base="lineage")
            except Exception as exc:
                print(f"tpurun-torch: could not record the restart "
                      f"lineage: {exc}", file=sys.stderr)
        if code == 0:
            if attempt:
                print(f"tpurun-torch: job succeeded on supervised restart "
                      f"{attempt}/{restart_budget}", file=sys.stderr)
            return 0
        if attempt >= restart_budget:
            print(f"tpurun-torch: restart budget exhausted "
                  f"({restart_budget} restarts); giving up with exit "
                  f"code {code}", file=sys.stderr)
            return code
        attempt += 1
        print(f"tpurun-torch: job failed (exit {code}); supervised restart "
              f"{attempt}/{restart_budget}", file=sys.stderr)


def _write_shipped(directory: str, shipped: Dict[str, bytes],
                   prefix: str) -> None:
    """Write each shipped ``rank.N`` copy whose rank left no file (a file
    the worker wrote is at least as fresh)."""
    for key, value in shipped.items():
        if not key.startswith("rank."):
            continue
        path = os.path.join(directory, f"{prefix}{key[len('rank.'):]}.json")
        if os.path.exists(path):
            continue
        try:
            with open(path, "wb") as f:
                f.write(value)
        except OSError as exc:
            print(f"tpurun-torch: could not write {path}: {exc}",
                  file=sys.stderr)


def _finalize_flight_dumps(directory: str, shipped: Dict[str, bytes],
                           exit_code: int) -> None:
    """Write the shipped dumps of ranks that left no file and, when the
    job failed, print the merged cross-rank postmortem."""
    try:
        os.makedirs(directory, exist_ok=True)
    except OSError as exc:
        print(f"tpurun-torch: cannot write flight-recorder dumps to "
              f"{directory!r}: {exc}", file=sys.stderr)
        return
    _write_shipped(directory, shipped, flight_recorder.DUMP_PREFIX)
    if exit_code == 0:
        return
    dumps = flight_recorder.load_dumps(directory)
    if dumps:
        print(flight_recorder.format_postmortem(dumps), file=sys.stderr)
    else:
        print(f"tpurun-torch: job failed but no flight-recorder dumps were "
              f"found in {directory!r}", file=sys.stderr)


def _finalize_profile(directory: str, shipped: Dict[str, bytes]) -> None:
    """Write the shipped profiles of ranks that left no file, merge every
    rank's timeline, device trace and step markers onto one clock, and
    print the cross-rank step report."""
    from horovod_tpu_torch import profiler

    try:
        os.makedirs(directory, exist_ok=True)
    except OSError as exc:
        print(f"tpurun-torch: cannot write profiles to {directory!r}: "
              f"{exc}", file=sys.stderr)
        return
    _write_shipped(directory, shipped, profiler.DUMP_PREFIX)
    try:
        merged_path, n_events = profiler.merge_profile_dir(directory)
    except Exception as exc:
        print(f"tpurun-torch: could not merge profile traces: {exc}",
              file=sys.stderr)
        merged_path, n_events = None, 0
    dumps = profiler.load_dumps(directory)
    if dumps:
        print(profiler.format_step_report(dumps))
    if merged_path and n_events:
        print(f"tpurun-torch: merged trace ({n_events} events) written to "
              f"{merged_path}")
