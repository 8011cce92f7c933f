"""``tpurun-torch``: the port's launcher CLI (port of
``horovod_tpu/run/run.py``; reference: horovod/run/run.py:374-732 and
bin/horovodrun). It parses flags and a YAML config into the ``HOROVOD_*``
knobs, checks that remote hosts answer ssh, allocates slots and fans the
command out, one worker a GPU.

    tpurun-torch -np 4 python train.py            # 4 local workers
    tpurun-torch -np 8 -H host1:4,host2:4 python train.py
    tpurun-torch --postmortem /path/to/flight-dir
    tpurun-torch --check-build

The JAX package's ``--no-jax-distributed``, ``--mesh-shape`` and the
gcloud TPU-VM backend's flags have no meaning here and are not accepted,
nor are ``--launch-backend`` (ssh is the only fan-out) and
``--start-timeout`` (the launcher sets no start deadline). A remote host
takes the launcher's address from ``-H``: it must reach the launcher's
outbound interface (the NIC-discovery ring is not ported).
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import textwrap
import time
from typing import List, Optional

from horovod_tpu_torch.run import config_parser, hosts as hosts_mod, launcher
from horovod_tpu_torch.version import __version__

PROG = "tpurun-torch"
SSH_CHECK_TIMEOUT_S = 30
# ssh reachability results are cached for an hour (run/run.py:49-60)
CACHE_TTL_S = 60 * 60
CACHE_DIR = os.path.expanduser("~/.horovod_tpu_torch")


class _RecordAction(argparse.Action):
    """Records the flags given explicitly, for the config file's
    precedence (reference: run.py:422-425)."""

    def __init__(self, option_strings, dest, nargs=None, const=None, **kw):
        self._const = const
        super().__init__(option_strings, dest, nargs=nargs, const=const, **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        if self._const is not None and values in (None, []):
            values = self._const
        setattr(namespace, self.dest, values)
        if not hasattr(namespace, "seen_args"):
            namespace.seen_args = set()
        namespace.seen_args.add(self.dest)


def _add(parser, *flags, **kw):
    if kw.get("action") == "store_true":
        kw.pop("action")
        kw.update(action=_RecordAction, nargs=0, const=True,
                  default=kw.get("default", None))
    else:
        kw.setdefault("action", _RecordAction)
    parser.add_argument(*flags, **kw)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog=PROG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description="Launch a distributed horovod_tpu_torch job, one "
                    "worker process a GPU.",
        epilog=textwrap.dedent(f"""\
            Example:
                {PROG} -np 4 -H host1:2,host2:2 python train.py

            A remote host named in -H must reach the launcher at its
            outbound interface's address, which the workers get for the
            rendezvous store (no NIC-discovery ring). Rank 0's host serves
            the world's store (HOROVOD_COORDINATOR_ADDR) on a port found
            free on the launcher's host.
            """))
    parser.add_argument("-v", "--version", action="version",
                        version=__version__)
    _add(parser, "-np", "--num-proc", dest="np", type=int,
         help="Total number of worker processes (one a GPU).")
    _add(parser, "-H", "--hosts", dest="hosts",
         help="Comma-separated host:slots list, e.g. host1:4,host2:4.")
    _add(parser, "--hostfile", dest="hostfile",
         help="mpirun-style hostfile ('hostname slots=N' a line).")
    _add(parser, "-p", "--ssh-port", dest="ssh_port", type=int,
         help="SSH port on all hosts.")
    _add(parser, "--output-filename", dest="output_dir",
         help="Capture each rank's output under <dir>/rank.N/std{out,err}.")
    _add(parser, "--verbose", dest="verbose", action="store_true",
         help="Verbose launcher logging.")
    _add(parser, "--disable-cache", dest="disable_cache",
         action="store_true", help="Do not cache ssh reachability checks.")
    parser.add_argument("--check-build", action="store_true",
                        help="Print the capability report and exit "
                             "(reference: run/run.py:268-303).")
    _add(parser, "--config-file", dest="config_file",
         help="YAML config file; flags given after it take precedence.")

    params = parser.add_argument_group("tunable parameters")
    _add(params, "--fusion-threshold-mb", dest="fusion_threshold_mb",
         type=float, help="Tensor fusion buffer threshold in MB.")
    _add(params, "--cycle-time-ms", dest="cycle_time_ms", type=float,
         help="Background cycle time in ms.")
    _add(params, "--cache-capacity", dest="cache_capacity", type=int,
         help="Response cache capacity.")
    _add(params, "--hierarchical-allreduce", dest="hierarchical_allreduce",
         action="store_true",
         help="Force the two-level (within, then across hosts) allreduce.")
    _add(params, "--hierarchical-allgather", dest="hierarchical_allgather",
         action="store_true",
         help="Force the two-level (within, then across hosts) allgather.")

    timeline = parser.add_argument_group("timeline")
    _add(timeline, "--timeline-filename", dest="timeline_filename",
         help="Chrome-trace timeline output (rank 0).")
    _add(timeline, "--timeline-mark-cycles", dest="timeline_mark_cycles",
         action="store_true", help="Mark cycles in the timeline.")
    _add(timeline, "--merge-trace", dest="merge_trace", metavar="OUT",
         help="Merge Chrome trace files (per-rank timelines, device traces "
              "as Chrome JSON / .json.gz) into OUT and exit; the inputs "
              "follow as positional arguments.")
    _add(timeline, "--merge-trace-align", dest="merge_trace_align",
         action="store_true",
         help="With --merge-trace: rebase each input's earliest event to "
              "a common origin.")

    metrics_group = parser.add_argument_group("metrics")
    _add(metrics_group, "--metrics-summary", dest="metrics_summary",
         action="store_true",
         help="Aggregate per-rank metrics dumps (HOROVOD_METRICS_DUMP) into "
              "a cross-rank min/median/max table and exit; dump files or "
              "directories of metrics-rank-*.json follow as positional "
              "arguments.")

    flight = parser.add_argument_group("flight recorder")
    _add(flight, "--flight-recorder-dir", dest="flight_recorder_dir",
         help="Directory for per-rank flight-recorder dumps "
              "(flight-rank-N.json): workers write them on failure or exit, "
              "the launcher writes the copies dead workers shipped to its "
              "store, and a failed job prints the merged postmortem. Sets "
              "HOROVOD_FLIGHT_RECORDER_DIR.")
    _add(flight, "--postmortem", dest="postmortem", metavar="DIR",
         help="Print the merged cross-rank postmortem of the flight dumps "
              "in DIR (with the supervised-restart lineage) and exit; "
              "non-zero when DIR holds no dumps.")

    profile = parser.add_argument_group("profiler")
    _add(profile, "--profile-dir", dest="profile_dir",
         help="Directory for per-rank step profiles: sets "
              "HOROVOD_PROFILE_DIR and a per-rank HOROVOD_TIMELINE; after "
              "the job the launcher merges every rank's profile, timeline "
              "and device trace onto one clock (merged-trace.json) and "
              "prints the cross-rank step report.")
    _add(profile, "--profile-report", dest="profile_report", metavar="DIR",
         help="Print the cross-rank step report of the profile dumps in "
              "DIR (merging the trace again) and exit.")

    autotune = parser.add_argument_group("autotune")
    _add(autotune, "--autotune", dest="autotune", action="store_true",
         help="Enable Bayesian autotuning of the runtime's knobs.")
    _add(autotune, "--autotune-log-file", dest="autotune_log_file",
         help="CSV log of autotune trials.")
    _add(autotune, "--autotune-warmup-samples",
         dest="autotune_warmup_samples", type=int,
         help="Discarded warmup samples per trial.")
    _add(autotune, "--autotune-steps-per-sample",
         dest="autotune_steps_per_sample", type=int,
         help="Steps per timing sample.")
    _add(autotune, "--autotune-bayes-opt-max-samples",
         dest="autotune_bayes_opt_max_samples", type=int,
         help="Max Bayesian-optimization samples.")
    _add(autotune, "--autotune-gaussian-process-noise",
         dest="autotune_gaussian_process_noise", type=float,
         help="GP noise regularization in [0, 1].")

    elastic_group = parser.add_argument_group("elastic (fault-tolerant)")
    _add(elastic_group, "--elastic", dest="elastic", action="store_true",
         help="Elastic mode: a worker's failure no longer ends the job; "
              "the survivors re-form and resume from the last commit (the "
              "script uses hvd.elastic). Sets HOROVOD_ELASTIC=1.")
    _add(elastic_group, "--min-workers", dest="min_workers", type=int,
         help="Fewest workers an elastic job may shrink to (default 1). "
              "Sets HOROVOD_ELASTIC_MIN_WORKERS.")
    _add(elastic_group, "--max-workers", dest="max_workers", type=int,
         help="Most workers an elastic job may grow to.")
    _add(elastic_group, "--host-discovery-script",
         dest="host_discovery_script",
         help="Executable printing the current 'hostname[:slots]' set, one "
              "a line; the elastic driver polls it.")
    _add(elastic_group, "--supervise", dest="supervise",
         action="store_true",
         help="Supervised restarts: when the whole job fails, launch it "
              "again (resuming from HOROVOD_CKPT_DIR when the script uses "
              "hvd.elastic state); each attempt gets "
              "HOROVOD_RESTART_ATTEMPT=<n>, and the lineage goes to the "
              "flight-recorder dir for --postmortem.")
    _add(elastic_group, "--restart-budget", dest="restart_budget", type=int,
         help="Most supervised relaunches (default 3; with --supervise).")

    serving = parser.add_argument_group("online serving")
    _add(serving, "--serve", dest="serve", action="store_true",
         help="Launch each slot as a continuous-batching serving replica. "
              "With no command, runs python -m horovod_tpu_torch.serve; "
              "with one, the command calls hvd.serve()/run_kv_replica. "
              "Replicas pull from the rendezvous store's request queue; "
              "HOROVOD_SERVE_* knobs set the batching policy.")

    stall = parser.add_argument_group("stall check")
    _add(stall, "--no-stall-check", dest="no_stall_check",
         action="store_true",
         help="Disable the stall inspector (and the lane-hazard watchdog).")
    _add(stall, "--stall-check-warning-time-seconds",
         dest="stall_check_warning_time_seconds", type=float,
         help="Seconds before a stall warning is logged.")
    _add(stall, "--stall-check-shutdown-time-seconds",
         dest="stall_check_shutdown_time_seconds", type=float,
         help="Seconds before a stall aborts the job (0 = never).")

    logging_group = parser.add_argument_group("logging")
    _add(logging_group, "--log-level", dest="log_level",
         choices=["trace", "debug", "info", "warning", "error", "fatal"],
         help="Runtime log level.")
    _add(logging_group, "--log-hide-timestamp", dest="log_hide_timestamp",
         action="store_true", help="Hide timestamps in log output.")

    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Command to run on every slot.")

    args = parser.parse_args(argv)
    if not hasattr(args, "seen_args"):
        args.seen_args = set()
    if args.config_file:
        config = config_parser.parse_config_file(args.config_file)
        config_parser.set_args_from_config_file(args, config)
    config_parser.validate_config_args(args)
    return args


def check_build(out=sys.stdout) -> None:
    """The capability report (reference: run/run.py:268-303): torch, CUDA,
    NCCL, gloo, ``nvcc``, the native cycle engine and each kernel library,
    built or not (they build from ``csrc/`` at first use)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import kernel_build
    from horovod_tpu_torch.runtime import native

    def mark(flag: bool) -> str:
        return "[X]" if flag else "[ ]"

    try:
        nvcc = kernel_build.nvcc()
    except RuntimeError:
        nvcc = None
    cuda = torch.cuda.is_available()
    cards = torch.cuda.device_count() if cuda else 0
    kernels = "\n".join(
        f"    {mark(kernel_build.library_path(src.stem).exists())} "
        f"{src.stem}" for src in sorted(kernel_build.CSRC.glob("*.cu")))
    out.write(textwrap.dedent(f"""\
        horovod_tpu_torch v{__version__}:

        Available frameworks:
            [X] PyTorch {torch.__version__}
            {mark(cuda)} CUDA {torch.version.cuda} ({cards} device(s))

        Available controllers:
            {mark(dist.is_gloo_available())} Gloo (negotiation)
            {mark(native.library_path().exists())} Native cycle engine (built)

        Available tensor operations:
            {mark(dist.is_nccl_available())} NCCL
            {mark(dist.is_gloo_available())} Gloo
            [ ] MPI

        Kernel toolchain:
            {mark(nvcc is not None)} nvcc{f' ({nvcc})' if nvcc else ''}

        Kernel libraries (built):
        """) + kernels + "\n")


# ---------------------------------------------------------------------------
# ssh reachability (reference: run/run.py:60-112, cached per run.py:49-60)
# ---------------------------------------------------------------------------

def _cache_path() -> str:
    return os.path.join(CACHE_DIR, "ssh_checks.json")


def check_all_hosts_ssh_successful(hostnames: List[str],
                                   ssh_port: Optional[int] = None,
                                   use_cache: bool = True) -> None:
    import json

    remote = [h for h in hostnames if not launcher.is_local_host(h)]
    if not remote:
        return
    cache = {}
    if use_cache and os.path.exists(_cache_path()):
        try:
            with open(_cache_path()) as f:
                cache = json.load(f)
        except (ValueError, OSError):
            cache = {}
    now = time.time()
    failed = []
    for host in remote:
        entry = cache.get(host)
        if entry and now - entry < CACHE_TTL_S:
            continue
        port_arg = f"-p {ssh_port}" if ssh_port else ""
        result = subprocess.run(
            f"ssh -o PasswordAuthentication=no -o StrictHostKeyChecking=no "
            f"{port_arg} {host} true",
            shell=True, capture_output=True, timeout=SSH_CHECK_TIMEOUT_S)
        if result.returncode == 0:
            cache[host] = now
        else:
            failed.append(host)
    if use_cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
        with open(_cache_path(), "w") as f:
            json.dump(cache, f)
    if failed:
        raise RuntimeError(
            "passwordless ssh check failed for hosts: " + ", ".join(failed)
            + ". Set up passwordless ssh or run single-host.")


# ---------------------------------------------------------------------------
# the reports that exit at once
# ---------------------------------------------------------------------------

def _merge_trace(args, command) -> int:
    from horovod_tpu_torch.timeline import merge_traces

    if not command:
        sys.stderr.write(f"{PROG} --merge-trace: no input traces\n")
        return 2
    n = merge_traces(args.merge_trace, command, align=args.merge_trace_align)
    print(f"merged {n} events from {len(command)} trace(s) into "
          f"{args.merge_trace}")
    return 0


def _metrics_summary(command) -> int:
    import glob

    from horovod_tpu_torch.metrics import format_summary, summarize_dumps

    if not command:
        sys.stderr.write(f"{PROG} --metrics-summary: no dump files\n")
        return 2
    paths: List[str] = []
    for arg in command:
        if os.path.isdir(arg):
            paths.extend(sorted(glob.glob(
                os.path.join(arg, "metrics-rank-*.json"))))
        else:
            paths.append(arg)
    if not paths:
        sys.stderr.write(f"{PROG} --metrics-summary: no metrics dump files "
                         f"found\n")
        return 1
    try:
        rows = summarize_dumps(paths)
    except (OSError, ValueError, KeyError) as exc:
        sys.stderr.write(f"{PROG} --metrics-summary: {exc}\n")
        return 2
    print(format_summary(rows, n_ranks=len(paths)))
    return 0


def _profile_report(directory: str) -> int:
    from horovod_tpu_torch import profiler

    dumps = profiler.load_dumps(directory)
    if not dumps:
        sys.stderr.write(f"{PROG} --profile-report: no profile dumps found "
                         f"in {directory!r}\n")
        return 1
    try:
        merged_path, n_events = profiler.merge_profile_dir(directory)
    except (OSError, ValueError) as exc:
        sys.stderr.write(f"{PROG} --profile-report: merge failed: {exc}\n")
        merged_path, n_events = None, 0
    print(profiler.format_step_report(dumps))
    spans = sum(len(d.get("request_spans", ())) for d in dumps)
    if spans:
        traces = {s.get("trace_id") for d in dumps
                  for s in d.get("request_spans", ())
                  if isinstance(s, dict) and s.get("trace_id")}
        print(f"{PROG}: {spans} request/collective spans across "
              f"{len(traces)} trace(s) merged into per-rank request lanes")
    if merged_path and n_events:
        print(f"{PROG}: merged trace ({n_events} events) written to "
              f"{merged_path}")
    return 0


def _postmortem(directory: str) -> int:
    from horovod_tpu_torch import flight_recorder

    dumps = flight_recorder.load_dumps(directory)
    if not dumps:
        sys.stderr.write(f"{PROG} --postmortem: no flight-recorder dumps "
                         f"found in {directory!r}\n")
        return 1
    lineage = flight_recorder.load_restart_lineage(directory)
    print(flight_recorder.format_postmortem(dumps, lineage=lineage))
    return 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.check_build:
        check_build()
        return 0
    command = list(args.command or [])
    if command and command[0] == "--":
        command = command[1:]
    if args.merge_trace:
        return _merge_trace(args, command)
    if args.metrics_summary:
        return _metrics_summary(command)
    if args.profile_report:
        return _profile_report(args.profile_report)
    if args.postmortem:
        return _postmortem(args.postmortem)
    if args.serve and not command:
        # the serving plane's default worker: a KV-queue replica a slot,
        # the same random-weight demo model on every rank
        command = [sys.executable, "-m", "horovod_tpu_torch.serve"]
    if not command:
        sys.stderr.write(f"{PROG}: no command given\n")
        return 2

    if args.hostfile:
        host_infos = hosts_mod.parse_hostfile(args.hostfile)
    elif args.hosts:
        host_infos = hosts_mod.parse_hosts(args.hosts)
    else:
        host_infos = [hosts_mod.HostInfo("localhost", args.np or 1)]
    np_ = args.np or sum(h.slots for h in host_infos)

    check_all_hosts_ssh_successful([h.hostname for h in host_infos],
                                   args.ssh_port,
                                   use_cache=not args.disable_cache)
    slots = hosts_mod.allocate(host_infos, np_)
    if args.verbose:
        for s in slots:
            sys.stderr.write(f"{PROG}: rank {s.rank} -> {s.hostname} "
                             f"(local {s.local_rank}/{s.local_size}, "
                             f"cross {s.cross_rank}/{s.cross_size})\n")

    env = dict(os.environ)
    env.update(config_parser.env_from_args(args))
    if args.elastic and args.min_workers and args.min_workers > np_:
        sys.stderr.write(f"{PROG}: --min-workers {args.min_workers} "
                         f"exceeds the launch size {np_}\n")
        return 2
    kwargs = dict(
        ssh_port=args.ssh_port, output_dir=args.output_dir,
        elastic=bool(args.elastic),
        min_workers=args.min_workers or 1, max_workers=args.max_workers,
        discovery_script=args.host_discovery_script,
        flight_recorder_dir=args.flight_recorder_dir,
        profile_dir=args.profile_dir)
    command_str = " ".join(shlex.quote(c) for c in command)
    if args.supervise:
        budget = 3 if args.restart_budget is None else args.restart_budget
        return launcher.launch_supervised(command_str, slots,
                                          restart_budget=budget, env=env,
                                          **kwargs)
    return launcher.launch_job(command_str, slots, env=env, **kwargs)


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
