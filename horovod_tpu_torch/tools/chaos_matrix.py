"""The chaos matrix on the port (port of ``tools/chaos_matrix.py``): each
cell runs a real multi-process world of the port's workers under an
injected fault, with the rendezvous store in this process standing in for
the launcher, and checks the cell's expectations. One JSON summary goes to
stdout; the exit status is 0 only when every cell met its expectations.

    python -m horovod_tpu_torch.tools.chaos_matrix [--only NAME]
        [--device cuda|cpu] [--json PATH]

The workers (``chaos_worker``, ``ckpt_chaos_worker``,
``zero2_chaos_worker``, ``serve_chaos_worker`` beside this file) meet at
``HOROVOD_COORDINATOR_ADDR`` (a TCP store their rank 0 hosts) and re-form
through this process's store. By default a rank takes ``cuda:<rank>``
(NCCL) and the serving cell's replicas run GPT-2-small on ``cuda:0``; a
cell whose world needs more cards than the host has is refused before it
starts. ``--device cpu`` runs every cell as a gloo world on the CPU, with
the serving cell's tiny model. The dumps
are read with the port's own ``flight_recorder.load_dumps`` and
``format_postmortem``. The port has no socket controller and no host ring
(decided in the port's runtime), so no transport is required to be built.

The cells and their expectations:

* ``flaky_negotiate``: ``flaky:0.3`` on the control plane for 8 s. The
  JAX package retries a reset socket; on the port a reset gloo verb is a
  ``WorkerLostError`` and a re-form, so the port's expectation is a
  re-form (generation >= 1) with zero lost steps and the injections
  counted.
* ``netdelay_negotiate``: a fixed latency an op; it completes, the
  injections are counted, and every rank's shutdown dump embeds the comms
  ledger with traffic on the ``device`` lane (the port's one data plane),
  which the postmortem renders.
* ``kv_outage_reform``: rank 1 killed at step 3 while the store answers 503
  for 5 s from the first re-form registration: the survivors bridge the
  outage (retries counted), re-form and finish with ``w == step``.
* ``hier_cross_kill``: two ranks of a six-rank hierarchical world (3 groups
  of 2, the cross hop throttled) killed mid-run; the survivors re-form at
  world 4, the executor builds the 2 x 2 groups afresh and no step is lost.
* ``partition_collective_timeout``: rank 1 partitioned for good mid-run;
  the survivors trip ``HOROVOD_COLLECTIVE_TIMEOUT``, re-form, finish, and
  the merged postmortem names rank 1.
* ``ckpt_kill_mid_commit``: rank 1 killed at the publish phase of step 3's
  two-phase commit (``CHAOS_CKPT_PHASE`` moves it to ``stage`` or
  ``barrier``): no step-3 manifest, every manifest left restores
  ``w == step`` bit for bit, the newest is the last step.
* ``ckpt_reform_sharded_adamw``: rank 1 killed at step 3 under ZeRO-1
  sharded AdamW: its moment segments come back from its neighbour's
  replica (nonzero, uniform), not zero-filled.
* ``zero2_kill_mid_reducescatter``: rank 1 killed inside a stage-2 bucket
  reduce-scatter: the survivors re-shard, reach the expected weights and
  leak no fusion slab.
* ``serve_kill_replica``: rank 0 drives load through a ``KVQueueFrontend``
  at three replicas; rank 2 is killed at its 5th decode step. Every
  request completes (``zero_lost``), the dead replica's requests were sent
  again (``requeued``), and the postmortem names rank 2.
* ``integrity_bitflip_rollback``: a one-shot bit flip in rank 1's copy of
  the 5th allreduce: the digests' vote names rank 1, every rank rolls back
  in place to the last checkpoint and replays, ``w == step``, and the
  postmortem names rank 1.
* ``goodput_attribution``: a bit flip on rank 2's 3rd allreduce, then rank
  1 killed at step 5 under a store outage: every survivor's goodput ledger
  accounts >= 90 % of its wall clock, the replay lands in ``rollback``,
  the re-form in ``elastic_reform``, and the postmortem's goodput report
  names the costliest incident and its culprit rank.
* ``integrity_nan_skipstep``: a one-shot NaN in rank 1's 5th allreduce
  with the digests off: the step guard skips that step in lockstep and
  the run ends on the exact weights.
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.run.rendezvous import RendezvousServer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKERS = "horovod_tpu_torch.tools."


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SCENARIOS = {
    "flaky_negotiate": {
        "world": 2,
        "env": {
            "HOROVOD_FAULT_INJECT": "flaky:0.3:seconds=8",
            "HOROVOD_NET_MAX_RETRIES": "12",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
            "CHAOS_STEP_SLEEP": "0.2",
        },
        # the port's expectation: a reset verb is a re-form, no step lost
        "require_reform": True,
        "require_injections": True,
        "timeout": 180,
    },
    "netdelay_negotiate": {
        "world": 2,
        "env": {
            "HOROVOD_FAULT_INJECT": "netdelay:10",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
        },
        "require_injections": True,
        "require_comms_state": True,
        "timeout": 180,
    },
    "kv_outage_reform": {
        "world": 3,
        "env": {
            "HOROVOD_FAULT_INJECT":
                "kill:rank=1:step=3:code=17;kv_outage:5:on=reform",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
        },
        "expected_exit": {1: 17},
        "require_retries": True,
        "require_reform": True,
        "timeout": 240,
    },
    "hier_cross_kill": {
        "world": 6,
        "env": {
            "HOROVOD_FAULT_INJECT":
                "netdelay:5:hop=cross;"
                "kill:rank=4:step=3:code=17;"
                "kill:rank=5:step=5:code=19:gen=1",
            "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
            "HOROVOD_HIERARCHY_GROUP_SIZE": "2",
            "HOROVOD_ELASTIC_MIN_WORKERS": "4",
        },
        "expected_exit": {4: 17, 5: 19},
        "require_injections": True,
        "require_reform": True,
        "require_true": ("hier_enabled",),
        "require_hier_groups": 2,
        "timeout": 300,
    },
    "partition_collective_timeout": {
        "world": 3,
        "env": {
            "HOROVOD_FAULT_INJECT": "partition:1:600:after=4",
            "HOROVOD_COLLECTIVE_TIMEOUT": "4",
            "HOROVOD_GLOO_TIMEOUT_SECONDS": "8",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
            "CHAOS_STEP_SLEEP": "1.0",
        },
        "hung_ranks": [1],
        "require_reform": True,
        "require_culprit": 1,
        "timeout": 240,
    },
    "ckpt_kill_mid_commit": {
        "world": 3,
        "ckpt": True,
        "env": {
            "HOROVOD_CKPT_FAULT":
                "kill:rank=1:phase="
                + os.environ.get("CHAOS_CKPT_PHASE", "publish")
                + ":step=3:code=19",
            "HOROVOD_CKPT_ASYNC": "0",
            "HOROVOD_CKPT_KEEP": "20",
            "HOROVOD_CKPT_BARRIER_TIMEOUT_SECONDS": "3",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
        },
        "expected_exit": {1: 19},
        "require_reform": True,
        "ckpt_verify": "midcommit",
        "timeout": 240,
    },
    "ckpt_reform_sharded_adamw": {
        "world": 3,
        "worker": "ckpt_chaos_worker",
        "ckpt": True,
        "env": {
            "HOROVOD_FAULT_INJECT": "kill:rank=1:step=3:code=17",
            "HOROVOD_CKPT_ASYNC": "0",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
        },
        "expected_exit": {1: 17},
        "require_reform": True,
        "check_w": False,
        "require_true": ["steps_ok", "moments_nonzero",
                         "moments_uniform", "replica_restored"],
        "ckpt_verify": "manifest",
        "timeout": 240,
    },
    "zero2_kill_mid_reducescatter": {
        "world": 3,
        "worker": "zero2_chaos_worker",
        "env": {
            "ZERO2_KILL_STEP": "3",
            "ZERO2_KILL_RANK": "1",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
        },
        "expected_exit": {1: 17},
        "require_reform": True,
        "require_true": ["resharded", "leases_ok"],
        "timeout": 240,
    },
    "serve_kill_replica": {
        # the replicas share cuda:0; the frontend takes no card
        "cards": 1,
        "world": 4,   # rank 0 the frontend, ranks 1-3 replicas
        "worker": "serve_chaos_worker",
        "env": {
            "HOROVOD_FAULT_INJECT": "kill:rank=2:step=5:code=21",
            "HOROVOD_SERVE_SLOTS": "4",
            "HOROVOD_SERVE_MAX_NEW_TOKENS": "16",
            "HOROVOD_SERVE_DECODE_BLOCK": "4",
            "HOROVOD_SERVE_ADMISSION_MS": "10",
        },
        "expected_exit": {2: 21},
        "check_w": False,
        "require_true": ["zero_lost", "requeued"],
        "require_culprit": 2,
        "timeout": 240,
    },
    "integrity_bitflip_rollback": {
        "world": 3,
        "ckpt": True,
        "env": {
            "HOROVOD_FAULT_INJECT": "bitflip:1:after=4",
            "HOROVOD_INTEGRITY": "1",
            "HOROVOD_INTEGRITY_INTERVAL": "1",
            "HOROVOD_CKPT_ASYNC": "0",
            "HOROVOD_ELASTIC_MIN_WORKERS": "3",
        },
        "require_true": ["integrity_violations", "rollbacks"],
        "require_culprit": 1,
        "ckpt_verify": "manifest",
        "timeout": 240,
    },
    "goodput_attribution": {
        "world": 3,
        "ckpt": True,
        "env": {
            "HOROVOD_FAULT_INJECT":
                "bitflip:2:after=2;"
                "kill:rank=1:step=5:code=17;"
                "kv_outage:5:on=reform",
            "HOROVOD_INTEGRITY": "1",
            "HOROVOD_INTEGRITY_INTERVAL": "1",
            "HOROVOD_CKPT_ASYNC": "0",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
            "CHAOS_STEP_SLEEP": "0.2",
        },
        "expected_exit": {1: 17},
        "require_retries": True,
        "require_reform": True,
        "require_true": ["integrity_violations", "rollbacks"],
        "require_goodput": True,
        "ckpt_verify": "manifest",
        "timeout": 240,
    },
    "integrity_nan_skipstep": {
        "world": 2,
        "env": {
            "HOROVOD_FAULT_INJECT": "nan:1:after=4",
            "HOROVOD_INTEGRITY": "1",
            # digests off: the NaN reaches every rank's reduced gradient,
            # and the step guard, not the collective plane, catches it
            "HOROVOD_INTEGRITY_INTERVAL": "0",
            "CHAOS_INTEGRITY_GUARD": "1",
            "HOROVOD_ELASTIC_MIN_WORKERS": "2",
        },
        "require_true": ["skipped_steps"],
        "timeout": 180,
    },
}


def verify_ckpt_midcommit(ckpt_dir: str, total: int, failures: list) -> None:
    """Every manifest left restores bit for bit (the loop adds exactly 1.0
    a step, so ``w == float32(step)``), the abandoned step-3 manifest does
    not exist, and the newest cut is the last step."""
    import torch

    from horovod_tpu_torch import ckpt
    from horovod_tpu_torch.ckpt import manifest as mf

    steps = mf.all_steps(ckpt_dir)
    if 3 in steps:
        failures.append("step-3 manifest exists: the publish-phase kill "
                        "should have abandoned that commit")
    if not steps or max(steps) != total:
        failures.append(f"newest manifest is {max(steps) if steps else None}"
                        f", want {total} (steps: {steps})")
    target = {"params": {"w": torch.zeros(4)}, "optimizer": None}
    for s in steps:
        try:
            trees, _ = ckpt.restore_step(ckpt_dir, s, target)
        except Exception as exc:
            failures.append(f"restore_step({s}) failed: {exc}")
            continue
        w = trees["params"]["w"].cpu()
        if not torch.equal(w, torch.full((4,), float(s))):
            failures.append(f"step {s} restored w={w.tolist()}: not the "
                            f"committed value {float(s)}")


def verify_ckpt_manifest(ckpt_dir: str, total: int, failures: list) -> None:
    """The newest manifest is the last step and every shard file it names
    passes its whole-file digest."""
    from horovod_tpu_torch.ckpt import manifest as mf

    steps = mf.all_steps(ckpt_dir)
    if not steps or max(steps) != total:
        failures.append(f"newest manifest is {max(steps) if steps else None}"
                        f", want {total} (steps: {steps})")
        return
    try:
        mf.verify_manifest_files(ckpt_dir, mf.load_manifest(ckpt_dir,
                                                            max(steps)))
    except Exception as exc:
        failures.append(f"final manifest failed verification: {exc}")


def collect_dumps(flight_dir: str, server) -> list:
    """The flight-rank-*.json files and the dumps shipped to the store's
    ``flight`` scope, one a launch rank (the shipped copy wins: it is at
    least as recent as the file)."""
    by_rank = {}
    for d in flight_recorder.load_dumps(flight_dir):
        by_rank[d.get("launch_rank", d.get("rank"))] = d
    for key in server.live_keys(flight_recorder.RENDEZVOUS_SCOPE):
        raw = server.get(flight_recorder.RENDEZVOUS_SCOPE, key)
        try:
            d = json.loads(raw)
        except (TypeError, ValueError):
            continue
        by_rank[d.get("launch_rank", d.get("rank"))] = d
    return list(by_rank.values())


def check_results(spec: dict, results: dict, codes: list, outs: list,
                  total: int) -> list:
    """The failures of a cell's expectations on its ranks' exit codes and
    ``CHAOS_RESULT`` lines (``results``: rank -> dict)."""
    failures = []
    world = spec["world"]
    hung = set(spec.get("hung_ranks", ()))
    expected_exit = dict(spec.get("expected_exit", {}))
    for i in range(world):
        if i in hung:
            if i in results:
                failures.append(f"rank {i} was expected to hang (partition)"
                                f" but completed: {results[i]}")
            continue
        want, got = expected_exit.get(i, 0), codes[i]
        if got != want:
            failures.append(f"rank {i}: unexpected exit {got} (wanted "
                            f"{want}); tail: {outs[i][-800:]!r}")
    survivors = [results[i] for i in sorted(results)
                 if i not in hung and expected_exit.get(i, 0) == 0]
    if not survivors:
        failures.append("no surviving rank reported CHAOS_RESULT")
    if spec.get("check_w", True):
        for r in survivors:
            if r["step"] != total or abs(r["w"] - total) > 1e-4:
                failures.append(f"lost steps on rank {r['rank']}: step="
                                f"{r['step']} w={r['w']} (want {total})")
    for field in spec.get("require_true", ()):
        for r in survivors:
            if not r.get(field):
                failures.append(f"rank {r['rank']}: expected {field}=true,"
                                f" got {r.get(field)!r}")
    want_groups = spec.get("require_hier_groups")
    if want_groups is not None:
        for r in survivors:
            if r.get("hier_groups") != want_groups:
                failures.append(f"rank {r['rank']}: expected the re-formed "
                                f"plan to run {want_groups} groups, got "
                                f"{r.get('hier_groups')!r}")
    if spec.get("require_retries") and not sum(
            r["net_retries_total"] for r in survivors):
        failures.append("expected nonzero horovod_net_retries_total")
    if spec.get("require_injections") and not sum(
            r["chaos_injected_total"] for r in survivors):
        failures.append("expected nonzero horovod_net_chaos_injected_total")
    if spec.get("require_reform") and not any(
            r["generation"] >= 1 for r in survivors):
        failures.append("expected an elastic re-form (generation >= 1)")
    if spec.get("require_goodput"):
        for r in survivors:
            acct = r.get("goodput_accounted")
            if not isinstance(acct, (int, float)) or acct < 0.9:
                failures.append(f"rank {r['rank']}: goodput ledger accounts "
                                f"{acct!r} of wall-clock, want >= 0.9")
            badput = r.get("goodput_badput") or {}
            if not badput.get("rollback"):
                failures.append(f"rank {r['rank']}: no rollback badput "
                                f"({badput})")
            if not badput.get("elastic_reform"):
                failures.append(f"rank {r['rank']}: re-form downtime "
                                f"missing from elastic_reform ({badput})")
            if not r.get("goodput_replayed"):
                failures.append(f"rank {r['rank']}: ledger recorded no "
                                "replayed steps")
    return failures


def check_dumps(spec: dict, dumps: list, failures: list) -> str:
    """The dump-side expectations; the postmortem text checked, if any."""
    world = spec["world"]
    if spec.get("require_comms_state"):
        ledgers = [(d.get("state") or {}).get("comms") for d in dumps]
        ledgers = [c for c in ledgers if isinstance(c, dict)]
        if len(ledgers) < world:
            failures.append(f"only {len(ledgers)}/{world} dumps embedded the "
                            "comms state provider")
        elif not any(((c.get("lanes") or {}).get("device") or {})
                     .get("bytes_total") for c in ledgers):
            failures.append("comms ledgers recorded no device-lane traffic")
        elif "=== comms report" not in flight_recorder.format_postmortem(
                dumps):
            failures.append("postmortem lacks the comms report section")
    if spec.get("require_goodput"):
        text = flight_recorder.format_postmortem(dumps)
        if "=== goodput report" not in text:
            failures.append("postmortem lacks the goodput report section")
        elif "costliest incident:" not in text:
            failures.append("goodput report does not name the costliest "
                            "incident:\n" + text)
        elif "culprit rank" not in text:
            failures.append("goodput report's costliest incident names no "
                            "culprit rank:\n" + text)
    culprit = spec.get("require_culprit")
    if culprit is None:
        return ""
    text = flight_recorder.format_postmortem(dumps)
    if f"suspected culprit: rank {culprit}" not in text:
        failures.append(f"postmortem does not name rank {culprit}:\n" + text)
    return text


def check_cards(name: str, spec: dict, device: str) -> None:
    """Refuse a cell on the cards when the host has fewer than it needs (a
    card a rank, unless the cell says otherwise)."""
    if device == "cpu":
        return
    if device != "cuda":
        raise ValueError(f"device {device!r}: cuda or cpu")
    import torch

    need, have = spec.get("cards", spec["world"]), torch.cuda.device_count()
    if have < need:
        raise RuntimeError(
            f"cell {name} needs {need} CUDA device(s) and this host has "
            f"{have}; --device cpu runs it as a gloo world on the CPU")


def run_scenario(name: str, spec: dict, extra_env=None,
                 keep_outputs: bool = False, device: str = "cuda") -> dict:
    """Run one cell on ``device`` (``cuda``: a card a rank; ``cpu``: gloo);
    its summary (``ok``, ``failures``, each rank's result and exit code,
    ``seconds``, the postmortem's tail; with ``keep_outputs`` each rank's
    output)."""
    check_cards(name, spec, device)
    world = spec["world"]
    timeout = spec.get("timeout", 240)
    hung = set(spec.get("hung_ranks", ()))
    module = WORKERS + spec.get("worker", "chaos_worker")
    flight_dir = tempfile.mkdtemp(prefix="chaos-flight-")
    ckpt_dir = (tempfile.mkdtemp(prefix="chaos-ckpt-")
                if spec.get("ckpt") else None)
    # the store stands in for the launcher's, which reads the fault spec
    # (a kv_outage window) from its own environment
    spec_env = {**spec.get("env", {}), **(extra_env or {})}
    saved = os.environ.get("HOROVOD_FAULT_INJECT")
    os.environ["HOROVOD_FAULT_INJECT"] = spec_env.get(
        "HOROVOD_FAULT_INJECT", "")
    try:
        server = RendezvousServer(host="127.0.0.1")
    finally:
        if saved is None:
            os.environ.pop("HOROVOD_FAULT_INJECT")
        else:
            os.environ["HOROVOD_FAULT_INJECT"] = saved
    http_port = server.start()
    coordinator = f"127.0.0.1:{_free_port()}"
    procs, outs = [], [""] * world
    t0 = time.monotonic()
    try:
        base = dict(os.environ)
        for k in list(base):
            if k.startswith("HOROVOD_"):
                base.pop(k)
        base.update({
            "PYTHONPATH": os.pathsep.join(
                p for p in (REPO, os.environ.get("PYTHONPATH")) if p),
            "OMP_NUM_THREADS": "1",
            "HOROVOD_SIZE": str(world),
            "HOROVOD_COORDINATOR_ADDR": coordinator,
            "HOROVOD_RENDEZVOUS_HTTP_ADDR": "127.0.0.1",
            "HOROVOD_RENDEZVOUS_HTTP_PORT": str(http_port),
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_GLOO_TIMEOUT_SECONDS": "5",
            "HOROVOD_ELASTIC_SETTLE_SECONDS": "0.5",
            "HOROVOD_FLIGHT_RECORDER_DIR": flight_dir,
            "CHAOS_DEVICE": device,
        })
        if ckpt_dir:
            base["HOROVOD_CKPT_DIR"] = ckpt_dir
        base.update(spec_env)
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module],
                env=dict(base, HOROVOD_RANK=str(rank)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        # wait for every rank that ends on its own; a partitioned rank
        # blocks for good by design and is reaped after the survivors
        deadline = time.monotonic() + timeout
        waiting = {i for i in range(world) if i not in hung}
        while waiting and time.monotonic() < deadline:
            waiting = {i for i in waiting if procs[i].poll() is None}
            time.sleep(0.2)
        seconds = time.monotonic() - t0
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=30)[0] or ""
        results = {}
        for i, out in enumerate(outs):
            for line in out.splitlines():
                if line.startswith("CHAOS_RESULT "):
                    results[i] = json.loads(line[len("CHAOS_RESULT "):])
        codes = [p.returncode for p in procs]
        total = int(os.environ.get("CHAOS_TOTAL_STEPS", "8"))
        failures = [f"rank {i} did not finish within {timeout}s"
                    for i in sorted(waiting)]
        failures += check_results(spec, results, codes, outs, total)
        if ckpt_dir and spec.get("ckpt_verify") == "midcommit":
            verify_ckpt_midcommit(ckpt_dir, total, failures)
        elif ckpt_dir and spec.get("ckpt_verify") == "manifest":
            verify_ckpt_manifest(ckpt_dir, total, failures)
        postmortem = check_dumps(spec, collect_dumps(flight_dir, server),
                                 failures)
        survivors = [r for i, r in results.items() if i not in hung]
        summary = {
            "scenario": name,
            "device": device,
            "ok": not failures,
            "failures": failures,
            "seconds": round(seconds, 3),
            "results": [results.get(i) for i in range(world)],
            "exit_codes": codes,
            "net_retries_total": sum(r.get("net_retries_total", 0)
                                     for r in survivors),
            "chaos_injected_total": sum(r.get("chaos_injected_total", 0)
                                        for r in survivors),
            "postmortem_tail": postmortem.splitlines()[-12:],
        }
        if keep_outputs:
            summary["outputs"] = outs
        return summary
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
        shutil.rmtree(flight_dir, ignore_errors=True)
        if ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run the port's chaos matrix (see the module's doc).")
    parser.add_argument("--only", help="run a single cell by name")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default): a card a rank over NCCL; "
                             "cpu: gloo worlds on the CPU")
    parser.add_argument("--json", help="also write the summary to a file")
    args = parser.parse_args(argv)
    names = [args.only] if args.only else list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(json.dumps({"ok": False,
                          "error": f"unknown scenario {unknown[0]!r}"}))
        return 1
    try:
        for name in names:
            check_cards(name, SCENARIOS[name], args.device)
    except RuntimeError as exc:
        print(json.dumps({"ok": False, "error": str(exc)}))
        return 1
    summary = {"ok": True, "device": args.device, "scenarios": []}
    for name in names:
        print(f"chaos_matrix: running {name} ...", file=sys.stderr,
              flush=True)
        result = run_scenario(name, SCENARIOS[name], device=args.device)
        summary["scenarios"].append(result)
        summary["ok"] = summary["ok"] and result["ok"]
        print(f"chaos_matrix: {name}: "
              f"{'ok' if result['ok'] else 'FAILED'} in "
              f"{result['seconds']:.1f} s, exit codes "
              f"{result['exit_codes']}", file=sys.stderr, flush=True)
    text = json.dumps(summary, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
