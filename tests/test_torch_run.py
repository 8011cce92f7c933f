"""The port's launcher, ``tpurun-torch`` (mirrors tests/test_run.py).

Host parsing, slot allocation and the slot's environment are held to the
JAX package's functions; the flags, the config file's precedence, the
process-tree kill and the ssh fan-out's commands mirror the JAX tests. A
local ``-np 2`` fan-out runs a tiny port worker that allreduces on gloo
through the launcher's store, writes its flight dumps and exits non-zero
on rank 1: the job fails with that code, prints the merged postmortem, and
``--postmortem`` reads the dumps again.

Left out by decision: the SPMD global-mesh test (``jax.distributed``), the
gcloud TPU-VM backend's tests, and those of the NIC-discovery ring and its
wire (not ported).
"""

import io
import json
import os
import sys
import textwrap
import threading
import time

import pytest

from horovod_tpu.run import hosts as jhosts
from horovod_tpu_torch.run import (backends, config_parser, hosts, launcher,
                                   util)
from horovod_tpu_torch.run.run import (check_build, parse_args,
                                       run_commandline)

HOST_STRINGS = ["h1:2,h2:2", "h1:3,h2:1", "h1:4,h2:4", "h1, h2:4,h3",
                "a:1,b:3,c:2,d:5", "[::1]:2,10.0.0.7:3"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """The launcher copies the environment into its workers: keep this
    process's world knobs out of them."""
    for k in list(os.environ):
        if k.startswith("HOROVOD_"):
            monkeypatch.delenv(k)


# -- hosts and slots, held to the JAX package ------------------------------

@pytest.mark.parametrize("spec", HOST_STRINGS)
def test_parse_hosts_allocate_and_env_equal_the_jax_functions(spec):
    ours, theirs = hosts.parse_hosts(spec), jhosts.parse_hosts(spec)
    assert [(h.hostname, h.slots) for h in ours] == \
        [(h.hostname, h.slots) for h in theirs]
    total = sum(h.slots for h in ours)
    for np_ in sorted({1, total // 2 or 1, total}):
        a, b = hosts.allocate(ours, np_), jhosts.allocate(theirs, np_)
        assert [vars(s) for s in a] == [vars(s) for s in b]
        assert [s.to_env() for s in a] == [s.to_env() for s in b]


def test_parse_hostfile_equals_the_jax_function(tmp_path):
    path = tmp_path / "hostfile"
    path.write_text("h1 slots=2\n# comment\nh2 slots=4\nh3\n")
    ours = hosts.parse_hostfile(str(path))
    assert [(h.hostname, h.slots) for h in ours] == [
        ("h1", 2), ("h2", 4), ("h3", 1)] == [
        (h.hostname, h.slots) for h in jhosts.parse_hostfile(str(path))]


def test_allocate_heterogeneous_and_oversubscribed():
    by_rank = {s.rank: s for s in hosts.allocate(
        hosts.parse_hosts("h1:3,h2:1"), 4)}
    assert by_rank[3].hostname == "h2" and by_rank[3].cross_rank == 1
    assert by_rank[0].cross_size == 2 and by_rank[1].cross_size == 1
    with pytest.raises(ValueError):
        hosts.allocate(hosts.parse_hosts("h1:2"), 3)
    with pytest.raises(ValueError):
        hosts.parse_hosts(" , ")


def test_worker_env_is_the_ports_contract():
    slots = hosts.allocate(hosts.parse_hosts("localhost:2"), 2)
    env = launcher.build_worker_env(
        slots[1], {"HOROVOD_TIMELINE": "/t/tl-{rank}.json", "KEEP": "1"},
        "127.0.0.1", 4321, "127.0.0.1:5555")
    assert env["HOROVOD_RANK"] == "1" and env["HOROVOD_LOCAL_RANK"] == "1"
    assert env["HOROVOD_COORDINATOR_ADDR"] == "127.0.0.1:5555"
    assert env["HOROVOD_RENDEZVOUS_HTTP_ADDR"] == "127.0.0.1"
    assert env["HOROVOD_RENDEZVOUS_HTTP_PORT"] == "4321"
    assert env["HOROVOD_TIMELINE"] == "/t/tl-1.json"
    assert env["KEEP"] == "1"
    for socket_or_jax in ("HOROVOD_CONTROLLER", "HOROVOD_CPU_OPERATIONS",
                          "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                          "HOROVOD_GLOO_RENDEZVOUS_PORT",
                          "HOROVOD_NUM_PROCESSES", "HOROVOD_PROCESS_ID"):
        assert socket_or_jax not in env
    # the store listens on rank 0's host
    remote = hosts.allocate(hosts.parse_hosts("node-a:1,node-b:1"), 2)
    assert launcher.coordinator_host(remote) == "node-a"
    assert launcher.coordinator_host(slots) == "127.0.0.1"


# -- flags, config file and environment -----------------------------------

def test_args_to_env():
    args = parse_args(
        ["-np", "2", "--fusion-threshold-mb", "32", "--cycle-time-ms", "7.5",
         "--cache-capacity", "2048", "--timeline-filename", "/tmp/t.json",
         "--autotune", "--log-level", "debug", "--flight-recorder-dir",
         "/tmp/fr", "python", "train.py"])
    env = config_parser.env_from_args(args)
    assert env["HOROVOD_FUSION_THRESHOLD"] == str(32 * 1024 * 1024)
    assert env["HOROVOD_CYCLE_TIME"] == "7.5"
    assert env["HOROVOD_CACHE_CAPACITY"] == "2048"
    assert env["HOROVOD_TIMELINE"] == "/tmp/t.json"
    assert env["HOROVOD_AUTOTUNE"] == "1"
    assert env["HOROVOD_LOG_LEVEL"] == "debug"
    assert env["HOROVOD_FLIGHT_RECORDER_DIR"] == "/tmp/fr"
    assert args.command == ["python", "train.py"]


def test_every_knob_it_yields_is_one_the_port_reads():
    from horovod_tpu_torch.utils import env as tenv

    args = parse_args(
        ["--fusion-threshold-mb", "1", "--cycle-time-ms", "1",
         "--cache-capacity", "1", "--hierarchical-allreduce",
         "--hierarchical-allgather", "--timeline-filename", "t",
         "--timeline-mark-cycles", "--autotune", "--autotune-log-file", "l",
         "--autotune-warmup-samples", "1", "--autotune-steps-per-sample",
         "1", "--autotune-bayes-opt-max-samples", "1",
         "--autotune-gaussian-process-noise", "0.1", "--no-stall-check",
         "--stall-check-warning-time-seconds", "1",
         "--stall-check-shutdown-time-seconds", "1", "--log-level", "info",
         "--log-hide-timestamp", "--flight-recorder-dir", "d", "cmd"])
    knobs = config_parser.env_from_args(args)
    assert len(knobs) == 19
    source = open(tenv.__file__).read()
    assert [k for k in knobs if f'"{k}"' not in source] == []
    with pytest.raises(SystemExit):
        parse_args(["--no-jax-distributed", "cmd"])
    with pytest.raises(SystemExit):
        parse_args(["--mesh-shape", "1,2", "cmd"])


@pytest.mark.parametrize("flags", [
    ["--launch-backend", "ssh"], ["--start-timeout", "60"],
    ["--no-jax-distributed"], ["--mesh-shape", "1,2"]])
def test_flags_decided_out_are_refused(flags, capsys):
    """Flags of the JAX launcher that would do nothing here: a one-valued
    backend selector, a start deadline the launcher does not set, and the
    JAX data plane's knobs."""
    with pytest.raises(SystemExit):
        parse_args(flags + ["cmd"])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_config_file_and_cli_precedence(tmp_path):
    config = tmp_path / "cfg.yaml"
    config.write_text(textwrap.dedent("""\
        params:
            fusion_threshold_mb: 16
            cycle_time_ms: 3.0
        timeline:
            filename: /tmp/from_config.json
        stall_check:
            enabled: false
        """))
    args = parse_args(["-np", "2", "--config-file", str(config),
                       "--cycle-time-ms", "9.0", "cmd"])
    env = config_parser.env_from_args(args)
    assert env["HOROVOD_FUSION_THRESHOLD"] == str(16 * 1024 * 1024)
    assert env["HOROVOD_CYCLE_TIME"] == "9.0"  # the flag after the file
    assert env["HOROVOD_TIMELINE"] == "/tmp/from_config.json"
    assert env["HOROVOD_STALL_CHECK_DISABLE"] == "1"
    # an explicit flag wins wherever it stands, as in the JAX package
    from horovod_tpu.run import config_parser as jcp
    from horovod_tpu.run.run import parse_args as jparse

    argv = ["--cycle-time-ms", "9.0", "--config-file", str(config), "cmd"]
    args = parse_args(argv)
    assert "cycle_time_ms" in args.seen_args
    assert config_parser.env_from_args(args)["HOROVOD_CYCLE_TIME"] == "9.0"
    theirs = jcp.env_from_args(jparse(argv))
    assert {k: v for k, v in theirs.items() if k != "HOROVOD_MESH_SHAPE"} \
        == config_parser.env_from_args(args)


def test_validation_rejects_bad_values():
    with pytest.raises(ValueError):
        parse_args(["-np", "2", "--cycle-time-ms", "-1", "cmd"])
    with pytest.raises(ValueError):
        parse_args(["--cache-capacity", "-3", "cmd"])


def test_check_build_reports_what_the_port_has():
    out = io.StringIO()
    check_build(out)
    text = out.getvalue()
    for line in ("PyTorch", "CUDA", "NCCL", "Gloo", "nvcc",
                 "Native cycle engine", "flash_attention", "adamw",
                 "conv_bn_act", "attention_probe", "conv_bn_stats"):
        assert line in text, line
    assert "JAX" not in text and "XLA" not in text


# -- process tree, the ssh fan-out ----------------------------------------

def test_safe_exec_kills_process_tree():
    event = threading.Event()
    results = {}

    def run():
        results["code"] = util.execute(
            f"{sys.executable} -c 'import time; time.sleep(60)'",
            events=[event], prefix_output=False)

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.5)
    event.set()
    t.join(timeout=20)
    assert not t.is_alive()
    assert results["code"] != 0


def test_ssh_backend_commands():
    local = hosts.SlotInfo("localhost", rank=0, local_rank=0, local_size=2,
                           cross_rank=0, cross_size=1, size=2)
    remote = hosts.SlotInfo("worker-7", rank=1, local_rank=1, local_size=2,
                            cross_rank=0, cross_size=1, size=2)
    assert backends.command_for_slot(local, "python train.py", {},
                                     ssh_port=2222) == "python train.py"
    cmd = backends.command_for_slot(
        remote, "python train.py",
        {"HOROVOD_RANK": "1", "NCCL_DEBUG": "INFO", "SECRET_TOKEN": "x"},
        ssh_port=2222)
    assert cmd.startswith("ssh ") and "-p 2222" in cmd and "worker-7" in cmd
    assert "HOROVOD_RANK=1" in cmd and "NCCL_DEBUG=INFO" in cmd
    assert "SECRET_TOKEN" not in cmd


# -- local fan-out ---------------------------------------------------------

WORKER = textwrap.dedent("""\
    import json, os, sys
    import torch
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.rank()
    got = hvd.allreduce(torch.full((4,), float(r + 1)), average=False,
                        name="launch/x")
    keys = [k for k in os.environ if k.startswith("HOROVOD_")]
    with open(os.path.join(sys.argv[1], f"rank_{r}.json"), "w") as f:
        json.dump({"sum": got.tolist(), "size": hvd.size(),
                   "env": {k: os.environ[k] for k in keys}}, f)
    hvd.shutdown()
    print(f"worker {r} done", flush=True)
    sys.exit(3 if r == 1 else 0)
""")


def test_local_fanout_allreduces_on_gloo_fails_and_prints_postmortem(
        tmp_path, capfd):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    flight = tmp_path / "flight"
    t0 = time.monotonic()
    code = run_commandline(
        ["-np", "2", "--cycle-time-ms", "2.5", "--flight-recorder-dir",
         str(flight), sys.executable, str(script), str(tmp_path)])
    assert time.monotonic() - t0 < 120
    out, err = capfd.readouterr()
    assert code == 3, out + err  # rank 1's exit is the job's
    assert "[0]<stdout>: worker 0 done" in out
    assert "[1]<stdout>: worker 1 done" in out
    for r in range(2):
        got = json.loads((tmp_path / f"rank_{r}.json").read_text())
        assert got["sum"] == [3.0] * 4 and got["size"] == 2
        env = got["env"]
        assert env["HOROVOD_RANK"] == str(r)
        assert env["HOROVOD_SIZE"] == "2"
        assert env["HOROVOD_LOCAL_SIZE"] == "2"
        assert env["HOROVOD_CROSS_SIZE"] == "1"
        assert env["HOROVOD_CYCLE_TIME"] == "2.5"
        assert env["HOROVOD_COORDINATOR_ADDR"].startswith("127.0.0.1:")
        assert env["HOROVOD_FLIGHT_RECORDER_DIR"] == str(flight)
        assert "HOROVOD_GLOO_RENDEZVOUS_PORT" not in env
    # the failed job printed the merged postmortem of both ranks' dumps
    assert sorted(p.name for p in flight.iterdir()) == [
        "flight-rank-0.json", "flight-rank-1.json"]
    assert "postmortem" in err.lower() and "rank 1" in err, err[-3000:]
    assert run_commandline(["--postmortem", str(flight)]) == 0
    report = capfd.readouterr().out
    assert "rank 0" in report and "rank 1" in report
    assert "launch/x" in report or "shutdown" in report
    assert run_commandline(["--postmortem", str(tmp_path / "none")]) == 1


def test_failure_propagates_and_tears_the_job_down(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(textwrap.dedent("""\
        import os, sys, time
        if os.environ["HOROVOD_RANK"] == "1":
            sys.exit(3)
        time.sleep(30)  # killed, not run for 30 s
    """))
    t0 = time.monotonic()
    assert run_commandline(["-np", "2", sys.executable, str(script)]) == 3
    assert time.monotonic() - t0 < 25


def test_output_capture(tmp_path):
    outdir = tmp_path / "logs"
    assert run_commandline(
        ["-np", "2", "--output-filename", str(outdir), sys.executable, "-c",
         "import os; print('hello from', os.environ['HOROVOD_RANK'])"]) == 0
    for r in range(2):
        assert f"hello from {r}" in (outdir / f"rank.{r}" /
                                     "stdout").read_text()


def test_elastic_absorbs_a_lost_worker_and_supervise_relaunches(tmp_path):
    script = tmp_path / "lose.py"
    script.write_text(textwrap.dedent("""\
        import os, sys
        assert os.environ["HOROVOD_ELASTIC"] == "1"
        assert os.environ["HOROVOD_ELASTIC_MIN_WORKERS"] == "1"
        sys.exit(5 if os.environ["HOROVOD_RANK"] == "1" else 0)
    """))
    assert run_commandline(["-np", "2", "--elastic", "--min-workers", "1",
                            sys.executable, str(script)]) == 0
    assert run_commandline(["-np", "2", "--elastic", "--min-workers", "3",
                            sys.executable, str(script)]) == 2
    flaky = tmp_path / "flaky.py"
    flaky.write_text(textwrap.dedent("""\
        import os, sys
        sys.exit(0 if os.environ["HOROVOD_RESTART_ATTEMPT"] == "1" else 4)
    """))
    flight = tmp_path / "flight"
    assert run_commandline(["-np", "1", "--supervise", "--restart-budget",
                            "2", "--flight-recorder-dir", str(flight),
                            sys.executable, str(flaky)]) == 0
    lineage = json.loads((flight / launcher.RESTART_LINEAGE_FILE)
                         .read_text())["attempts"]
    assert [a["exit_code"] for a in lineage] == [4, 0]


def test_serve_defaults_to_the_ports_replica_and_no_command_errors(
        monkeypatch):
    seen = {}

    def fake_launch(command, slots, **kw):
        seen.update(command=command, np=len(slots))
        return 0

    monkeypatch.setattr(launcher, "launch_job", fake_launch)
    assert run_commandline(["-np", "3", "--serve"]) == 0
    assert seen["np"] == 3
    assert seen["command"].endswith(" -m horovod_tpu_torch.serve")
    assert run_commandline(["-np", "2"]) == 2
