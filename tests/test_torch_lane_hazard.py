"""The runtime's lane-hazard watchdog (mirrors tests/test_multiprocess.py's
``test_lane_hazard_watchdog_diagnoses_user_program_interleave`` and its
scenario, tests/mp_worker.py ``lane_hazard``).

In a 2-rank gloo world with ``HOROVOD_STALL_CHECK_TIME_SECONDS=0.5``,
rank 0 holds ``hazard/x`` in flight for 2.5 s while its caller is silent:
its log names the tensor and the hazard. A caller parked in ``wait()`` or
spinning on ``poll()`` while the peer is late is not a hazard, nor is a
peer that stalls past the stall inspector's warning while rank 0 waits:
the inspector names the missing rank, and the watchdog stays quiet. The
world-1 cases drive the watchdog's own checks on a live runtime: each
silencing condition, the inspector switched off, and one warning a stall
period. A table of books (in-flight stamps, waiters, the last poll and
enqueue, the last warning, the inspector's settings) goes through both
packages' ``_check_lane_hazard`` at one frozen clock: the same decisions.

On four cards (``gpu``) the same worker runs with one rank a card and an
NCCL data group (worker: tests/torch_lane_hazard_worker.py).
"""

import logging
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.runtime import runtime as runtime_mod
from horovod_tpu_torch.utils import logging as hlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_lane_hazard_worker.py")
DIAGNOSTIC = "interleaved in different orders across ranks"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phases(out: str) -> dict:
    """A worker's output split at its ``PHASE <name>`` lines."""
    parts, name = {}, "start"
    for line in out.splitlines():
        if line.startswith("PHASE "):
            name = line.split()[1]
            continue
        parts.setdefault(name, []).append(line)
    return {k: "\n".join(v) for k, v in parts.items()}


def _run_world(extra_env=None, cuda=False, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in list(env):
        if k.startswith("HOROVOD_"):
            env.pop(k)
    env.update({"HOROVOD_SIZE": "2",
                "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{_free_port()}",
                "HOROVOD_STALL_CHECK_TIME_SECONDS": "0.5",
                "HOROVOD_LOG_HIDE_TIME": "1"})
    env.update(extra_env or {})
    procs = [subprocess.Popen(
        [sys.executable, WORKER] + (["cuda"] if cuda else []),
        env=dict(env, HOROVOD_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, out[-3000:])
        assert f"OK rank={r}" in out, out[-3000:]
    return [_phases(o) for o in outs]


def _check_world(phases) -> None:
    hazard = phases[0]["hazard"]
    assert DIAGNOSTIC in hazard and "hazard/x" in hazard, hazard
    assert "hvd.assert_collective_lane_clear()" in hazard
    assert "torch.distributed" in hazard
    # rank 1 had nothing in flight while it was silent
    assert DIAGNOSTIC not in phases[1].get("hazard", "")
    for r in range(2):
        for name in ("wait", "poll", "stall", "end"):
            assert DIAGNOSTIC not in phases[r].get(name, ""), (r, name)
    # the stalled peer is the stall inspector's case: rank 0 coordinates
    # and names rank 1 as missing
    assert "quiet/stall [ready ranks: [0], missing ranks: [1]]" in \
        phases[0]["stall"], phases[0]["stall"]


def test_two_ranks_name_the_stuck_tensor_and_stay_quiet_for_waiters():
    _check_world(_run_world())


@pytest.mark.gpu
def test_lane_hazard_over_nccl_one_rank_a_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _check_world(_run_world(cuda=True, timeout=240))


# -- world 1: the watchdog's conditions on a live runtime ------------------

class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def rt(monkeypatch):
    for knob in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR",
                 "HOROVOD_STALL_CHECK_DISABLE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "0.5")
    hvd.shutdown()
    hvd.init(device="cpu")
    runtime = runtime_mod.get_runtime()
    lines = _Lines()
    hlog.get_logger().addHandler(lines)
    runtime.lines = lines.lines
    yield runtime
    hlog.get_logger().removeHandler(lines)
    with runtime._inflight_lock:
        runtime._inflight_names.clear()
    hvd.shutdown()


def _stuck(runtime, age=5.0):
    """Make ``stuck/a`` and ``stuck/b`` look in flight for ``age`` seconds
    behind a silent enqueue side."""
    now = time.monotonic()
    with runtime._inflight_lock:
        runtime._inflight_names.update({"stuck/b": now - age,
                                        "stuck/a": now - age + 1})
        runtime._last_enqueue_time = now - age
    runtime._last_poll_time = 0.0
    runtime._lane_last_warn = 0.0


def _warned(runtime) -> bool:
    return any(DIAGNOSTIC in line for line in runtime.lines)


def test_warns_once_a_period_naming_every_stuck_tensor(rt):
    _stuck(rt)
    rt._check_lane_hazard()
    rt._check_lane_hazard()  # same period: no second line
    hits = [line for line in rt.lines if DIAGNOSTIC in line]
    assert len(hits) == 1, rt.lines
    assert "['stuck/a', 'stuck/b']" in hits[0]
    rt._lane_last_warn -= 1.0  # a period later
    rt._check_lane_hazard()
    assert sum(DIAGNOSTIC in line for line in rt.lines) == 2


@pytest.mark.parametrize("case", ["waiter", "poll", "fresh_op",
                                  "recent_enqueue", "inspector_off",
                                  "nothing_in_flight"])
def test_quiet_unless_every_condition_holds(rt, case):
    _stuck(rt)
    now = time.monotonic()
    if case == "waiter":
        rt._waiters = 1
    elif case == "poll":
        rt._last_poll_time = now
    elif case == "fresh_op":
        with rt._inflight_lock:
            rt._inflight_names.update({"stuck/a": now, "stuck/b": now})
    elif case == "recent_enqueue":
        rt._last_enqueue_time = now
    elif case == "inspector_off":
        rt.stall_inspector.enabled = False
    else:
        with rt._inflight_lock:
            rt._inflight_names.clear()
    try:
        rt._check_lane_hazard()
    finally:
        rt._waiters = 0
        rt.stall_inspector.enabled = True
    assert not _warned(rt), rt.lines


def _books(enabled, warning_time, oldest_age, quiet, waiters, poll_age,
           warn_age, now):
    """A runtime's lane books as both packages keep them; an age of None
    is a stamp never set (0.0, the constructors' value)."""
    import threading
    from types import SimpleNamespace

    def stamp(age):
        return 0.0 if age is None else now - age

    names = ({} if oldest_age is None else
             {"b/late": now - oldest_age, "a/early": now - oldest_age / 2})
    return SimpleNamespace(
        stall_inspector=SimpleNamespace(enabled=enabled,
                                        warning_time=warning_time),
        _inflight_lock=threading.Lock(), _inflight_names=names,
        _waiters=waiters, _last_poll_time=stamp(poll_age),
        _last_enqueue_time=now - quiet, _lane_last_warn=stamp(warn_age))


@pytest.mark.parametrize("warning_time", [0.0, 0.5, 2.0])
def test_decisions_are_the_jax_runtimes(warning_time, monkeypatch):
    """Every combination of the books, at one frozen clock, through the
    JAX runtime's ``_check_lane_hazard`` (horovod_tpu/runtime/runtime.py)
    and the port's: warned or not (the warning stamps ``_lane_last_warn``)
    the same each time, and both warn somewhere in the table."""
    import itertools
    from types import SimpleNamespace

    from horovod_tpu.runtime import runtime as jruntime_mod

    now = 10_000.0
    clock = SimpleNamespace(monotonic=lambda: now)
    monkeypatch.setattr(jruntime_mod, "time", clock)
    monkeypatch.setattr(runtime_mod, "time", clock)
    monkeypatch.setattr(jruntime_mod.log, "warning", lambda *a, **k: None)
    monkeypatch.setattr(runtime_mod.log, "warning", lambda *a, **k: None)
    ages = (0.1, 1.0, 5.0)
    grid = itertools.product((True, False), (None,) + ages, ages, (0, 1),
                             (None, 0.1, 5.0), (None, 0.1, 5.0))
    warned = []
    for enabled, oldest, quiet, waiters, poll_age, warn_age in grid:
        decisions = []
        for check in (jruntime_mod.Runtime._check_lane_hazard,
                      runtime_mod.Runtime._check_lane_hazard):
            books = _books(enabled, warning_time, oldest, quiet, waiters,
                           poll_age, warn_age, now)
            check(books)
            decisions.append(books._lane_last_warn == now)
        assert decisions[0] == decisions[1], (
            enabled, oldest, quiet, waiters, poll_age, warn_age)
        warned.append(decisions[1])
    assert any(warned) == (warning_time > 0) and not all(warned)


def test_disable_knob_turns_the_watchdog_off(monkeypatch):
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    for knob in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        runtime = runtime_mod.get_runtime()
        lines = _Lines()
        hlog.get_logger().addHandler(lines)
        try:
            runtime.lines = lines.lines
            _stuck(runtime)
            runtime._check_lane_hazard()
            assert not _warned(runtime)
        finally:
            hlog.get_logger().removeHandler(lines)
            with runtime._inflight_lock:
                runtime._inflight_names.clear()
    finally:
        hvd.shutdown()


def test_handles_keep_the_books(rt):
    """An enqueue stamps its name and the quiet clock, its completion
    retires the name, and a duplicate name keeps the original's stamp."""
    before = rt._last_enqueue_time
    h = hvd.allreduce_async(torch.ones(3), name="books/x")
    assert rt._last_enqueue_time > before
    hvd.synchronize(h)
    assert "books/x" not in rt._inflight_names
    assert rt._waiters == 0
    hvd.poll(h)
    assert time.monotonic() - rt._last_poll_time < 5.0
