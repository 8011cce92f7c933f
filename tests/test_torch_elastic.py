"""The port's elastic layer, process-local (mirrors tests/test_elastic.py):
the exception hierarchy, ``Backoff``, the fault grammar, ``State`` /
``ObjectState`` / ``ArrayState`` (snapshots of tensors changed in place,
ZeRO states, the checkpoint directory, the leaf keys), the rendezvous
store against the JAX package's client and server, the driver, the host
notice and a re-form at world 1, the stall inspector's elastic verdict,
the metric families and ``Config.elastic``. Parity with the JAX package
is bit-equal. The re-forms of real worlds are in
tests/test_torch_elastic_multiprocess.py."""

import dataclasses
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import exceptions as jexc
from horovod_tpu.elastic import fault_inject as jfault
from horovod_tpu.elastic import runner as jrunner
from horovod_tpu.elastic.driver import ElasticDriver as JElasticDriver
from horovod_tpu.run import rendezvous as jrdv
from horovod_tpu_torch import exceptions
from horovod_tpu_torch.elastic import (ArrayState, Backoff, FaultSpec,
                                       ObjectState, fault_inject, runner)
from horovod_tpu_torch.elastic.driver import (ElasticDriver,
                                              HostDiscoveryScript)
from horovod_tpu_torch.run.rendezvous import KVStoreClient, RendezvousServer
from horovod_tpu_torch.stall import StallInspector


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


# ---------------------------------------------------------------------------
# exceptions
# ---------------------------------------------------------------------------

_NAMES = ("HorovodInternalError", "WorkersDownError", "WorkerLostError",
          "WorkerStallError", "NumericalError", "CollectiveIntegrityError",
          "CheckpointCorruptError", "HostsUpdatedInterrupt")


def test_hierarchy_is_the_jax_packages():
    for a in _NAMES:
        for b in _NAMES:
            assert issubclass(getattr(exceptions, a),
                              getattr(exceptions, b)) == \
                issubclass(getattr(jexc, a), getattr(jexc, b)), (a, b)
        assert issubclass(getattr(exceptions, a), RuntimeError) == \
            issubclass(getattr(jexc, a), RuntimeError), a


def test_ranks_and_suspect_carried():
    e = exceptions.WorkerLostError("gone", ranks=[2, 1])
    assert e.ranks == (2, 1) == jexc.WorkerLostError("g", ranks=[2, 1]).ranks
    assert exceptions.WorkersDownError("x").ranks == ()
    c = exceptions.CollectiveIntegrityError("x", bucket="b", suspect_rank=3)
    assert (c.bucket, c.suspect_rank) == ("b", 3)
    assert str(exceptions.HostsUpdatedInterrupt()) == "host set updated"


def test_exported_at_package_root():
    assert hvd.WorkersDownError is exceptions.WorkersDownError
    assert hvd.HostsUpdatedInterrupt is exceptions.HostsUpdatedInterrupt
    assert hvd.elastic.run is runner.run
    assert hvd.elastic.restarts() == 0
    for name in ("run", "State", "ObjectState", "ArrayState", "restarts",
                 "Backoff", "start_heartbeat", "check_host_updates"):
        assert hasattr(hvd.elastic, name), name


# ---------------------------------------------------------------------------
# backoff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(base=0.5, factor=2.0, max_delay=3.0, retries=5),
    dict(retries=0), dict(base=0.1, factor=1.5, max_delay=0.7, retries=9),
    dict(base=2.0, factor=1.0, retries=3)])
def test_backoff_schedule_is_the_jax_packages(kw):
    assert Backoff(**kw).schedule() == jrunner.Backoff(**kw).schedule()
    assert Backoff(base=0.5, factor=2.0, max_delay=3.0,
                   retries=5).schedule() == [0.5, 1.0, 2.0, 3.0, 3.0]


def test_backoff_invalid_params_raise():
    for kw in (dict(base=0), dict(factor=0.5), dict(retries=-1)):
        with pytest.raises(ValueError):
            Backoff(**kw)


def test_backoff_from_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_BACKOFF_BASE_SECONDS", "1.0")
    monkeypatch.setenv("HOROVOD_ELASTIC_BACKOFF_MAX_SECONDS", "4.0")
    monkeypatch.setenv("HOROVOD_ELASTIC_MAX_RETRIES", "3")
    assert Backoff.from_env().schedule() == \
        jrunner.Backoff.from_env().schedule() == [1.0, 2.0, 4.0]


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "kill:rank=1:step=3:code=17", "hang:rank=0:step=2:seconds=5:gen=1",
    "slow:rank=2:step=0:seconds=0.25", " KILL : rank=4 : step=9 ",
    "explode:rank=0:step=1", "kill:rank=0", "kill:step=1",
    "kill:rank=x:step=1", "kill:rank=1:step=2:color=3", "kill:rank1", "",
])
def test_parse_spec_is_the_jax_packages(spec):
    try:
        want = jfault.parse_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            fault_inject.parse_spec(spec)
        return
    assert dataclasses.asdict(fault_inject.parse_spec(spec)) == \
        dataclasses.asdict(want)


def test_multiple_process_clauses_all_armed(monkeypatch):
    monkeypatch.setenv(
        "HOROVOD_FAULT_INJECT",
        "netdelay:5;nan:1:after=2;"
        "kill:rank=4:step=3:code=17;kill:rank=5:step=5:code=19:gen=1")
    specs = fault_inject.specs_from_env()
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in jfault.specs_from_env()]
    assert [(s.rank, s.step, s.code, s.generation) for s in specs] \
        == [(4, 3, 17, 0), (5, 5, 19, 1)]
    assert fault_inject.spec_from_env() == specs[0]
    assert isinstance(specs[0], FaultSpec)
    # consulted, matching neither: still alive
    fault_inject.maybe_inject(step=5, rank=5, generation=0)
    fault_inject.maybe_inject(step=4, rank=5, generation=1)


def test_maybe_inject_ignores_other_rank_step_and_generation(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "kill:rank=7:step=3")
    fault_inject.maybe_inject(step=3, rank=0)
    fault_inject.maybe_inject(step=2, rank=7)
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "kill:rank=0:step=3:gen=2")
    fault_inject.maybe_inject(step=3, rank=0, generation=0)


def test_slow_sleeps_every_step_from_its_own(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_INJECT",
                       "slow:rank=0:step=2:seconds=0.05")
    t0 = time.monotonic()
    fault_inject.maybe_inject(step=1, rank=0)
    assert time.monotonic() - t0 < 0.04
    for step in (2, 3):
        t0 = time.monotonic()
        fault_inject.maybe_inject(step=step, rank=0)
        assert time.monotonic() - t0 >= 0.045


# ---------------------------------------------------------------------------
# state commit / restore
# ---------------------------------------------------------------------------

def test_object_state_round_trip_by_value_and_callbacks():
    state = ObjectState(batch=0, table={"a": 1}, history=[1, 2])
    state.batch = 5
    state.table["a"] = 2
    state.commit()
    state.batch = 9
    state.table["a"] = 99
    state.history.append(3)
    calls = []
    state.register_reset_callbacks([lambda: calls.append("a"),
                                    lambda: calls.append("b")])
    state.on_reset()
    assert (state.batch, state.table, state.history) == \
        (5, {"a": 2}, [1, 2])
    assert calls == ["a", "b"]


def test_array_state_round_trip_in_place():
    state = ArrayState(params={"w": torch.zeros(3)},
                       optimizer={"m": torch.ones(3)}, step=0)
    w, m = state.params["w"], state.optimizer["m"]
    w += 2
    state.step = 4
    state.commit()
    w.mul_(50)
    m.mul_(50)
    state.step = 7
    state.restore()
    assert state.step == 4
    assert state.params["w"] is w and state.optimizer["m"] is m
    assert torch.equal(w, torch.full((3,), 2.0))
    assert torch.equal(m, torch.ones(3))


def test_array_state_initial_values_and_extra_trees():
    state = ArrayState(params={"w": torch.arange(3)}, optimizer=None,
                       ema={"w": torch.ones(2)}, note={"epoch": 1})
    state.params["w"].fill_(-1)
    state.ema["w"].mul_(3)
    state.note["epoch"] = 5
    state.restore()  # a failure before the first commit: the start
    assert torch.equal(state.params["w"], torch.arange(3))
    assert torch.equal(state.ema["w"], torch.ones(2))
    assert state.note == {"epoch": 1}


def test_array_state_holds_a_modules_parameters():
    model = torch.nn.Linear(3, 2)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = ArrayState(model, None)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    state.restore()
    assert state.params is model
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_snapshots_alternate_two_slab_sets_and_then_allocate_nothing():
    state = ArrayState(params={"w": torch.zeros(8),
                               "h": torch.zeros(4, dtype=torch.bfloat16)},
                       optimizer=None)
    first = state.slab_allocations
    assert first == 2  # one set: a slab a dtype
    state.commit()
    assert state.slab_allocations == 2 * first
    for _ in range(3):
        state.params["w"] += 1
        state.commit()
    assert state.slab_allocations == 2 * first
    # a snapshot never aliases the live tensor it copied
    state.params["w"] += 1
    state.restore()
    assert torch.equal(state.params["w"], torch.full((8,), 3.0))


def test_leaf_keys_are_the_jax_packages():
    from horovod_tpu.elastic.state import ArrayState as JArrayState

    rng = np.random.default_rng(0)
    a, b, m = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 2), (4,), (5,)))
    theirs = JArrayState(params={"b": b, "a": a}, optimizer={"m": m},
                         zeta=[a, b], alpha={"x": m})
    ours = ArrayState(params={"b": torch.from_numpy(b),
                              "a": torch.from_numpy(a)},
                      optimizer={"m": torch.from_numpy(m)},
                      zeta=[torch.from_numpy(a), torch.from_numpy(b)],
                      alpha={"x": torch.from_numpy(m)})
    for name in ("alpha", "optimizer", "params", "zeta"):
        assert ours._leaf_key_base(name) == theirs._leaf_key_base(name)


def test_zero_state_round_trip_in_place(world1):
    from horovod_tpu_torch.parallel import zero

    params = {"a": torch.linspace(-1, 1, 15).reshape(5, 3),
              "b": torch.linspace(0, 2, 7)}
    tx = hvd.sharded_adamw(1e-2)
    state = ArrayState(params, tx.init(params))
    grads = {k: torch.cos(v) for k, v in params.items()}
    _, state.optimizer = tx.apply(params, state.optimizer, grads)
    state.step = 1
    state.commit()
    snap = zero.export_shard_arrays(state.optimizer)
    master = state.optimizer.master[0]
    _, state.optimizer = tx.apply(params, state.optimizer, grads)
    assert not torch.equal(master, snap["master"][0])
    state.restore()
    got = zero.export_shard_arrays(state.optimizer)
    assert state.optimizer.master[0] is master  # restored in place
    for c in ("master", "mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(got[c], snap[c]))
    assert state.optimizer.count == 1


def test_sync_at_world1_keeps_the_values(world1):
    state = ArrayState(params={"w": torch.ones(2)}, optimizer=None, step=3,
                       note={"k": 1})
    state.sync(root_rank=0)
    assert state.step == 3 and torch.equal(state.params["w"], torch.ones(2))
    assert state.note == {"k": 1}


def test_sync_spill_writes_checkpoint(world1, tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_SPILL_SYNC", "1")
    state = ArrayState(params={"w": torch.ones(2)}, optimizer=None, step=0,
                       spill_dir=str(tmp_path))
    state.step = 2
    state.commit()
    assert hvd.checkpoint.latest_step(str(tmp_path)) == 2


def test_ckpt_dir_commits_uncopied_and_loads_the_latest(world1, tmp_path):
    params = {"a": torch.linspace(-1, 1, 15).reshape(5, 3)}
    tx = hvd.sharded_adamw(1e-2)
    state = ArrayState(params, tx.init(params), step=0,
                       ckpt_dir=str(tmp_path))
    for step in (1, 2):
        _, state.optimizer = tx.apply(params, state.optimizer,
                                      {"a": torch.sin(params["a"] * step)})
        state.step = step
        state.commit()
    state.checkpoint_wait()
    assert hvd.ckpt.latest_step(str(tmp_path)) == 2
    want = params["a"].clone()
    params["a"].zero_()
    state.step = 5
    assert state.load_latest() == 2
    assert state.step == 2 and torch.equal(params["a"], want)


# ---------------------------------------------------------------------------
# rendezvous: long-poll, TTL, key listing, both packages on the wire
# ---------------------------------------------------------------------------

@pytest.fixture
def rendezvous():
    server = RendezvousServer(host="127.0.0.1", heartbeat_ttl=0.3)
    port = server.start()
    yield server, port
    server.stop()


def test_long_poll_wakes_on_put(rendezvous):
    _, port = rendezvous
    client = KVStoreClient("127.0.0.1", port, scope="s", timeout=10,
                           long_poll=5.0)
    threading.Timer(0.3, client.set, args=("k", b"v")).start()
    t0 = time.monotonic()
    assert client.get("k") == b"v"
    assert time.monotonic() - t0 < 3.0


def test_keys_nowait_ttl_and_server_put(rendezvous):
    server, port = rendezvous
    client = KVStoreClient("127.0.0.1", port, scope="m", timeout=1)
    with pytest.raises(KeyError):
        client.get("missing", wait=False)
    client.set("member.0", b"a")
    client.set("member.2", b"b")
    assert client.keys("m") == ["member.0", "member.2"]
    assert client.keys("empty-scope") == []
    time.sleep(0.2)
    client.set("member.3", b"c")
    assert client.keys("m", ttl=0.1) == ["member.3"]
    server.put("elastic.notice", "update", b"notice-1")
    assert client.get("update", scope="elastic.notice", wait=False) == \
        b"notice-1"
    client.finish("member.3")
    assert server.finished_keys("m") == {"member.3"}
    client.clear_scope("m")
    assert client.keys("m") == []


def test_heartbeat_ttl_expires(rendezvous):
    server, port = rendezvous
    client = KVStoreClient("127.0.0.1", port, scope="heartbeat", timeout=1)
    client.set("w0", b"beat")
    assert server.live_keys("heartbeat") == ["w0"]
    time.sleep(0.4)
    assert server.live_keys("heartbeat") == []
    with pytest.raises(KeyError):
        client.get("w0", wait=False)


@pytest.mark.parametrize("ours_serves", [True, False])
def test_the_two_packages_meet_on_the_wire(ours_serves):
    """The port's client against the JAX server and the JAX client against
    the port's: set, long-poll get, keys with a TTL, finish."""
    server = (RendezvousServer if ours_serves else jrdv.RendezvousServer)(
        host="127.0.0.1", heartbeat_ttl=0.3)
    port = server.start()
    try:
        client = (jrdv.KVStoreClient if ours_serves else KVStoreClient)(
            "127.0.0.1", port, scope="x", timeout=10, long_poll=5.0)
        threading.Timer(0.2, client.set, args=("k", b"\x00v1")).start()
        assert client.get("k") == b"\x00v1"
        time.sleep(0.2)
        client.set("k2", b"v2")
        assert client.keys("x") == ["k", "k2"]
        assert client.keys("x", ttl=0.1) == ["k2"]
        client.set("beat", b"b", scope="heartbeat")
        assert server.live_keys("heartbeat") == ["beat"]
        client.finish("k")
        assert server.finished_keys("x") == {"k"}
        with pytest.raises(KeyError):
            client.get("k", wait=False)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# driver membership math and notices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("old,new", [
    ({"a": 2, "b": 2}, {"a": 2, "c": 4}), ({"a": 2}, {"a": 4}),
    ({}, {"x": 1}), ({"x": 1}, {})])
def test_diff_hosts_is_the_jax_packages(old, new):
    assert ElasticDriver.diff_hosts(old, new) == \
        JElasticDriver.diff_hosts(old, new)


def test_discovery_script_parsing(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho host1:4\necho '# comment'\n"
                      "echo host2\n")
    script.chmod(0o755)
    assert HostDiscoveryScript(str(script)).find_available_hosts() == \
        {"host1": 4, "host2": 1}


def test_host_change_publishes_notice(rendezvous):
    server, _ = rendezvous
    snapshots = iter([{"a": 1, "b": 1}, {"a": 1}])
    discovery = SimpleNamespace(find_available_hosts=lambda: next(snapshots))
    driver = ElasticDriver(server, discovery, heartbeat_ttl=60)
    driver._hosts = discovery.find_available_hosts()
    driver._poll_once()
    notice = json.loads(server.get("elastic.notice", "update").decode())
    assert "b" in notice["notice"] and notice["seq"] == 1


def test_heartbeat_loss_detected(rendezvous):
    server, port = rendezvous
    client = KVStoreClient("127.0.0.1", port, scope="heartbeat", timeout=1)
    driver = ElasticDriver(server, discovery=None, heartbeat_ttl=0.2)
    client.set("w0", b"beat")
    assert driver._check_heartbeats() == set()
    time.sleep(0.3)
    assert driver._check_heartbeats() == {"w0"}


def test_check_host_updates_baseline_then_raise(rendezvous, monkeypatch):
    server, port = rendezvous
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_HTTP_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_HTTP_PORT", str(port))
    monkeypatch.setattr(runner, "_last_notice", None)
    runner.check_host_updates()  # no notice yet
    server.put("elastic.notice", "update", b"n1")
    runner.check_host_updates()  # the first one seen: the baseline
    runner.check_host_updates()
    server.put("elastic.notice", "update", b"n2")
    with pytest.raises(exceptions.HostsUpdatedInterrupt, match="n2"):
        runner.check_host_updates()


def test_hosts_updated_reforms_at_world1_without_rollback(
        tmp_path, monkeypatch):
    """The chip phase's 12a on the CPU: the driver's discovery output
    changes after step 1 (each worker's baseline) and after step 3; the
    commit of step 3 raises HostsUpdatedInterrupt, ``run`` re-forms at
    world 1 (new groups, store and runtime at the assignment's
    coordinator), syncs and goes on; the losses equal an uninterrupted
    run's bit for bit."""
    hosts = tmp_path / "hosts"
    hosts.write_text("localhost:1\n")
    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    driver = ElasticDriver(
        server, HostDiscoveryScript(f"cat {hosts}"), discovery_interval=60)
    driver.start()
    for k, v in {"HOROVOD_RENDEZVOUS_HTTP_ADDR": "127.0.0.1",
                 "HOROVOD_RENDEZVOUS_HTTP_PORT": str(port),
                 "HOROVOD_ELASTIC": "1",
                 "HOROVOD_ELASTIC_SETTLE_SECONDS": "0.1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(runner, "_last_notice", None)
    monkeypatch.setattr(runner, "_generation", 0)
    from horovod_tpu_torch.utils import resilience

    monkeypatch.setattr(resilience, "_generation", 0)
    # the re-form rewrites these; set here, the test's end puts them back
    # as they were (a delenv of an unset name records nothing to restore)
    for k, v in (("HOROVOD_COORDINATOR_ADDR", ""), ("HOROVOD_RANK", "0"),
                 ("HOROVOD_SIZE", "1")):
        monkeypatch.setenv(k, v)

    def losses_of(reform):
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 1)
        x = torch.linspace(-1, 1, 32).reshape(8, 4)
        hvd.init(device="cpu")
        groups = [hvd.core.state.global_state().control_group]
        tx = hvd.sharded_adamw(1e-1)
        state = ArrayState(model, tx.init(dict(model.named_parameters())))
        out = []

        @hvd.elastic.run
        def train(state):
            while state.step < 6:
                model.zero_grad()
                loss = ((model(x) - 1.0) ** 2).mean()
                loss.backward()
                params = dict(model.named_parameters())
                _, state.optimizer = tx.apply(
                    params, state.optimizer,
                    {k: p.grad for k, p in params.items()})
                out.append(loss.item())
                state.step += 1
                if reform and state.step in (1, 3):
                    hosts.write_text("localhost:1\n" if state.step == 3
                                     else "localhost:1\nspare:1\n")
                    driver._poll_once()
                state.commit()

        train(state)
        groups.append(hvd.core.state.global_state().control_group)
        hvd.shutdown()
        return out, groups

    try:
        clean, _ = losses_of(False)
        got, groups = losses_of(True)
    finally:
        runner.stop_heartbeat()
        driver.stop()
        server.stop()
    assert runner.restarts() == 1
    assert got == clean and len(got) == 6
    assert groups[0] is not groups[1]
    reform = runner.last_reform()
    assert set(reform) >= {"shutdown", "rendezvous", "reinit", "sync"}
    assert os.environ["HOROVOD_COORDINATOR_ADDR"].startswith("127.0.0.1:")


# ---------------------------------------------------------------------------
# stall inspector: the elastic verdict
# ---------------------------------------------------------------------------

def _stalled_table(age: float):
    now = time.monotonic()
    return SimpleNamespace(
        pending=lambda: {"t": [SimpleNamespace(rank=0)]},
        first_request_time=lambda name: now - age)


def test_elastic_stall_raises_typed():
    inspector = StallInspector(warning_time_seconds=0.0,
                               shutdown_time_seconds=1.0, elastic=True)
    inspector._last_check = time.monotonic() - 1
    with pytest.raises(exceptions.WorkerStallError) as exc_info:
        inspector.check(_stalled_table(age=10.0), world=2)
    assert exc_info.value.ranks == (1,)


def test_non_elastic_stall_returns_true():
    inspector = StallInspector(warning_time_seconds=0.0,
                               shutdown_time_seconds=1.0, elastic=False)
    inspector._last_check = time.monotonic() - 1
    assert inspector.check(_stalled_table(age=10.0), world=2) is True


def test_collective_deadline_names_the_silent_ranks(monkeypatch):
    from horovod_tpu_torch.runtime import message as msg
    from horovod_tpu_torch.runtime.controller import LocalController

    monkeypatch.setenv("HOROVOD_COLLECTIVE_TIMEOUT", "0.5")
    ctl = LocalController(0, 3, 0, native_engine=False)
    req = msg.Request(1, "ALLREDUCE", "g", "float32", (4,))
    ctl.message_table.increment(req, 3)
    ctl._check_collective_deadline(time.monotonic() + 1.0)
    assert isinstance(ctl.failure, exceptions.WorkerStallError)
    assert ctl.failure.ranks == (0, 2) and ctl._should_shut_down


# ---------------------------------------------------------------------------
# metrics, config, reinit
# ---------------------------------------------------------------------------

def test_elastic_families_registered_and_commit_counted():
    names = set(hvd.metrics())
    for metric in ("horovod_elastic_commits_total",
                   "horovod_elastic_commit_duration_seconds",
                   "horovod_elastic_restarts_total",
                   "horovod_elastic_workers_removed_total",
                   "horovod_elastic_generation",
                   "horovod_elastic_faults_injected_total"):
        assert metric in names, metric

    def commits():
        values = hvd.metrics()["horovod_elastic_commits_total"]["values"]
        return values[0]["value"] if values else 0

    before = commits()
    ObjectState(x=1).commit()
    assert commits() == before + 1


def test_elastic_config_parsing(monkeypatch):
    from horovod_tpu.utils.env import Config as JConfig
    from horovod_tpu_torch.utils.env import Config

    monkeypatch.delenv("HOROVOD_ELASTIC", raising=False)
    assert Config.from_env().elastic is JConfig.from_env().elastic is False
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    assert Config.from_env().elastic is JConfig.from_env().elastic is True


def test_reinit_makes_new_groups_and_a_new_runtime(world1):
    from horovod_tpu_torch.core import state as state_mod

    assert torch.equal(hvd.allreduce(torch.ones(2), name="a", op=hvd.Sum),
                       torch.ones(2))
    st = state_mod.global_state()
    old = (st.control_group, st.data_group, st.runtime)
    hvd.reinit()
    st = state_mod.global_state()
    assert hvd.device().type == "cpu"
    assert hvd.allreduce(torch.ones(2), name="a", op=hvd.Sum).sum() == 2
    assert all(a is not b for a, b in zip(
        old, (st.control_group, st.data_group, st.runtime)))
