"""The observability planes hooked into the port's runtime, ZeRO,
checkpoint, integrity and elastic layers (the JAX package's hook sites).

* A spawned 2-rank gloo world trains a tiny transformer 3 steps on ZeRO-1
  (``tests/torch_observability_worker.py``): the first step's flight events
  are the reference's, in order (ZeRO's phase dispatch, the coordinator's
  negotiation, the executor's dispatch and completion, the phase's
  completion, the profiler's step); the memory ledger's
  ``optimizer_shards`` is the master and moments of the layout the JAX
  package's ``build_spec`` gives, to the byte; the comms ledger's ``zero``
  lane holds each phase's padded payload; the goodput ledger counts the
  profiled steps; and the ranks' dumps read alike in both packages.
* At world 1: a driver's host notice re-forms the world and leaves one
  ``elastic_reform`` incident whose seconds cover ``runner.
  last_reform()``'s; a NaN convicted by the digests rolls back in place and
  leaves one ``rollback`` incident and a failure dump naming the
  ``NumericalError``; a checkpoint commit is ``ckpt_stall`` badput and a
  ``ckpt_commit`` event.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
import torch_observability_worker
from horovod_tpu import flight_recorder as jfr
from horovod_tpu.parallel import zero as jzero
from horovod_tpu_torch import flight_recorder as tfr
from horovod_tpu_torch import goodput
from horovod_tpu_torch.utils import env as tenv


def _subsequence(events, pattern):
    """True when ``pattern`` (dicts of required fields) matches events in
    order, not necessarily adjacent."""
    it = iter(events)
    return all(any(all(e.get(k) == v for k, v in want.items()) for e in it)
               for want in pattern)


def test_zero1_step_in_a_two_rank_world(tmp_path):
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_observability_worker.run,
                         args=(r, 2, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    steps = got[0]["steps"]

    # the layout of the JAX package's ZeRO on the same leaves
    leaves = [np.zeros(s, np.float32) for s in got[0]["shapes"]]
    for rank, out in enumerate(got):
        spec = jzero.build_spec(leaves, 2, rank,
                                tenv.DEFAULT_FUSION_BUCKET_QUANTUM_BYTES)
        (g,) = spec.groups
        # master, mu and nu: float32, one shard each
        assert out["optimizer_shards"]["bytes"] == 3 * 4 * g.shard_elems
        zero_keys = {k["op"]: k for k in out["comms_keys"]
                     if k["lane"] == "zero"}
        for op in ("reducescatter", "allgather"):
            assert zero_keys[op]["ops"] == steps, zero_keys
            assert zero_keys[op]["window_bytes"] == steps * 4 * g.padded
        dev = {k["op"]: k for k in out["comms_keys"]
               if k["lane"] == "device"}
        assert dev["reducescatter"]["window_bytes"] == steps * 4 * g.padded
        gp = out["goodput"]
        assert gp["steps_productive"] == steps and gp["steps_replayed"] == 0
        assert gp["productive_seconds"] > 0

        events = out["first_step_events"]
        pattern = [
            {"kind": "op_dispatch", "op": "reducescatter",
             "phase": "sharded_grads", "bytes": 4 * g.padded},
            {"kind": "op_dispatch", "op": "REDUCESCATTER"},
            {"kind": "op_complete", "op": "REDUCESCATTER"},
            {"kind": "op_complete", "op": "reducescatter",
             "phase": "sharded_grads"},
            {"kind": "op_dispatch", "op": "allgather",
             "phase": "sharded_params", "bytes": 4 * g.padded},
            {"kind": "op_dispatch", "op": "ALLGATHER"},
            {"kind": "op_complete", "op": "ALLGATHER"},
            {"kind": "op_complete", "op": "allgather",
             "phase": "sharded_params"},
            {"kind": "profiler_step"},
        ]
        assert _subsequence(events, pattern), events
        kinds = [e["kind"] for e in events]
        if rank == 0:  # the coordinator negotiates
            assert _subsequence(events, [
                {"kind": "op_dispatch", "phase": "sharded_grads"},
                {"kind": "negotiate_begin",
                 "name": "sharded.adamw.grads.g0"},
                {"kind": "rank_request"},
                {"kind": "negotiate_end", "name": "sharded.adamw.grads.g0"},
                {"kind": "op_dispatch", "op": "REDUCESCATTER"}]), events
        else:
            assert "negotiate_begin" not in kinds

    dumps = tfr.load_dumps(str(tmp_path / "flight"))
    assert [d["launch_rank"] for d in dumps] == [0, 1]
    for d in dumps:
        assert {"runtime", "memory", "comms", "goodput",
                "profiler"} <= set(d["state"])
    assert jfr.load_dumps(str(tmp_path / "flight")) == dumps
    assert tfr.format_postmortem(dumps) == jfr.format_postmortem(dumps)


# ---------------------------------------------------------------------------
# world 1: re-form, rollback, checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_goodput():
    t = goodput.tracker()
    t.reset()
    yield t
    t.reset()


@pytest.fixture
def flight(monkeypatch, tmp_path):
    d = tmp_path / "flight"
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER_DIR", str(d))
    monkeypatch.setattr(tfr._recorder, "_last_failure_dump", 0.0)
    monkeypatch.setattr(tfr._recorder, "_dump_history", [])
    yield d
    monkeypatch.delenv("HOROVOD_FLIGHT_RECORDER_DIR")
    tfr.configure()


def test_reform_at_world1_is_one_elastic_reform_incident(
        tmp_path, monkeypatch, fresh_goodput, flight):
    from horovod_tpu_torch.elastic import runner
    from horovod_tpu_torch.elastic.driver import (ElasticDriver,
                                                  HostDiscoveryScript)
    from horovod_tpu_torch.run.rendezvous import RendezvousServer
    from horovod_tpu_torch.utils import resilience

    hosts = tmp_path / "hosts"
    hosts.write_text("localhost:1\n")
    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    driver = ElasticDriver(server, HostDiscoveryScript(f"cat {hosts}"),
                           discovery_interval=60)
    driver.start()
    for k, v in {"HOROVOD_RENDEZVOUS_HTTP_ADDR": "127.0.0.1",
                 "HOROVOD_RENDEZVOUS_HTTP_PORT": str(port),
                 "HOROVOD_ELASTIC": "1",
                 "HOROVOD_ELASTIC_SETTLE_SECONDS": "0.1",
                 "HOROVOD_COORDINATOR_ADDR": "", "HOROVOD_RANK": "0",
                 "HOROVOD_SIZE": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(runner, "_last_notice", None)
    monkeypatch.setattr(runner, "_generation", 0)
    monkeypatch.setattr(resilience, "_generation", 0)
    try:
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 1)
        x = torch.linspace(-1, 1, 32).reshape(8, 4)
        hvd.init(device="cpu")
        tx = hvd.sharded_adamw(1e-1)
        state = hvd.elastic.ArrayState(
            model, tx.init(dict(model.named_parameters())))

        @hvd.elastic.run
        def train(state):
            while state.step < 4:
                model.zero_grad()
                ((model(x) - 1.0) ** 2).mean().backward()
                params = dict(model.named_parameters())
                _, state.optimizer = tx.apply(
                    params, state.optimizer,
                    {k: p.grad for k, p in params.items()})
                state.step += 1
                if state.step in (1, 3):
                    hosts.write_text("localhost:1\n" if state.step == 3
                                     else "localhost:1\nspare:1\n")
                    driver._poll_once()
                state.commit()

        train(state)
        ring = tfr.recorder().events()
        hvd.shutdown()
    finally:
        runner.stop_heartbeat()
        driver.stop()
        server.stop()
    incs = [i for i in fresh_goodput.incidents()
            if i["cause"] == "elastic_reform"]
    assert len(incs) == 1, fresh_goodput.incidents()
    parts = runner.last_reform()
    total = sum(v for k, v in parts.items() if k != "generation")
    assert incs[0]["duration_s"] == pytest.approx(total, rel=0.05,
                                                  abs=0.02)
    assert incs[0]["generation"] == 1 and incs[0]["steps_replayed"] == 0
    kinds = [e["kind"] for e in ring]
    for kind in ("hosts_updated", "elastic_reform", "goodput_incident",
                 "state_commit", "elastic_notice"):
        assert kind in kinds, kind
    led = fresh_goodput.ledger()
    assert led["steps_productive"] >= 3  # the commits' step source


def test_nan_rollback_is_one_rollback_incident_and_a_dump(
        tmp_path, monkeypatch, fresh_goodput, flight):
    from horovod_tpu_torch.integrity import digest, inject, rollback

    monkeypatch.setenv("HOROVOD_INTEGRITY", "1")
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "nan:0:after=3")
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    for mod in (digest, inject, rollback):
        mod.reset()
    t_start = time.time()  # the ring also holds earlier tests' events
    hvd.init(device="cpu")
    try:
        params = {"a": torch.linspace(-1, 1, 15).reshape(5, 3),
                  "b": torch.linspace(0, 2, 7)}
        tx = hvd.sharded_adamw(1e-2)
        state = hvd.elastic.ArrayState(params, tx.init(params), step=0,
                                       ckpt_dir=str(tmp_path / "ck"))

        @hvd.elastic.run
        def train(state):
            while state.step < 6:
                grads = {k: torch.sin(v * (state.step + 1))
                         for k, v in state.params.items()}
                _, state.optimizer = tx.apply(state.params, state.optimizer,
                                              grads)
                state.step += 1
                state.commit()

        train(state)
        state.checkpoint_wait()
    finally:
        hvd.shutdown()
        for mod in (digest, inject, rollback):
            mod.reset()
    incs = [i for i in fresh_goodput.incidents() if i["cause"] == "rollback"]
    assert len(incs) == 1 and incs[0]["linked_events"] == [
        "rollback", "integrity_violation"]
    assert fresh_goodput.ledger()["badput_seconds"].get("ckpt_stall", 0) > 0
    doc = tfr.load_dumps(str(flight))[0]
    reasons = [h["reason"] for h in doc["dump_history"]] + [doc["reason"]]
    assert "integrity_violation" in reasons
    history = [e for e in json.load(open(flight / "flight-rank-0.json"))[
        "events"] if e["t"] >= t_start]
    rb = [e for e in history if e["kind"] == "rollback"]
    assert len(rb) == 1 and rb[0]["error"].startswith("NumericalError")
    kinds = [e["kind"] for e in history]
    for kind in ("integrity_violation", "ckpt_commit", "fault_inject",
                 "ckpt_state_loaded"):
        assert kind in kinds, kind
