"""The port's chaos matrix (mirrors tests/test_chaos_multiprocess.py and
tests/test_chaos_hierarchy.py, which drive the JAX package's
tools/chaos_matrix.py).

The harness's parts: its cells are the JAX matrix's (read from that file's
text, not imported), its verifiers pass and fail on canned worker results
and dumps, and its dump collection takes the store's copy over the file.
A cell takes a card a rank unless the CPU is asked for; without cards it
is refused before a rank starts. The cells run here through
``run_scenario(..., device="cpu")``, as gloo worlds: the one that takes
under ~10 s serially (``serve_kill_replica``, 7-9 s on an 8-core host) in
tier-1, the others (9-29 s each) marked slow, as the JAX package marks its own chaos
tests (tests/test_chaos_multiprocess.py:13-30).

On four cards (``gpu``): ``kv_outage_reform`` with one process a card and
an NCCL data group.
"""

import ast
import json
import os

import pytest
import torch

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.run.rendezvous import RendezvousServer
from horovod_tpu_torch.tools import chaos_matrix as cm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = ("serve_kill_replica",)


def _jax_scenarios() -> dict:
    """``SCENARIOS`` of tools/chaos_matrix.py, from its source (the
    ``CHAOS_CKPT_PHASE`` read in it evaluates to its default)."""
    tree = ast.parse(open(os.path.join(REPO, "tools",
                                       "chaos_matrix.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "SCENARIOS" for t in node.targets):
            return eval(compile(ast.Expression(node.value), "<scenarios>",
                                "eval"), {"os": os})
    raise AssertionError("tools/chaos_matrix.py has no SCENARIOS")


def test_cells_are_the_jax_matrixs():
    theirs = _jax_scenarios()
    assert list(cm.SCENARIOS) == list(theirs)
    for name, spec in cm.SCENARIOS.items():
        j = theirs[name]
        assert spec["world"] == j["world"], name
        assert spec.get("expected_exit", {}) == j.get("expected_exit", {})
        assert spec.get("require_culprit") == j.get("require_culprit")
        assert spec.get("hung_ranks") == j.get("hung_ranks")
        assert tuple(spec.get("require_true", ())) == \
            tuple(j.get("require_true", ())), name
        # the same faults; only the flaky cell's expectation differs (a
        # reset gloo verb re-forms on the port, where the socket retried)
        assert spec["env"].get("HOROVOD_FAULT_INJECT") == \
            j["env"].get("HOROVOD_FAULT_INJECT"), name
        if name != "flaky_negotiate":
            for key in ("require_retries", "require_reform",
                        "require_injections", "require_goodput",
                        "require_comms_state", "ckpt_verify"):
                assert spec.get(key) == j.get(key), (name, key)
    flaky = cm.SCENARIOS["flaky_negotiate"]
    assert flaky["require_reform"] and not flaky.get("require_retries")


def _result(rank, **kw):
    r = dict(rank=rank, step=8, w=8.0, generation=1, net_retries_total=2.0,
             chaos_injected_total=3.0, hier_enabled=True, hier_groups=2,
             goodput_accounted=0.95, goodput_replayed=1,
             goodput_badput={"rollback": 0.1, "elastic_reform": 1.0})
    r.update(kw)
    return r


def test_check_results_passes_a_clean_run_and_names_each_broken_invariant():
    spec = dict(cm.SCENARIOS["kv_outage_reform"], require_goodput=True)
    results = {0: _result(0), 2: _result(2)}
    assert cm.check_results(spec, results, [0, 17, 0], ["", "", ""], 8) == []
    bad = {0: _result(0, step=7, w=7.0, net_retries_total=0.0,
                      generation=0, goodput_accounted=0.5),
           2: _result(2, net_retries_total=0.0, generation=0)}
    failures = cm.check_results(spec, bad, [0, 0, 3], ["", "", "boom"], 8)
    text = "\n".join(failures)
    for want in ("rank 1: unexpected exit 0 (wanted 17)",
                 "rank 2: unexpected exit 3", "lost steps on rank 0",
                 "expected nonzero horovod_net_retries_total",
                 "expected an elastic re-form",
                 "goodput ledger accounts 0.5"):
        assert want in text, (want, failures)
    hier = cm.SCENARIOS["hier_cross_kill"]
    out = cm.check_results(hier, {i: _result(i, hier_groups=3)
                                  for i in range(4)},
                           [0, 0, 0, 0, 17, 19], [""] * 6, 8)
    assert any("run 2 groups, got 3" in f for f in out), out
    hung = cm.SCENARIOS["partition_collective_timeout"]
    out = cm.check_results(hung, {0: _result(0), 1: _result(1),
                                  2: _result(2)}, [0, -9, 0], [""] * 3, 8)
    assert any("rank 1 was expected to hang" in f for f in out), out


def _dump(rank, events, comms_bytes=10):
    return {"schema": flight_recorder.SCHEMA, "rank": rank,
            "launch_rank": rank, "reason": "shutdown", "wall_time": 1.0,
            "events": events, "dump_history": [],
            "state": {"comms": {"lanes": {"device": {
                "bytes_total": comms_bytes}}}}}


def test_check_dumps_reads_the_comms_ledger_and_the_culprit():
    spec = {"world": 2, "require_comms_state": True}
    failures = []
    cm.check_dumps(spec, [_dump(0, []), _dump(1, [])], failures)
    assert failures == []
    failures = []
    cm.check_dumps(spec, [_dump(0, [], 0), _dump(1, [], 0)], failures)
    assert failures == ["comms ledgers recorded no device-lane traffic"]
    failures = []
    cm.check_dumps(spec, [_dump(0, [])], failures)
    assert failures == ["only 1/2 dumps embedded the comms state provider"]
    failures = []
    kill = [{"kind": "fault_inject", "action": "kill", "rank": 2, "step": 5,
             "t": 1.0, "seq": 1}]
    text = cm.check_dumps({"world": 3, "require_culprit": 2},
                          [_dump(0, []), _dump(2, kill)], failures)
    assert failures == [], failures
    assert "suspected culprit: rank 2" in text
    cm.check_dumps({"world": 3, "require_culprit": 1},
                   [_dump(0, []), _dump(2, kill)], failures)
    assert failures and "does not name rank 1" in failures[0]


def test_collect_dumps_prefers_the_shipped_copy(tmp_path):
    (tmp_path / "flight-rank-0.json").write_text(json.dumps(
        _dump(0, [{"kind": "from_file", "t": 1.0, "seq": 1}])))
    (tmp_path / "flight-rank-1.json").write_text(json.dumps(_dump(1, [])))
    server = RendezvousServer(host="127.0.0.1")
    server.start()
    try:
        server.put(flight_recorder.RENDEZVOUS_SCOPE, "rank.0", json.dumps(
            _dump(0, [{"kind": "shipped", "t": 2.0, "seq": 2}])).encode())
        server.put(flight_recorder.RENDEZVOUS_SCOPE, "rank.2", b"not json")
        dumps = cm.collect_dumps(str(tmp_path), server)
    finally:
        server.stop()
    by_rank = {d["launch_rank"]: d for d in dumps}
    assert sorted(by_rank) == [0, 1]
    assert by_rank[0]["events"][0]["kind"] == "shipped"


def test_ckpt_verifiers_report_a_missing_or_short_directory(tmp_path):
    failures = []
    cm.verify_ckpt_manifest(str(tmp_path), 8, failures)
    assert failures == ["newest manifest is None, want 8 (steps: [])"]
    failures = []
    cm.verify_ckpt_midcommit(str(tmp_path), 8, failures)
    assert failures == ["newest manifest is None, want 8 (steps: [])"]


def test_unknown_cell_is_an_error(capsys):
    assert cm.main(["--only", "no_such_cell"]) == 1
    assert "unknown scenario" in capsys.readouterr().out


def test_cells_take_the_cards_unless_the_cpu_is_asked_for(capsys,
                                                          monkeypatch):
    """The matrix and its workers default to the card: without one a cell
    is refused before any rank starts, and ``--device cpu`` is the
    explicit opt-in to gloo worlds."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cm.run_scenario("netdelay_negotiate",
                        cm.SCENARIOS["netdelay_negotiate"])
    assert cm.main(["--only", "serve_kill_replica"]) == 1
    assert "needs 1 CUDA device(s)" in capsys.readouterr().out
    from horovod_tpu_torch.tools import chaos_worker, serve_chaos_worker

    monkeypatch.delenv("CHAOS_DEVICE", raising=False)
    monkeypatch.setenv("HOROVOD_RANK", "0")
    with pytest.raises(RuntimeError, match="CHAOS_DEVICE=cpu"):
        chaos_worker.init_world()
    models = []
    monkeypatch.setattr(serve_chaos_worker, "run_replica",
                        lambda rank, addr, port, kind: models.append(kind))
    monkeypatch.setenv("HOROVOD_RANK", "1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_HTTP_PORT", "1")
    serve_chaos_worker.main([])
    monkeypatch.setenv("CHAOS_DEVICE", "cpu")
    serve_chaos_worker.main([])
    assert models == ["gpt2-small", "tiny"]


def _run(name, extra_env=None, device="cpu"):
    result = cm.run_scenario(name, cm.SCENARIOS[name], extra_env=extra_env,
                             device=device)
    assert result["ok"], json.dumps(
        {k: result[k] for k in ("failures", "exit_codes", "results",
                                "postmortem_tail")}, indent=1)[:6000]
    return result


@pytest.mark.parametrize("name", FAST)
def test_fast_cells(name):
    result = _run(name)
    if name == "serve_kill_replica":
        front = result["results"][0]
        assert front["zero_lost"] and front["requeued"] > 0
        assert front["dead_ranks"] == [2]
        assert "suspected culprit: rank 2" in "\n".join(
            result["postmortem_tail"])


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in cm.SCENARIOS if n not in FAST])
def test_slow_cells(name):
    _run(name)


@pytest.mark.gpu
def test_kv_outage_reform_on_the_cards():
    """Rank 1 killed at step 3 under a 5 s store outage from the first
    re-form registration; one process a card, an NCCL data group: the
    survivors re-form through the outage and finish with ``w == step``."""
    if torch.cuda.device_count() < 3:
        pytest.skip("needs three CUDA devices")
    result = _run("kv_outage_reform", device="cuda")
    survivors = [r for r in result["results"] if r]
    assert len(survivors) == 2
    assert all(r["w"] == 8.0 and r["generation"] >= 1 for r in survivors)
