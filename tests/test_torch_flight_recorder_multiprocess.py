"""The flight recorder across real worker processes (mirrors
tests/test_flight_recorder_multiprocess.py): in a 3-rank gloo world whose
pytest process hosts the port's rendezvous store, rank 1 is killed by
``HOROVOD_FAULT_INJECT`` at step 3. Its dump, written before the exit,
records the kill; the survivors' dumps record the loss and the re-form;
and ``suspect_culprit`` of both packages names rank 1, as does each
package's ``format_postmortem``. The workers are
tests/torch_elastic_worker.py's ``dp`` mode."""

import json

from horovod_tpu import flight_recorder as jfr
from horovod_tpu_torch import flight_recorder as tfr
from test_torch_elastic_multiprocess import _survivors_finished, _world


def test_killed_rank_leaves_a_dump_and_the_postmortem_names_it(tmp_path):
    flight = tmp_path / "flight"
    rcs, outs = _world("dp", tmp_path, env={
        "HOROVOD_FAULT_INJECT": "kill:rank=1:step=3:code=17",
        "HOROVOD_FLIGHT_RECORDER_DIR": str(flight),
        "DP_ONES": "1"})
    assert rcs[1] == 17, outs[1][-3000:]
    _survivors_finished(rcs, outs)

    victim = json.load(open(flight / "flight-rank-1.json"))
    assert victim["reason"] == "fault_inject_kill"
    kills = [e for e in victim["events"]
             if e["kind"] == "fault_inject" and e["action"] == "kill"]
    assert kills and kills[-1]["rank"] == 1 and kills[-1]["step"] == 3

    events, reasons = [], []
    for r in (0, 2):
        doc = json.load(open(flight / f"flight-rank-{r}.json"))
        assert doc["reason"] == "shutdown"  # the clean exit's dump
        events += doc["events"]
        reasons += [h["reason"] for h in doc["dump_history"]]
        for plane in ("memory", "comms", "goodput"):
            assert plane in doc["state"], plane
        incs = doc["state"]["goodput"]["incidents"]
        assert [i["cause"] for i in incs] == ["elastic_reform"]
        assert incs[0]["culprit_rank"] == 1
    kinds = {e["kind"] for e in events}
    assert {"workers_down", "elastic_reform", "state_commit"} <= kinds
    assert {"cycle_abort", "worker_lost"} & set(reasons), reasons

    dumps = tfr.load_dumps(str(flight))
    assert [d["launch_rank"] for d in dumps] == [0, 1, 2]
    assert tfr.suspect_culprit(dumps) == jfr.suspect_culprit(dumps)
    assert tfr.suspect_culprit(dumps)[0] == 1
    text = tfr.format_postmortem(dumps)
    assert text == jfr.format_postmortem(jfr.load_dumps(str(flight)))
    assert "suspected culprit: rank 1 (recorded its own injected kill)" \
        in text
    assert "=== goodput report (3 ranks) ===" in text
