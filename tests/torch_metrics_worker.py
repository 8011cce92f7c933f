"""One rank of a 2-rank world that runs the same named allreduces through
the port's runtime (gloo) and then through the JAX package's (its socket
controller and host ring), for tests/test_torch_metrics.py.

    python tests/torch_metrics_worker.py <rank> <size> <tmpdir> <port>

Each side runs ``STEPS`` steps of one grouped allreduce of ``SIZES``
float32 tensors (one lock scope, a cycle started at once; with
``HOROVOD_CYCLE_TIME`` at 60 s no idle cycle runs, so both ranks' cycles
pair up step for step). Before the first and after the last step it takes
its registry's ``flatten_snapshot``; the two snapshots of each side go to
``rank<r>.json``.

Both sides run with ``HOROVOD_COMMS_DEGRADED_FRACTION=0``: the comms
planes' degraded-link detectors compare each collective's bus bandwidth
with the best seen so far, so on a loaded host a slow gloo call could move
``horovod_comms_degraded_total`` on one side and not the other. The
detector's crossings are held by the comms tests; here they would only
make the moved families depend on the host's load.
"""

import json
import os
import sys

import numpy as np

SIZES = (3, 40, 7, 300, 64, 1, 129, 500)
STEPS = 3


def _inputs(rank: int) -> list:
    rng = np.random.RandomState(rank)
    return [rng.standard_normal(n).astype(np.float32) for n in SIZES]


def _port(rank: int) -> dict:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.metrics import flatten_snapshot

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    before = flatten_snapshot(hvd.metrics())
    for _ in range(STEPS):
        hvd.grouped_allreduce([torch.from_numpy(x) for x in _inputs(rank)],
                              name="m")
    after = flatten_snapshot(hvd.metrics())
    hvd.shutdown()
    return {"before": before, "after": after}


def _jax(rank: int, port: int) -> dict:
    os.environ.update(HOROVOD_CONTROLLER="socket",
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                      JAX_PLATFORMS="cpu")
    os.environ.pop("HOROVOD_COORDINATOR_ADDR", None)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import horovod_tpu as hvd
    from horovod_tpu.metrics import flatten_snapshot

    hvd.init()
    before = flatten_snapshot(hvd.metrics())
    for _ in range(STEPS):
        hs = hvd.grouped_allreduce_async(
            _inputs(rank), [f"m.{i}" for i in range(len(SIZES))])
        for h in hs:
            hvd.synchronize(h)
    after = flatten_snapshot(hvd.metrics())
    hvd.shutdown()
    return {"before": before, "after": after}


def main() -> None:
    rank, size, tmpdir, port = sys.argv[1:5]
    os.environ.update(HOROVOD_RANK=rank, HOROVOD_SIZE=size,
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store",
                      HOROVOD_CYCLE_TIME="60000",
                      HOROVOD_FUSION_THRESHOLD="1024",
                      HOROVOD_COMMS_DEGRADED_FRACTION="0")
    out = {"port": _port(int(rank)), "jax": _jax(int(rank), int(port))}
    with open(os.path.join(tmpdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
