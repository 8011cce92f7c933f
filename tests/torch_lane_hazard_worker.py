"""One rank of a 2-rank gloo world for tests/test_torch_lane_hazard.py (the
port's side of ``tests/mp_worker.py``'s ``lane_hazard`` scenario).

    python tests/torch_lane_hazard_worker.py [cuda]

Three phases, each opened by a ``PHASE <name>`` line on stderr, where the
runtime's log goes too:

* ``hazard``: rank 0 holds ``hazard/x`` in flight for 2.5 s while its
  caller is silent (standing in for its own NCCL program); rank 1
  announces the tensor only after that. The watchdog must name it.
* ``wait``: rank 0 parks in ``wait()`` on ``quiet/wait`` while rank 1 is
  1.2 s late (a stalled peer: the stall inspector's case, not a hazard).
* ``poll``: rank 0 spins on ``poll()`` for ``quiet/poll`` while rank 1 is
  1.2 s late.
* ``stall``: rank 1 stalls for 2 s before it announces ``quiet/stall``,
  while rank 0 waits on it: the stall inspector names the missing rank,
  and the watchdog stays quiet.

With ``cuda`` each rank takes ``cuda:<rank>`` and the data group is NCCL.
"""

import os
import sys
import time

import torch

HOLD = 2.5   # seconds rank 0's op waits for rank 1's announcement
LATE = 1.2   # > 2 stall periods: an unsuppressed watchdog would speak
STALL = 2.0  # > 3 stall periods: the stall inspector speaks


def _phase(name: str) -> None:
    print(f"PHASE {name}", file=sys.stderr, flush=True)


def main() -> None:
    import horovod_tpu_torch as hvd

    cuda = sys.argv[1:] == ["cuda"]
    torch.set_num_threads(1)
    hvd.init(device=None if cuda else "cpu")
    rank = hvd.rank()
    dev = hvd.device() if cuda else torch.device("cpu")
    ones = torch.ones(4, device=dev)
    hvd.allreduce(torch.ones(2, device=dev), name="hazard/warm")

    _phase("hazard")
    if rank == 0:
        h = hvd.allreduce_async(ones, name="hazard/x")
        time.sleep(HOLD)
    else:
        time.sleep(HOLD)
        h = hvd.allreduce_async(ones, name="hazard/x")
    assert float(hvd.synchronize(h).sum()) == 4.0

    _phase("wait")
    if rank == 1:
        time.sleep(LATE)
    hvd.synchronize(hvd.allreduce_async(ones, name="quiet/wait"))

    _phase("poll")
    if rank == 1:
        time.sleep(LATE)
    h = hvd.allreduce_async(ones, name="quiet/poll")
    while not hvd.poll(h):
        time.sleep(0.02)
    hvd.synchronize(h)

    _phase("stall")
    if rank == 1:
        time.sleep(STALL)
    hvd.synchronize(hvd.allreduce_async(ones, name="quiet/stall"))

    _phase("end")
    hvd.shutdown()
    print(f"OK rank={rank}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
