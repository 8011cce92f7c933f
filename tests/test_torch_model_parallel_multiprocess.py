"""The port's model parallelism across the cards of one machine, one rank
a card (``tests/torch_model_parallel_worker.py``'s ``cards``, NCCL), at
full width, each case against every card's own unsharded run in the same
call:

* ring and Ulysses attention on GPT-2-small (12 x 768, 12 heads, vocab
  50257) over a sequence of 8192, 2048 a card, batch 2, 5 AdamW steps,
  the gradients averaged by ``allreduce_gradients`` after the backward;
* BERT-Large under Megatron TP 2 (``local``, ``HOROVOD_LOCAL_SIZE=2``) x
  DP 2 (``cross``), batch 8 x 512 a DP rank, 76 masked positions a
  sequence, 5 SGD steps;
* GPT-2-small's 12 layers as 4 stages of 3, 8 microbatches of 2 x 1024,
  5 AdamW steps over the layers.

Rank 0 prints each run's losses, its median step ms and its peak memory
beside the card's name and power limit. The losses' limits, relative to
the unsharded run's at every step (``LIMITS`` in the worker): 5e-3 for
ring, Ulysses and TP, whose bfloat16 partials (the ring's partial outputs,
TP's row-parallel products) are rounded once more than one pass rounds
them, and 1e-4 for the pipeline, whose layers run the same kernels on the
same microbatches and differ only in the order the gradients accumulate.
The world needs four cards; it skips with fewer. This file imports no JAX
(run it with ``--noconftest`` where JAX is absent):

    python -m pytest -q -s --noconftest -m gpu \\
        tests/test_torch_model_parallel_multiprocess.py

``rehearse`` instead of the card world runs the same code at toy widths on
4 gloo ranks (``torch_model_parallel_worker.start(tmp, 4, "rehearse",
env={"HOROVOD_LOCAL_SIZE": "2"})``).
"""

import pytest
import torch

import torch_model_parallel_worker as worker


@pytest.mark.gpu
def test_model_parallel_across_four_cards(tmp_path):
    size = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if size < 4:
        pytest.skip("needs four CUDA devices")
    worker.join(worker.start(tmp_path, 4, "cards",
                             env={"HOROVOD_LOCAL_SIZE": "2"}, device="cuda"),
                tmp_path, timeout=600)
