"""The port's examples (``horovod_tpu_torch/examples/``) on 2 gloo ranks on
the CPU (``--device cpu``), at tiny sizes: each rank exits 0 and prints
what the JAX package's example prints. ``bert_large_sparse`` prints
"lockstep OK" on every rank, as ``tests/test_tpurun_integration.py`` asks
of the JAX one; ``synthetic_benchmark`` runs with and without
``--fp16-allreduce``."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "bert_large_sparse": (["--layers", "2", "--seq", "32", "--batch", "4",
                           "--steps", "2"], "lockstep OK"),
    "synthetic_benchmark": (["--batch-size", "8", "--image-size", "32"],
                            "Img/sec total:"),
    "synthetic_benchmark_fp16": (["--batch-size", "8", "--image-size", "32",
                                  "--fp16-allreduce"], "Img/sec total:"),
    "mnist": (["--epochs", "1"], "epoch 0: loss"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_example_runs_on_two_gloo_ranks(case, tmp_path):
    args, marker = CASES[case]
    module = "horovod_tpu_torch.examples." + case.replace("_fp16", "")
    procs = []
    for rank in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_COORDINATOR_ADDR=f"file://{tmp_path}/store",
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--device", "cpu", *args],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        if case == "bert_large_sparse" or rank == 0:
            assert marker in out, out[-3000:]
    if case == "bert_large_sparse":
        assert "step 1: loss" in outs[0]
    if case.startswith("synthetic"):
        assert "Batch size: 8, workers: 2" in outs[0]
