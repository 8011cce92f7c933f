"""The port's rank-0 checkpoint (mirrors tests/test_checkpoint.py): save and
broadcast restore round trips, keep, the ``.crc`` sidecar against the JAX
package's, damage named by leaf, a resumed training step bit-equal to the
uninterrupted one, and a 2-rank gloo world where only rank 0 holds the
file (tests/torch_ckpt_worker.py)."""

import collections
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import checkpoint as jcheckpoint
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.ckpt import tree as tree_mod
from horovod_tpu_torch.exceptions import CheckpointCorruptError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _nested():
    """One nested dict as numpy (JAX side) and as torch (port)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    bf = rng.standard_normal(5).astype(ml_dtypes.bfloat16)
    ints = np.arange(6, dtype=np.int32)
    jax_tree = {"params": {"dense": {"w": w, "b": bf}, "ids": ints},
                "opt": [np.float32(0.5), {"count": np.int64(3)}],
                "epoch": 7, "lr": 0.125}
    torch_tree = {"params": {"dense": {"w": torch.from_numpy(w),
                                       "b": torch.from_numpy(
                                           bf.view(np.int16)).view(
                                               torch.bfloat16)},
                             "ids": torch.from_numpy(ints)},
                  "opt": [np.float32(0.5), {"count": np.int64(3)}],
                  "epoch": 7, "lr": 0.125}
    return jax_tree, torch_tree


def test_flatten_order_and_paths_are_jax_tree_util():
    import jax

    class NT(collections.namedtuple("NT", "a b")):
        pass

    tree = {"z": 1, "a": [np.zeros(2), None, (3, 4)],
            "o": collections.OrderedDict([("y", 1), ("x", 2)]),
            "n": NT(5, 6), 10: 8, 2: 9}
    tree = {str(k): v for k, v in tree.items()}
    theirs = jax.tree_util.tree_flatten_with_path(tree)[0]
    ours, treedef = tree_mod.flatten_with_path(tree)
    assert [tree_mod.path_key(p) for p, _ in ours] == [
        "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in p)
        for p, _ in theirs]
    assert [str(leaf) for _, leaf in ours] == [str(x) for _, x in theirs]
    back = tree_mod.unflatten(treedef, [leaf for _, leaf in ours])
    assert back["a"][1] is None and isinstance(back["o"],
                                               collections.OrderedDict)
    assert list(back["o"]) == ["y", "x"] and back["n"] == NT(5, 6)


def test_sidecar_leaves_equal_the_jax_packages(world1, tmp_path):
    jax_tree, torch_tree = _nested()
    path = checkpoint.save(str(tmp_path / "c"), torch_tree, step=1)
    assert os.path.basename(path) == "ckpt_1.hvd"
    sidecar = json.loads(open(path + ".crc").read())
    assert sidecar["leaves"] == jcheckpoint._leaf_crcs(jax_tree)
    assert set(sidecar) == {"algorithm", "file_crc", "bytes", "leaves"}
    data = open(path, "rb").read()
    assert sidecar["bytes"] == len(data)
    assert sidecar["file_crc"] == checkpoint.ckpt_io.checksum(data)


def test_save_restore_roundtrip_in_the_targets_form(world1, tmp_path):
    _, torch_tree = _nested()
    d = str(tmp_path / "ckpts")
    path = checkpoint.save(d, torch_tree, step=3)
    target = {"params": {"dense": {"w": torch.zeros(4, 3),
                                   "b": torch.zeros(5, dtype=torch.bfloat16)},
                         "ids": torch.zeros(6, dtype=torch.int32)},
              "opt": [np.float32(0), {"count": np.int64(0)}],
              "epoch": 0, "lr": 0.0}
    got = checkpoint.restore(path, target)
    for p, leaf in tree_mod.flatten_with_path(torch_tree)[0]:
        mine = got
        for k in p:
            mine = mine[int(k)] if isinstance(mine, list) else mine[k]
        if isinstance(leaf, torch.Tensor):
            assert mine.dtype == leaf.dtype and torch.equal(mine, leaf), p
        else:
            assert type(mine) is type(leaf) and mine == leaf, p
    assert torch.equal(target["params"]["ids"], torch.zeros(6,
                                                            dtype=torch.int32))


def test_restore_latest_and_keep(world1, tmp_path):
    d = str(tmp_path / "ckpts")
    tree = {"w": torch.arange(4.0)}
    for s in (1, 5, 9):
        checkpoint.save(d, {"w": tree["w"] * s}, step=s, keep=2)
    assert checkpoint.all_steps(d) == [5, 9]
    assert sorted(os.listdir(d)) == ["ckpt_5.hvd", "ckpt_5.hvd.crc",
                                     "ckpt_9.hvd", "ckpt_9.hvd.crc"]
    restored, step = checkpoint.restore_latest(d, tree)
    assert step == 9 and checkpoint.latest_step(d) == 9
    assert torch.equal(restored["w"], torch.arange(4.0) * 9)
    restored, step = checkpoint.restore_latest(str(tmp_path / "nope"), tree)
    assert step is None and restored is tree


def _save_integrity(tmp_path):
    d = str(tmp_path / "ckpts")
    tree = {"params": {"w": torch.arange(64, dtype=torch.float32),
                       "b": torch.ones(8)}}
    path = checkpoint.save(d, tree, step=1)
    return path, tree


def test_truncated_file_raises(world1, tmp_path):
    path, tree = _save_integrity(tmp_path)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:-10])
    with pytest.raises(CheckpointCorruptError) as ei:
        checkpoint.restore(path, tree, broadcast=False)
    assert "truncated or torn" in str(ei.value)


@pytest.mark.parametrize("leaf", ["params/w", "params/b"])
def test_bitflip_names_offending_leaf(world1, tmp_path, leaf):
    path, tree = _save_integrity(tmp_path)
    blob = bytearray(open(path, "rb").read())
    name = leaf.split("/")[1]
    off = bytes(blob).index(tree["params"][name].numpy().tobytes()) + 5
    blob[off] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(CheckpointCorruptError) as ei:
        checkpoint.restore(path, tree, broadcast=False)
    assert ei.value.leaf == leaf and leaf in str(ei.value)
    # verify=False opts out: the damage that decodes flows through, so the
    # sidecar and the container's own digests are what raised above
    got = checkpoint.restore(path, tree, broadcast=False, verify=False)
    assert got["params"][name].shape == tree["params"][name].shape
    assert not torch.equal(got["params"][name], tree["params"][name])


def test_full_train_resume(world1, tmp_path):
    """Train, checkpoint model and optimizer, perturb, resume: the next
    step from the restored state is the uninterrupted one, bit for bit."""
    torch.manual_seed(0)

    def build(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(6, 8),
                                    torch.nn.BatchNorm1d(8),
                                    torch.nn.ReLU(), torch.nn.Linear(8, 3))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        return model, opt

    x = torch.randn(16, 6)
    y = torch.randint(0, 3, (16,))

    def step(model, opt):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    model, opt = build(0)
    step(model, opt)
    d = str(tmp_path / "ckpts")
    checkpoint.save(d, {"model": model.state_dict(),
                        "opt": opt.state_dict()}, step=1)
    want = step(model, opt)
    model2, opt2 = build(1)
    step(model2, opt2)  # a momentum buffer for every parameter
    got, s = checkpoint.restore_latest(d, {"model": model2.state_dict(),
                                           "opt": opt2.state_dict()})
    assert s == 1
    model2.load_state_dict(got["model"])
    opt2.load_state_dict(got["opt"])
    assert torch.equal(step(model2, opt2), want)
    for a, b in zip(model.state_dict().values(),
                    model2.state_dict().values()):
        assert torch.equal(a, b)


def test_restore_latest_in_a_two_rank_world_where_only_rank0_has_the_file(
        tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_ckpt_worker.py"),
         "restore0", str(r), "2", str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_DONE {r}" in out, out[-3000:]
    assert os.listdir(tmp_path / "r0") and not os.path.exists(tmp_path / "r1")
