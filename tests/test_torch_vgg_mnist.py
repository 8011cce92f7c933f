"""The port's VGG and MNIST convnet (``horovod_tpu_torch/models/vgg.py``,
``mnist.py``) against the JAX package's flax models, on the CPU, in
float32.

Both run at 64 x 64, so that the last map before the first dense layer is
2 x 2 (VGG, after five pools) or 16 x 16 (MNIST): a flatten in another
order than flax's (H, W, C) would permute that layer's rows and show (at
32 x 32 VGG's map is 1 x 1 and would hide it). Flax initialises the
variables, ``vgg_from_flax``/``mnist_from_flax`` carry them across
(strict), and the same seeded numpy images and labels go through both.
VGG11 runs with ``batch_norm`` False and True, in train and eval mode;
MnistConvNet is the model of the JAX package's MNIST example.

Limits, relative to the norm of what they compare (both sides take the
same float32 math in other orders: XLA's and oneDNN's convolutions sum
their products differently): logits 1e-5, the loss 1e-5, each running
statistics leaf 1e-5, each gradient leaf 1e-3. Most leaves agree to a few
1e-6; the gradient limit leaves room for a ReLU whose input lies within
float32 rounding of 0 and falls on the other side in one of the two
programs (measured: 1.5e-4 on the first conv's kernel, eval mode with
batch norm, with flax's own initial weights; with random running
statistics one such flip moved later gradients 0.85 % from a float64 run,
which both JAX and the port's NCHW-contiguous float32 run matched to 1e-6,
so the statistics stay flax's initial ones). A conv's bias ahead of a
train-mode batch norm has a true gradient of 0 (the norm subtracts the
batch mean): both sides hold rounding noise there (measured at most
1.1e-6), so those leaves are held to 1e-5 absolute on both sides instead.

A 2-rank gloo world (``tests/torch_vgg_worker.py``) runs one
``DistributedOptimizer`` backward of a VGG11 at 32 x 32 with
``HOROVOD_FUSION_THRESHOLD`` one byte below ``fc1``'s gradient: that
gradient leaves as a response of its own, as VGG-16's 411 MB ``fc1`` does
under the 64 MiB default on the card, and its average is bit-equal to
the JAX package's allreduce of the two ranks' gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import mnist as jmnist
from horovod_tpu.models import vgg as jvgg
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models import vgg as tvgg
from horovod_tpu_torch.models.convert import (batch_stats_to_flax,
                                              mnist_from_flax,
                                              mnist_grads_to_flax,
                                              vgg_from_flax,
                                              vgg_grads_to_flax)

import torch_vgg_worker as worker

BATCH, CLASSES, SIZE = 2, 10, 64
TOL = {"logits": 1e-5, "loss": 1e-5, "stats": 1e-5, "grad": 1e-3}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    worst = max((_rel(got[k], want[k]), k) for k in want)
    assert worst[0] <= tol, f"{what}: {worst[1]} off by {worst[0]:.3e}"


def _data(channels: int):
    rng = np.random.RandomState(channels)
    images = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, channels)) \
        .astype(np.float32)
    labels = rng.randint(0, CLASSES, (BATCH,)).astype(np.int32)
    return images, labels


def _loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, labels).mean()


def _variables(jm, images):
    """Variables of the flax model's structure drawn with numpy (JAX's own
    initialisers take seconds at VGG's widths): He-scaled kernels, small
    biases, batch-norm scales and biases away from their initial values,
    and flax's initial running statistics (mean 0, var 1)."""
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                              train=False), images)
    rng = np.random.RandomState(7)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.normal(size=shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            a = rng.uniform(0.5, 1.5, size=shape)
        elif name in ("mean", "var"):
            a = np.full(shape, float(name == "var"))
        else:
            a = 0.1 * rng.normal(size=shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_run(jm, images, labels, train: bool):
    """Variables, the forward's logits and new statistics, the loss and
    the parameters' gradients (in ``train`` mode or not)."""
    variables = _variables(jm, images)
    stats = variables.get("batch_stats", {})

    def loss(params):
        v = {"params": params, **({"batch_stats": stats} if stats else {})}
        if train and stats:
            out, upd = jm.apply(v, images, train=True,
                                mutable=["batch_stats"])
            return _loss(out, labels), (out, upd["batch_stats"])
        out = jm.apply(v, images, train=train)
        return _loss(out, labels), (out, stats)

    (l, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    return dict(variables=variables, loss=float(l),
                logits=np.asarray(logits), stats=_np_tree(new_stats),
                grads=_np_tree(grads))


def _check_port(tm, run, images, labels, train, to_flax):
    # built on meta (no values drawn), filled from the tree: strict
    tm.load_state_dict(to_flax[0](run["variables"]), assign=True)
    tm.train(train)
    logits = tm(torch.from_numpy(images))
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long())
    loss.backward()
    assert _rel(logits.detach().numpy(), run["logits"]) <= TOL["logits"]
    assert abs(loss.item() - run["loss"]) <= TOL["loss"] * abs(run["loss"])
    grads = _flat(to_flax[1]({n: p.grad for n, p in tm.named_parameters()},
                             run["variables"]["params"]))
    want = _flat(run["grads"])
    if train and run["stats"]:  # the biases ahead of a train-mode norm
        for k in [k for k in want if k.startswith("conv")
                  and k.endswith("/bias")]:
            assert max(np.abs(grads.pop(k)).max(),
                       np.abs(want.pop(k)).max()) <= 1e-5, k
    _assert_trees_close(grads, want, TOL["grad"], "gradients")
    if run["stats"]:
        _assert_trees_close(batch_stats_to_flax(tm), run["stats"],
                            TOL["stats"], "batch_stats")


@pytest.mark.parametrize("batch_norm,train", [
    (False, True), (True, True), (True, False)],
    ids=["plain", "bn-train", "bn-eval"])
def test_vgg11_matches_jax(batch_norm, train):
    """Without batch norm, train and eval mode are one function: the plain
    case also holds the port's eval-mode logits bit-equal to its
    train-mode ones."""
    images, labels = _data(3)
    jm = jvgg.VGG11(num_classes=CLASSES, batch_norm=batch_norm,
                    dtype=jnp.float32)
    run = _jax_run(jm, images, labels, train)
    fc1 = run["variables"]["params"]["fc1"]["kernel"]
    assert fc1.shape == (2 * 2 * 512, 4096)  # a 2 x 2 x 512 map
    tm = tvgg.VGG11(num_classes=CLASSES, batch_norm=batch_norm,
                    dtype=torch.float32, image_size=SIZE, device="meta")
    _check_port(tm, run, images, labels, train,
                (vgg_from_flax, vgg_grads_to_flax))
    if not batch_norm:
        x = torch.from_numpy(images)
        with torch.no_grad():
            tm.eval()
            evaluated = tm(x)
            tm.train()
            assert torch.equal(evaluated, tm(x))


def test_mnist_convnet_matches_jax():
    images, labels = _data(1)
    run = _jax_run(jmnist.MnistConvNet(num_classes=CLASSES), images, labels,
                   True)
    assert run["variables"]["params"]["Dense_0"]["kernel"].shape == (
        16 * 16 * 64, 128)
    tm = tmnist.MnistConvNet(num_classes=CLASSES, image_size=SIZE,
                             device="meta")
    _check_port(tm, run, images, labels, True,
                (mnist_from_flax, mnist_grads_to_flax))


def test_flatten_is_flax_order():
    """The first dense layer reads an (N, C, H, W) map in (H, W, C) order:
    element (h, w, c) of the flattened row is x[n, c, h, w]."""
    x = torch.arange(2 * 3 * 2 * 4.0).reshape(2, 3, 2, 4) \
        .to(memory_format=torch.channels_last)
    flat = tvgg.flatten_hwc(x)
    want = x.permute(0, 2, 3, 1).contiguous().numpy().reshape(2, -1)
    np.testing.assert_array_equal(flat.numpy(), want)
    # the MNIST pool drops an odd row and column, as flax's VALID pool
    y = tmnist.avg_pool2(torch.ones(1, 1, 5, 7))
    assert y.shape == (1, 1, 2, 3) and bool((y == 1).all())


@pytest.mark.parametrize("name,params", [
    ("VGG11", 132_863_336), ("VGG13", 133_047_848), ("VGG16", 138_357_544),
    ("VGG19", 143_667_240)])
def test_vgg_parameter_counts_on_meta(name, params):
    """The partials at 224 x 224, 1000 classes, built on ``meta`` (no
    values drawn): VGG-16 has 138,357,544 parameters in 32 tensors, fc1
    102,764,544 of them (411 MB of float32 gradient), as the JAX model's
    ``eval_shape`` gives."""
    tm = getattr(tvgg, name)(device="meta")
    assert sum(p.numel() for p in tm.parameters()) == params
    jm = getattr(jvgg, name)()
    tree = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                          jnp.zeros((1, 224, 224, 3)))
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        tree)) == params
    if name == "VGG16":
        assert len(list(tm.parameters())) == 32
        assert tm.fc1.kernel.numel() + tm.fc1.bias.numel() == 102_764_544


def test_fc1_gradient_rides_alone_over_the_threshold(tmp_path):
    import horovod_tpu as jhvd

    got = worker.spawn(tmp_path)
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2], mesh_shape=(1, 2))
    try:
        parts = [jnp.asarray(out["local_fc1"]) for out in got]
        want = np.asarray(jhvd.allreduce(jhvd.stack_per_worker(parts),
                                         op=jhvd.Average))
    finally:
        jhvd.shutdown()
    nbytes = got[0]["local_fc1"].nbytes
    for out in got:
        assert int(out["threshold"]) == nbytes - 1
        bins = [str(b).split(",") for b in out["bins"]]
        assert ["fc1.kernel"] in bins, bins
        assert any(len(b) > 1 for b in bins)  # the small ones fused
        np.testing.assert_array_equal(out["avg_fc1"], want)
