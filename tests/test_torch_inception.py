"""The port's Inception-V3 (``horovod_tpu_torch/models/inception.py``)
against the JAX package's flax model, on the CPU, in float32.

Flax initialises the variables; ``inception_from_flax`` carries them to
the port; the same numpy images (2 x 128 x 128 x 3, 10 classes) and labels
go through both. The JAX model's fused BN + ReLU runs jnp on the CPU (the
Pallas kernel is gated to the TPU); the port's takes the plain version of
kernel B10 for CPU tensors. One JAX model, its forward and two jitted SGD
steps (``horovod_tpu.training._make_one_step``) are shared by the tests of
this file.

Tolerances, relative to the norm of what they compare. Both sides take
the same float32 math in other orders (XLA's and oneDNN's convolutions sum
their products differently), and how far that shows depends on the mode:

* eval mode (the running statistics normalise): logits and loss 1e-5 and
  every gradient leaf 1e-4; measured 4e-7 and at most 2.1e-6;
* train mode, the forward: logits 1e-3 and loss 1e-4 (measured 4.8e-4 and
  3.5e-5), each running-statistics leaf 1e-3 (at most 3.7e-4): train-mode
  batch norm amplifies a last-bit difference through the 94 layers;
* train mode, the whole model's gradients and SGD steps: at flax's
  initialisation the train-mode backward is chaotic. Moving every input
  pixel by one ulp moves the JAX model's own first-step gradients by
  5.5 % of the whole tree at batch 2 and still by 3.4 % at batch 8 (128 x
  128; 1.7 % with a two-pass variance, 1.8 % with a per-image scale and
  offset on the images), so no fixed float32 limit near 1e-3 holds there.
  The port must stay within twice the JAX model's own one-ulp distance
  (measured: 0.84x for the gradients, 1.14x for the parameters after two
  steps), over the whole tree and at the worst leaf (or within 1e-3, where
  that is looser: the first step's running statistics), and its losses
  within 1e-4 or twice the JAX model's own shift;
* train mode where it is not chaotic, at fixed limits: each mixed block
  alone (gradients 1e-4 of each leaf's norm) and two SGD steps of a stem
  ``ConvBN`` + ``InceptionA`` net (gradients and parameters 1e-4, running
  statistics 1e-5).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu import training as jtraining
from horovod_tpu.models import inception as jinc
from horovod_tpu_torch import training as ttraining
from horovod_tpu_torch.models import inception as tinc
from horovod_tpu_torch.models.convert import (batch_stats_to_flax,
                                              inception_from_flax,
                                              inception_grads_to_flax)

SIZE, BATCH, CLASSES = 128, 2, 10
LR, MOMENTUM = 0.01, 0.9


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


def _global_rel(got, want) -> float:
    """The relative error of a whole tree, as one vector."""
    got, want = _flat(got), _flat(want)
    num = sum(np.sum((np.asarray(got[k], np.float64) - want[k]) ** 2)
              for k in want)
    return float(np.sqrt(num / sum(np.sum(np.asarray(want[k], np.float64)
                                          ** 2) for k in want)))


def _assert_within_noise(got, want, nudged, what):
    """The port within twice the distance that one ulp of input moves the
    JAX model's own result (or 1e-3, where that is smaller), over the whole
    tree and at its worst leaf."""
    noise = _global_rel(nudged, want)
    assert _global_rel(got, want) <= max(1e-3, 2 * noise), (what, noise)
    worst = max(_rel(_flat(nudged)[k], v) for k, v in _flat(want).items())
    _assert_trees_close(got, want, max(1e-3, 2 * worst), what)


@pytest.fixture(scope="module")
def jax_run():
    """Flax variables; the train-mode forward; the eval-mode gradients; and
    two SGD steps, on the images and on the images moved by one ulp (the
    JAX model's own sensitivity to rounding)."""
    jm = jinc.InceptionV3(num_classes=CLASSES, dtype=jnp.float32)
    variables = _np_tree(jax.jit(lambda x: jm.init(
        jax.random.PRNGKey(0), x, train=False))(
            np.zeros((1, SIZE, SIZE, 3), np.float32)))
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.randint(0, CLASSES, (BATCH,)).astype(np.int32)
    logits, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, images)

    def eval_loss(params):
        out = jm.apply({"params": params,
                        "batch_stats": _np_tree(upd["batch_stats"])},
                       images, train=False)
        return jtraining._default_loss_fn(out, labels), out

    (eval_l, eval_logits), eval_grads = jax.jit(jax.value_and_grad(
        eval_loss, has_aux=True))(variables["params"])
    tx = optax.sgd(LR, momentum=MOMENTUM)
    step = jax.jit(jtraining._make_one_step(jm, tx,
                                            jtraining._default_loss_fn))
    runs = []
    for x in (images, np.nextafter(images, np.float32(np.inf))):
        params, stats, opt = (variables["params"], variables["batch_stats"],
                              tx.init(variables["params"]))
        steps = []
        for _ in range(2):
            loss, params, stats, opt = step(params, stats, opt, x, labels)
            # optax's trace after the first step is the gradient itself
            steps.append(dict(loss=float(loss), params=_np_tree(params),
                              stats=_np_tree(stats),
                              trace=_np_tree(opt[0].trace)))
        runs.append(steps)
    return dict(variables=variables, images=images, labels=labels,
                logits=np.asarray(logits),
                stats=_np_tree(upd["batch_stats"]), steps=runs[0],
                nudged=runs[1], eval_loss=float(eval_l),
                eval_logits=np.asarray(eval_logits),
                eval_grads=_np_tree(eval_grads))


def _port(variables, **kw):
    tm = tinc.InceptionV3(num_classes=CLASSES, dtype=torch.float32,
                          device="cpu", **kw)
    tm.load_state_dict(inception_from_flax(variables))
    return tm


def test_structure_matches_the_jax_tree(jax_run):
    """284 parameters, 188 running statistics, 94 fused batch norms at
    1000 classes, as ``jax.eval_shape`` of the JAX model counts them; and
    every flax leaf maps to one tensor of the port."""
    tm = tinc.InceptionV3(device="meta")
    params = list(tm.parameters())
    assert len(params) == 284
    assert sum(p.numel() for p in params) == 23_834_568
    assert len(list(tm.buffers())) == 188
    assert sum(isinstance(m, tinc.FusedBatchNormAct)
               for m in tm.modules()) == 94
    assert all(p.dtype == torch.float32 for p in tm.state_dict().values())
    tm = _port(jax_run["variables"])  # strict: each leaf, each tensor once
    n_leaves = sum(len(_flat(jax_run["variables"][c]))
                   for c in ("params", "batch_stats"))
    assert n_leaves == len(tm.state_dict())


def test_converter_round_trip(jax_run):
    variables = jax_run["variables"]
    tm = _port(variables)
    back = inception_grads_to_flax(dict(tm.named_parameters()), variables)
    _assert_trees_close(back, variables["params"], 0.0, "params")
    for k, leaf in _flat(back).items():
        np.testing.assert_array_equal(leaf, _flat(variables["params"])[k])
    stats = batch_stats_to_flax(tm)
    for k, leaf in _flat(variables["batch_stats"]).items():
        np.testing.assert_array_equal(_flat(stats)[k], leaf)


def test_forward_matches_jax(jax_run):
    """Train mode: logits, loss and the updated running statistics."""
    tm = _port(jax_run["variables"]).train()
    logits = tm(torch.from_numpy(jax_run["images"]))
    loss = ttraining.default_loss_fn(logits,
                                     torch.from_numpy(jax_run["labels"]))
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, CLASSES)
    first = jax_run["steps"][0]
    assert _rel(logits.detach().numpy(), jax_run["logits"]) <= 1e-3
    assert abs(loss.item() - first["loss"]) <= 1e-4 * first["loss"]
    _assert_trees_close(batch_stats_to_flax(tm), jax_run["stats"], 1e-3,
                        "batch_stats")


def test_eval_mode_gradients_match_jax(jax_run):
    """Eval mode (the running statistics normalise): logits, loss and every
    parameter gradient, each leaf within 1e-3 of its norm."""
    variables = {"params": jax_run["variables"]["params"],
                 "batch_stats": jax_run["stats"]}
    tm = _port(variables).eval()
    logits = tm(torch.from_numpy(jax_run["images"]))
    loss = ttraining.default_loss_fn(logits,
                                     torch.from_numpy(jax_run["labels"]))
    loss.backward()
    assert _rel(logits.detach().numpy(), jax_run["eval_logits"]) <= 1e-5
    assert abs(loss.item() - jax_run["eval_loss"]) <= 1e-5 * \
        jax_run["eval_loss"]
    grads = inception_grads_to_flax(
        {k: p.grad for k, p in tm.named_parameters()}, variables)
    _assert_trees_close(grads, jax_run["eval_grads"], 1e-4, "eval grads")
    np.testing.assert_array_equal(  # eval mode leaves the statistics alone
        batch_stats_to_flax(tm)["ConvBN_0"]["BatchNorm_0"]["mean"],
        jax_run["stats"]["ConvBN_0"]["BatchNorm_0"]["mean"])


def test_train_step_gradients_and_sgd_match_jax(jax_run):
    """Train mode, the port's eager step with ``torch.optim.SGD(0.01,
    momentum=0.9)`` against ``_make_one_step`` with ``optax.sgd``: the
    first step's gradients (SGD's momentum buffer), then the loss, the
    parameters and the running statistics after each of two steps."""
    tm = _port(jax_run["variables"])
    opt = torch.optim.SGD(tm.parameters(), lr=LR, momentum=MOMENTUM)
    step = ttraining.make_train_step(tm, opt)
    images, labels = (torch.from_numpy(jax_run[k])
                      for k in ("images", "labels"))
    for i, (want, nudged) in enumerate(zip(jax_run["steps"],
                                           jax_run["nudged"])):
        loss = step(images, labels).item()
        assert abs(loss - want["loss"]) <= max(
            1e-4 * want["loss"], 2 * abs(nudged["loss"] - want["loss"])), i
        trees = dict(params=(inception_grads_to_flax(
            dict(tm.named_parameters()), jax_run["variables"]), "params"),
            stats=(batch_stats_to_flax(tm), "stats"))
        if i == 0:
            trees["grads"] = (inception_grads_to_flax(
                {k: opt.state[p]["momentum_buffer"]
                 for k, p in tm.named_parameters()}, jax_run["variables"]),
                "trace")
        for name, (got, key) in trees.items():
            _assert_within_noise(got, want[key], nudged[key], f"{name} {i}")


#: each mixed block: its input channels in Inception-V3, its arguments
BLOCKS = {"A": (192, (32,)), "B": (288, ()), "C": (768, (128,)),
          "D": (768, ()), "E": (1280, ())}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_train_mode_matches_jax(name):
    """Each mixed block alone, in train mode, on (4, 9, 9, C) non-negative
    inputs (as a ReLU leaves them) and a random upstream gradient: the
    output and the updated running statistics within 1e-5 of each leaf's
    norm, the gradient of x and of every parameter within 1e-4 (the JAX
    package's own module limits; measured at most 2.2e-6 and 3.4e-6). A
    block is a few layers deep, so train mode does not amplify rounding
    here as it does through the whole model."""
    cin, args = BLOCKS[name]
    jm = getattr(jinc, f"Inception{name}")(*args, dtype=jnp.float32)
    rng = np.random.RandomState(ord(name))
    x = np.abs(rng.normal(size=(4, 9, 9, cin))).astype(np.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(3), x, train=False))

    def forward(params, xj):
        return jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]}, xj,
                        train=True, mutable=["batch_stats"])

    @jax.jit
    def forward_and_vjp(params, xj, g):
        (out, upd), vjp = jax.vjp(forward, params, xj)
        return out, upd, vjp((g, jax.tree_util.tree_map(jnp.zeros_like,
                                                        upd)))

    shape = jax.eval_shape(forward, variables["params"], x)[0].shape
    g = rng.normal(size=shape).astype(np.float32)
    out, upd, (dparams, dx) = forward_and_vjp(variables["params"], x, g)

    tm = getattr(tinc, f"Inception{name}")(cin, *args, dtype=torch.float32,
                                           device="cpu")
    tm.load_state_dict(inception_from_flax(variables))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = tm.train()(xt)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert _rel(y.detach().permute(0, 2, 3, 1).numpy(), out) <= 1e-5
    _assert_trees_close(batch_stats_to_flax(tm), upd["batch_stats"], 1e-5,
                        f"{name} batch_stats")
    assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), dx) <= 1e-4
    _assert_trees_close(inception_grads_to_flax(
        {k: p.grad for k, p in tm.named_parameters()}, variables),
        _np_tree(dparams), 1e-4, f"{name} grads")


class _JaxSmallNet(nn.Module):
    """A stem ``ConvBN`` (3x3/2 VALID), ``InceptionA`` and the classifier:
    the JAX side of :class:`_SmallNet`."""

    @nn.compact
    def __call__(self, x, train: bool = True):
        x = jinc.ConvBN(32, (3, 3), (2, 2), "VALID", dtype=jnp.float32)(
            x, train)
        x = jinc.InceptionA(32, dtype=jnp.float32)(x, train)
        return nn.Dense(CLASSES, dtype=jnp.float32, param_dtype=jnp.float32,
                        name="classifier")(jnp.mean(x, axis=(1, 2)))


class _SmallNet(tinc._FlaxNamed):
    def __init__(self):
        super().__init__(torch.float32, "cpu")
        self._child(tinc.ConvBN(3, 32, (3, 3), (2, 2), "VALID", **self._kw))
        self._child(tinc.InceptionA(32, 32, **self._kw))
        self.classifier = tinc.Dense(self.InceptionA_0.out_features, CLASSES,
                                     **self._kw)

    def forward(self, images):
        x = self.InceptionA_0(self.ConvBN_0(images.permute(0, 3, 1, 2)))
        return self.classifier(x.mean(dim=(2, 3)))


def test_small_net_sgd_steps_match_jax():
    """Two train-mode SGD-momentum steps of a net a few layers deep, the
    port's ``make_train_step`` against ``_make_one_step``, at fixed limits:
    the loss 1e-5; the first step's gradients, and the parameters after
    each step, 1e-4 of each leaf's norm (a zero-initialised bias after one
    step is the gradient's); the running statistics 1e-5 (measured at most
    1.7e-5, 1.2e-5 and 1.2e-6)."""
    jm = _JaxSmallNet()
    rng = np.random.RandomState(8)
    images = rng.uniform(-1, 1, (8, 33, 33, 3)).astype(np.float32)
    labels = rng.randint(0, CLASSES, (8,)).astype(np.int32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(4), images, train=False))
    tx = optax.sgd(LR, momentum=MOMENTUM)
    jstep = jax.jit(jtraining._make_one_step(jm, tx,
                                             jtraining._default_loss_fn))
    params, stats = variables["params"], variables["batch_stats"]
    jopt = tx.init(params)

    tm = _SmallNet()
    tm.load_state_dict(inception_from_flax(variables))
    opt = torch.optim.SGD(tm.parameters(), lr=LR, momentum=MOMENTUM)
    step = ttraining.make_train_step(tm, opt)
    for i in range(2):
        loss, params, stats, jopt = jstep(params, stats, jopt, images,
                                          labels)
        got = step(torch.from_numpy(images), torch.from_numpy(labels))
        assert abs(got.item() - float(loss)) <= 1e-5 * float(loss), i
        if i == 0:  # optax's trace after the first step is the gradient
            _assert_trees_close(inception_grads_to_flax(
                {k: opt.state[p]["momentum_buffer"]
                 for k, p in tm.named_parameters()}, variables),
                _np_tree(jopt[0].trace), 1e-4, "grads")
        _assert_trees_close(inception_grads_to_flax(
            dict(tm.named_parameters()), variables), _np_tree(params), 1e-4,
            f"params {i}")
        _assert_trees_close(batch_stats_to_flax(tm), _np_tree(stats), 1e-5,
                            f"stats {i}")


def _conv_bn_case(kernel, strides, padding, shape=(2, 9, 9, 8)):
    x = np.random.RandomState(5).uniform(-1, 1, shape).astype(np.float32)
    jm = jinc.ConvBN(16, kernel, strides, padding, dtype=jnp.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(1), x, train=False))
    out, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    tm = tinc.ConvBN(shape[-1], 16, kernel, strides, padding,
                     dtype=torch.float32, device="cpu")
    tm.load_state_dict(inception_from_flax(variables))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got, np.asarray(out), tm, upd


@pytest.mark.parametrize("kernel,strides,padding", [
    ((3, 3), (1, 1), "SAME"), ((1, 7), (1, 1), "SAME"),
    ((3, 3), (2, 2), "VALID")])
def test_conv_bn_matches_jax(kernel, strides, padding):
    """``ConvBN`` (conv, then the fused BN + ReLU) at each padding the model
    uses: the output and the updated running statistics."""
    got, want, tm, upd = _conv_bn_case(kernel, strides, padding)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(tm.BatchNorm_0, k).numpy(),
            np.asarray(upd["batch_stats"]["BatchNorm_0"][k]), rtol=1e-5,
            atol=1e-6)


def test_space_to_depth_stem_matches_jax_and_the_direct_conv():
    """At 75 x 75 (odd: one row and column of padding at the end), the
    stem equals JAX's ``SpaceToDepthStem`` and the direct 3x3/2 VALID
    conv with the same kernel, within 1e-5."""
    x = np.random.RandomState(6).uniform(-1, 1, (2, 75, 75, 3)) \
        .astype(np.float32)
    jm = jinc.SpaceToDepthStem(32, jnp.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(2), x))
    want = np.asarray(jm.apply(variables, x))
    tm = tinc.SpaceToDepthStem(32, torch.float32, device="cpu")
    tm.load_state_dict(inception_from_flax(variables))
    xt = torch.from_numpy(x)
    got = tm(xt)
    assert got.shape == (2, 32, 37, 37)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    direct = F.conv2d(xt.permute(0, 3, 1, 2), tm.kernel, stride=2)
    np.testing.assert_allclose(got.detach().numpy(), direct.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_two_ranks_keep_their_own_statistics_and_average_gradients(
        tmp_path):
    """A 2-rank gloo world, each rank on its half of one batch: each rank's
    running statistics are its own half's (the port normalises per rank,
    as one process per GPU does; the JAX package's jitted global batch
    would give both the whole batch's), the averaged gradients are the
    mean of two world-1 runs, and the parameters agree across ranks after
    one SGD step. Float32 sums in other orders: 1e-5."""
    import torch_inception_worker as worker
    from horovod_tpu_torch.training import default_loss_fn

    rng = np.random.RandomState(9)
    images = rng.uniform(-1, 1, (2, 2, 16, 16, 3)).astype(np.float32)
    labels = rng.randint(0, 10, (2, 2)).astype(np.int64)
    np.savez(tmp_path / "inputs.npz", images=images, labels=labels)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, 2, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    alone = []  # world-1 runs of rank 0's weights on each half
    for r in range(2):
        m = worker.SmallNet(seed=0)
        default_loss_fn(m(torch.from_numpy(images[r])),
                        torch.from_numpy(labels[r])).backward()
        alone.append(m)
    tol = dict(rtol=1e-5, atol=1e-6)
    for r in range(2):
        for k, v in alone[r].named_buffers():
            np.testing.assert_allclose(got[r][f"stat/{k}"], v.numpy(), **tol)
    assert not np.allclose(got[0]["stat/stem.BatchNorm_0.mean"],
                           got[1]["stat/stem.BatchNorm_0.mean"])
    g0, g1 = (worker.grads(m) for m in alone)
    p0 = {k: p.detach().numpy() for k, p in alone[0].named_parameters()}
    for k in g0:
        mean = (g0[k] + g1[k]) / 2
        for r in range(2):
            np.testing.assert_allclose(got[r][f"grad/{k}"], mean, **tol)
        # SGD's first step with momentum: p - lr * g
        np.testing.assert_allclose(got[0][f"param/{k}"],
                                   p0[k] - worker.LR * mean, **tol)
        np.testing.assert_array_equal(got[0][f"param/{k}"],
                                      got[1][f"param/{k}"])


@pytest.mark.parametrize("channels_last", [True, False])
def test_avg_pool_same_backward_is_the_pool_of_the_gradient(channels_last):
    """The SAME 3x3 average pool's backward (the pool of the gradient)
    equals autograd's backward of ``F.avg_pool2d`` on the CPU, where
    PyTorch's is right; 1e-6 (sums of 9 in other orders)."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.normal(size=(2, 8, 7, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 8, 7, 5)).astype(np.float32))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    grads = []
    for pool in (tinc._avg_pool_same, lambda t: F.avg_pool2d(
            t, 3, stride=1, padding=1, count_include_pad=True)):
        xt = x.clone().requires_grad_()
        pool(xt).backward(g)
        grads.append(xt.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0,
                               atol=1e-6)
