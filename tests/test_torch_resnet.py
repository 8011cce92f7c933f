"""The port's ResNet (``horovod_tpu_torch/models/resnet.py``) against the
JAX package's flax model, on the CPU, in float32.

A small configuration of each block type: stage sizes (1, 1, 1, 1), 8
filters, 10 classes, 4 images of 32 x 32. The stem and the strided convs
are also held alone at odd sizes, where the stem pads. Flax initialises the variables, ``resnet_from_flax`` carries them
to the port, and the same seeded numpy images and labels go through both.
The JAX model's batch norm is flax's ``nn.BatchNorm``, as the port's is.

Tolerances, relative to the norm of what they compare (both sides take
the same float32 math in other orders: XLA's and oneDNN's convolutions sum
their products differently). Measured on this configuration:

* eval mode: logits 1e-5 and the loss 1e-5 (measured 3.8e-7 and 2.4e-7),
  every gradient leaf 1e-4 (at most 6.8e-7);
* train mode, the forward: logits 1e-4 (8.8e-6), each running-statistics
  leaf 1e-5 (3.4e-6);
* two train-mode SGD-momentum steps (lr 0.01, momentum 0.9) against
  ``horovod_tpu.training._make_one_step`` with ``optax.sgd``: the loss
  1e-5 (1.7e-6), the first step's gradients and the parameters after each
  step 1e-3 of each leaf's norm (at most 7.4e-5, ``bn_init``'s bias, whose
  gradient is a small difference), the running statistics 1e-5 (3.4e-6);
* the stem alone 1e-5 absolute against JAX's and the direct conv, and a
  ``"SAME"`` conv alone 1e-5 against flax's.
  Four blocks of train-mode batch norm are shallow enough for fixed limits
  (the whole Inception-V3 is not, ``tests/test_torch_inception.py``).
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
from horovod_tpu.models import resnet as jres
from horovod_tpu_torch import training as ttraining
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models.convert import (batch_stats_to_flax,
                                              resnet_from_flax,
                                              resnet_grads_to_flax)

BATCH, CLASSES, FILTERS = 4, 10, 8
LR, MOMENTUM = 0.01, 0.9
BLOCKS = {"bottleneck": (jres.BottleneckBlock, tres.BottleneckBlock),
          "basic": (jres.ResNetBlock, tres.ResNetBlock)}


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


def _data(size: int):
    rng = np.random.RandomState(size)
    images = rng.uniform(-1, 1, (BATCH, size, size, 3)).astype(np.float32)
    labels = rng.randint(0, CLASSES, (BATCH,)).astype(np.int32)
    return images, labels


def _jax_model(block: str):
    return jres.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BLOCKS[block][0],
                       num_filters=FILTERS, num_classes=CLASSES,
                       dtype=jnp.float32)


def _port(block: str, variables):
    tm = tres.ResNet(stage_sizes=(1, 1, 1, 1), block_cls=BLOCKS[block][1],
                     num_filters=FILTERS, num_classes=CLASSES,
                     dtype=torch.float32, device="cpu")
    tm.load_state_dict(resnet_from_flax(variables))  # strict
    return tm


@pytest.fixture(scope="module", params=list(BLOCKS))
def jax_run(request):
    """Flax variables; the train-mode forward; the eval-mode loss, logits
    and gradients; and two SGD-momentum steps."""
    block, size = request.param, 32
    jm = _jax_model(block)
    images, labels = _data(size)
    variables = _np_tree(jax.jit(lambda x: jm.init(
        jax.random.PRNGKey(0), x, train=False))(images))
    logits, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, images)

    def eval_loss(params):
        out = jm.apply({"params": params,
                        "batch_stats": variables["batch_stats"]}, images,
                       train=False)
        return jtraining._default_loss_fn(out, labels), out

    (eval_l, eval_logits), eval_grads = jax.jit(jax.value_and_grad(
        eval_loss, has_aux=True))(variables["params"])
    tx = optax.sgd(LR, momentum=MOMENTUM)
    step = jax.jit(jtraining._make_one_step(jm, tx,
                                            jtraining._default_loss_fn))
    params, stats, opt = (variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]))
    steps = []
    for _ in range(2):
        loss, params, stats, opt = step(params, stats, opt, images, labels)
        steps.append(dict(loss=float(loss), params=_np_tree(params),
                          stats=_np_tree(stats),
                          trace=_np_tree(opt[0].trace)))
    return dict(block=block, variables=variables, images=images,
                labels=labels, logits=np.asarray(logits),
                stats=_np_tree(upd["batch_stats"]), eval_loss=float(eval_l),
                eval_logits=np.asarray(eval_logits),
                eval_grads=_np_tree(eval_grads), steps=steps)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet34", "ResNet50",
                                  "ResNet101", "ResNet152"])
def test_structure_matches_the_jax_tree(name):
    """Every partial has the JAX model's parameter and statistics leaves,
    shape for shape (``jax.eval_shape`` of its init at 1000 classes), in
    float32: ResNet-50 has 161 parameter tensors (25,557,032 parameters),
    53 batch norms and 106 statistics."""
    jm = getattr(jres, name)(num_classes=1000)
    tree = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                            train=False),
                          jax.ShapeDtypeStruct((1, 224, 224, 3),
                                               jnp.float32))
    tm = getattr(tres, name)(device="meta")
    want = {".".join(k.split("/")): leaf.shape
            for c in ("params", "batch_stats")
            for k, leaf in _flat(tree[c]).items()}
    got = {k: tuple(t.shape) for k, t in tm.state_dict().items()}
    assert got.keys() == want.keys()
    for k, shape in want.items():
        fl = shape[::-1] if len(shape) == 2 else shape
        if len(shape) == 4:  # HWIO -> OIHW
            fl = (shape[3], shape[2], shape[0], shape[1])
        assert got[k] == fl, k
    assert all(t.dtype == torch.float32 for t in tm.state_dict().values())
    if name == "ResNet50":
        params = list(tm.parameters())
        assert len(params) == 161
        assert sum(p.numel() for p in params) == 25_557_032
        assert len(list(tm.buffers())) == 106
        assert sum(isinstance(m, tres.BatchNorm)
                   for m in tm.modules()) == 53


def test_converter_round_trip_and_init(jax_run):
    """The flax variables load (strict) and come back bit for bit; the
    port's own initialisation zeroes each block's last norm scale, as
    flax's does."""
    variables = jax_run["variables"]
    tm = _port(jax_run["block"], variables)
    back = resnet_grads_to_flax(dict(tm.named_parameters()), variables)
    for k, leaf in _flat(variables["params"]).items():
        np.testing.assert_array_equal(_flat(back)[k], leaf)
    for k, leaf in _flat(variables["batch_stats"]).items():
        np.testing.assert_array_equal(_flat(batch_stats_to_flax(tm))[k],
                                      leaf)
    fresh = tres.ResNet(stage_sizes=(1, 1, 1, 1),
                        block_cls=BLOCKS[jax_run["block"]][1],
                        num_filters=FILTERS, num_classes=CLASSES,
                        dtype=torch.float32, device="cpu")
    for k, p in fresh.named_parameters():
        leaf = _flat(variables["params"])[k.replace(".", "/")]
        zero = not leaf.any()  # flax's zero-initialised scales
        assert bool((p == 0).all()) == zero, k


def test_train_mode_forward_matches_jax(jax_run):
    """Train mode: logits and the updated running statistics."""
    tm = _port(jax_run["block"], jax_run["variables"]).train()
    logits = tm(torch.from_numpy(jax_run["images"]))
    assert logits.dtype == torch.float32 and logits.shape == (BATCH,
                                                              CLASSES)
    assert _rel(logits.detach().numpy(), jax_run["logits"]) <= 1e-4
    _assert_trees_close(batch_stats_to_flax(tm), jax_run["stats"], 1e-5,
                        "batch_stats")


def test_eval_mode_gradients_match_jax(jax_run):
    """Eval mode (the running statistics normalise): logits, loss and every
    parameter gradient; the statistics are left alone."""
    tm = _port(jax_run["block"], jax_run["variables"]).eval()
    logits = tm(torch.from_numpy(jax_run["images"]))
    loss = ttraining.default_loss_fn(logits,
                                     torch.from_numpy(jax_run["labels"]))
    loss.backward()
    assert _rel(logits.detach().numpy(), jax_run["eval_logits"]) <= 1e-5
    assert abs(loss.item() - jax_run["eval_loss"]) <= \
        1e-5 * jax_run["eval_loss"]
    grads = resnet_grads_to_flax({k: p.grad for k, p in
                                  tm.named_parameters()},
                                 jax_run["variables"])
    _assert_trees_close(grads, jax_run["eval_grads"], 1e-4, "eval grads")
    _assert_trees_close(batch_stats_to_flax(tm),
                        jax_run["variables"]["batch_stats"], 0.0, "stats")


def test_sgd_momentum_steps_match_jax(jax_run):
    """The port's eager ``make_train_step`` with ``torch.optim.SGD(0.01,
    momentum=0.9)`` (no Nesterov: ``optax.sgd(momentum=0.9)``'s trace) and
    the JAX package's default loss against ``_make_one_step``: the first
    step's gradients (SGD's momentum buffer, optax's trace), then the loss,
    the parameters and the running statistics after each of two steps."""
    tm = _port(jax_run["block"], jax_run["variables"])
    opt = torch.optim.SGD(tm.parameters(), lr=LR, momentum=MOMENTUM)
    step = ttraining.make_train_step(tm, opt)
    images, labels = (torch.from_numpy(jax_run[k])
                      for k in ("images", "labels"))
    variables = jax_run["variables"]
    for i, want in enumerate(jax_run["steps"]):
        loss = step(images, labels).item()
        assert abs(loss - want["loss"]) <= 1e-5 * want["loss"], i
        if i == 0:
            _assert_trees_close(resnet_grads_to_flax(
                {k: opt.state[p]["momentum_buffer"]
                 for k, p in tm.named_parameters()}, variables),
                want["trace"], 1e-3, "grads")
        _assert_trees_close(resnet_grads_to_flax(
            dict(tm.named_parameters()), variables), want["params"], 1e-3,
            f"params {i}")
        _assert_trees_close(batch_stats_to_flax(tm), want["stats"], 1e-5,
                            f"stats {i}")


@pytest.mark.parametrize("size", [32, 33])
def test_space_to_depth_stem_matches_jax_and_the_direct_conv(size):
    """The folded stem equals the direct 7x7/2 conv with padding 3 over
    the same kernel, and the JAX model's ``conv_init``: its
    ``SpaceToDepthConvInit`` at an even size, its direct ``nn.Conv`` at an
    odd one (where the port pads one zero row and column at the end)."""
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)) \
        .astype(np.float32)
    if size % 2 == 0:
        jm = jres.SpaceToDepthConvInit(16, jnp.float32)
    else:
        jm = nn.Conv(16, (7, 7), (2, 2), padding=[(3, 3), (3, 3)],
                     use_bias=False, dtype=jnp.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(2), x))
    want = np.asarray(jm.apply(variables, x))
    tm = tres.SpaceToDepthConvInit(16, torch.float32, device="cpu")
    tm.load_state_dict(resnet_from_flax(variables))
    xt = torch.from_numpy(x)
    got = tm(xt).detach()
    assert got.shape == (2, 16, (size + 1) // 2, (size + 1) // 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    direct = F.conv2d(xt.permute(0, 3, 1, 2), tm.kernel, stride=2,
                      padding=3)
    np.testing.assert_allclose(got.numpy(), direct.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,strides,size", [
    ((3, 3), (2, 2), 8), ((3, 3), (2, 2), 7), ((1, 1), (2, 2), 8),
    ((3, 3), (1, 1), 6)])
def test_same_padded_conv_matches_flax(kernel, strides, size):
    """``Conv``'s ``"SAME"`` padding at every stride the model uses, even
    and odd sizes: a 3x3 stride-2 conv over an even size pads only at the
    end, as XLA does."""
    x = np.random.RandomState(7).normal(size=(2, size, size, 4)) \
        .astype(np.float32)
    jm = nn.Conv(6, kernel, strides, use_bias=False, dtype=jnp.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(1), x))
    want = np.asarray(jm.apply(variables, x))
    tm = tres.Conv(4, 6, kernel, strides, dtype=torch.float32, device="cpu")
    tm.load_state_dict(resnet_from_flax(variables))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).detach()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_two_ranks_average_gradients_with_their_own_statistics(tmp_path):
    """A 2-rank gloo world (``tests/torch_resnet_worker.py``), each rank on
    its half of one batch, two ``DistributedOptimizer(SGD(0.01 x 2,
    momentum 0.9))`` steps after ``broadcast_parameters``: each rank's
    running statistics are its own half's (the port normalises per rank,
    one process per GPU); the parameters after each step are the JAX
    step's on the mean of the two halves' gradients, on both ranks. Float32
    sums in other orders: parameters 1e-3 of each leaf's norm (as the
    one-process steps), statistics 1e-5."""
    import torch_resnet_worker as worker

    jm = _jax_model("bottleneck")
    rng = np.random.RandomState(11)
    images = rng.uniform(-1, 1, (2, BATCH, 32, 32, 3)).astype(np.float32)
    labels = rng.randint(0, CLASSES, (2, BATCH)).astype(np.int32)
    variables = _np_tree(jax.jit(lambda x: jm.init(
        jax.random.PRNGKey(5), x, train=False))(images[0]))
    inp = dict(images=images, labels=labels)
    inp.update({f"v.{k}": v.numpy() for k, v in
                resnet_from_flax(variables).items()})
    np.savez(tmp_path / "inputs.npz", **inp)

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, 2, str(tmp_path)))
             for r in range(2)]
    for p in procs:  # the world runs while JAX computes its side
        p.start()

    tx = optax.sgd(LR * 2, momentum=MOMENTUM)

    @jax.jit
    def step(params, opt, stats):
        """One SGD step on the mean of the two halves' gradients; each
        half's statistics are its own."""
        def loss(p, st, x, y):
            out, upd = jm.apply({"params": p, "batch_stats": st}, x,
                                train=True, mutable=["batch_stats"])
            return jtraining._default_loss_fn(out, y), upd["batch_stats"]

        out = [jax.grad(loss, has_aux=True)(params, stats[r], images[r],
                                            labels[r]) for r in range(2)]
        g = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, out[0][0],
                                   out[1][0])
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), opt, [s for _, s in out]

    params, opt = variables["params"], tx.init(variables["params"])
    stats = [variables["batch_stats"]] * 2
    want = []
    for _ in range(worker.STEPS):
        params, opt, stats = step(params, opt, stats)
        want.append((_np_tree(params), [_np_tree(s) for s in stats]))

    for p in procs:
        p.join(timeout=240)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for step, (params, stats) in enumerate(want):
        for r, res in enumerate(got):
            mine = {k[len(f"step{step}.param."):]: res[k] for k in res.files
                    if k.startswith(f"step{step}.param.")}
            _assert_trees_close(resnet_grads_to_flax(
                {k: torch.from_numpy(v) for k, v in mine.items()},
                variables), params, 1e-3, f"rank {r} step {step}")
            own = {k[len(f"step{step}.stat."):]: res[k] for k in res.files
                   if k.startswith(f"step{step}.stat.")}
            _assert_trees_close(_nest(own), stats[r], 1e-5,
                                f"rank {r} stats {step}")


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out
