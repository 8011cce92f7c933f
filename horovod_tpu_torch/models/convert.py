"""Carry weights, gradients and optimizer state between the JAX package
and the port, as numpy.

Weights and gradients go between the JAX package's flax parameter tree and
the port's ``Transformer`` state dict. AdamW state goes both ways too:
optax's ``ScaleByAdamState`` (count, mu and nu trees shaped like the
params) and the port's fused AdamW state (:func:`adam_state_from_optax`,
:func:`adam_state_to_optax`), and the ZeRO-1 ``FlatAdamState`` of the
JAX package's single controller, whose arrays are ``(world, shard)``
stacked, and the port's per-rank shards (:func:`flat_state_from_jax`,
:func:`flat_state_to_jax`).

Inception-V3's variables go both ways by name (:func:`inception_from_flax`,
:func:`inception_grads_to_flax`, :func:`batch_stats_to_flax`): the port's
submodules carry flax's names, so the path of a flax leaf, joined with
dots, is its state-dict key. A flax ``Conv`` kernel is HWIO where the
port's is OIHW, and the ``classifier`` kernel ``(in, out)`` where the
port's is ``(out, in)``; 1-d leaves (BN scale, bias, mean, var; the
classifier bias) are the same.

The transformer's tree is the one
``horovod_tpu.models.transformer.Transformer.init`` returns, as numpy
arrays (``{"params": {...}}`` or the inner dict). Layouts differ: a flax
``Dense`` kernel is ``(in, out)`` where ``nn.Linear.weight`` is ``(out,
in)``; the attention's ``DenseGeneral`` q/k/v kernels are
``(d, heads, head_dim)`` with ``(heads, head_dim)`` biases, and its ``out``
kernel is ``(heads, head_dim, d)``. Each entry of :func:`key_map` pairs a
flax path with a torch key and the two layout conversions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch.ops.fused_adamw import ScaleByAdamState
from horovod_tpu_torch.parallel.zero import FlatAdamState, ZeroSpec

Path = Tuple[str, ...]
# (flax path, torch key, flax->torch, torch->flax given the flax shape)
Entry = Tuple[Path, str, Callable, Callable]


def _same(a, shape=None):
    return a


def _dense_in(a):  # (in, ...out) -> (out, in)
    return a.reshape(a.shape[0], -1).T


def _dense_in_back(a, shape):
    return a.T.reshape(shape)


def _dense_out(a):  # (...in, out) -> (out, in)
    return a.reshape(-1, a.shape[-1]).T


def _flat(a):
    return a.reshape(-1)


def _shaped(a, shape):
    return a.reshape(shape)


def key_map(num_layers: int) -> List[Entry]:
    entries: List[Entry] = [
        (("token_embed", "embedding"), "token_embed", _same, _same),
        (("pos_embed",), "pos_embed", _same, _same),
        (("final_norm", "scale"), "final_norm.weight", _same, _same),
        (("final_norm", "bias"), "final_norm.bias", _same, _same),
    ]
    for i in range(num_layers):
        fl, tl = f"layer_{i}", f"layers.{i}"
        for ln, tln in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            entries += [((fl, ln, "scale"), f"{tl}.{tln}.weight", _same, _same),
                        ((fl, ln, "bias"), f"{tl}.{tln}.bias", _same, _same)]
        for name in ("query", "key", "value"):
            entries += [
                ((fl, "attention", name, "kernel"),
                 f"{tl}.attention.{name}.weight", _dense_in, _dense_in_back),
                ((fl, "attention", name, "bias"),
                 f"{tl}.attention.{name}.bias", _flat, _shaped)]
        entries += [
            ((fl, "attention", "out", "kernel"), f"{tl}.attention.out.weight",
             _dense_out, lambda a, shape: a.T.reshape(shape)),
            ((fl, "attention", "out", "bias"), f"{tl}.attention.out.bias",
             _same, _same)]
        for name in ("wi", "wo"):
            entries += [
                ((fl, "mlp", name, "kernel"), f"{tl}.mlp.{name}.weight",
                 _dense_in, _dense_in_back),
                ((fl, "mlp", name, "bias"), f"{tl}.mlp.{name}.bias",
                 _same, _same)]
    return entries


def _inner(tree):
    return tree["params"] if "params" in tree else tree


def _get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _num_layers(params) -> int:
    return sum(1 for k in params if k.startswith("layer_"))


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The port's state dict from a flax parameter tree of numpy arrays."""
    params = _inner(tree)
    return {tkey: torch.from_numpy(np.array(
                to_torch(np.asarray(_get(params, path), np.float32))))
            for path, tkey, to_torch, _ in key_map(_num_layers(params))}


def grads_to_flax(tensors: Dict[str, torch.Tensor], like) -> dict:
    """A flax-shaped tree of numpy arrays from torch tensors keyed like the
    state dict (gradients, parameters); ``like`` is a flax tree giving the
    structure and shapes."""
    params = _inner(like)
    out: dict = {}
    for path, tkey, _, to_flax in key_map(_num_layers(params)):
        shape = np.shape(_get(params, path))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = to_flax(
            tensors[tkey].detach().float().cpu().numpy(), shape)
    return out


def adam_state_from_optax(count, mu, nu) -> ScaleByAdamState:
    """The port's fused AdamW state from optax's ``ScaleByAdamState``
    fields as numpy (``mu``/``nu`` are flax trees shaped like the
    params); the moments take the port's layouts, as the weights do."""
    return ScaleByAdamState(count=int(np.asarray(count)),
                            mu=params_from_flax(mu), nu=params_from_flax(nu))


def adam_state_to_optax(state: ScaleByAdamState, like):
    """``(count, mu, nu)`` of optax's ``ScaleByAdamState`` as numpy, the
    trees shaped like the flax tree ``like``."""

    def tree(moment):
        inner = grads_to_flax(moment, like)
        return {"params": inner} if "params" in like else inner

    return np.asarray(state.count, np.int32), tree(state.mu), tree(state.nu)


def _same_layout(spec: ZeroSpec, jspec) -> None:
    if (spec.world != jspec.world or spec.num_leaves != jspec.num_leaves
            or [tuple(g) for g in spec.groups]
            != [tuple(g) for g in jspec.groups]):
        raise ValueError(
            "the port's ZeRO layout differs from the JAX state's: build the "
            "port's state from the same leaves, in the same order")


def flat_state_from_jax(jstate, rank: int, spec: ZeroSpec) -> FlatAdamState:
    """Rank ``rank``'s :class:`FlatAdamState` from the JAX package's
    single-controller one, whose ``master``/``mu``/``nu`` hold one
    ``(world, shard)`` array per group: the rank takes row ``rank``.
    ``spec`` is the port's layout (its state's ``spec``); it must equal the
    JAX state's group by group."""
    _same_layout(spec, jstate.spec)

    def rows(arrays):
        return tuple(torch.from_numpy(np.array(np.asarray(a)[rank],
                                               np.float32))
                     for a in arrays)

    return FlatAdamState(spec=spec._replace(rank=rank),
                         count=int(np.asarray(jstate.count)),
                         master=rows(jstate.master), mu=rows(jstate.mu),
                         nu=rows(jstate.nu))


def flat_state_to_jax(states: Sequence[FlatAdamState]) -> dict:
    """Every rank's :class:`FlatAdamState`, in rank order, as the JAX
    package's single-controller arrays: ``{"count", "master", "mu",
    "nu"}`` with one ``(world, shard)`` float32 array per group."""
    spec = states[0].spec
    if len(states) != spec.world or any(
            s.spec._replace(rank=0) != spec._replace(rank=0)
            or s.count != states[0].count for s in states):
        raise ValueError("flat_state_to_jax needs one state per rank, all "
                         "of one layout and step")

    def stack(field):
        return tuple(np.stack([getattr(s, field)[gi].detach().cpu().numpy()
                               for s in states])
                     for gi in range(len(spec.groups)))

    return {"count": np.asarray(states[0].count, np.int32),
            "master": stack("master"), "mu": stack("mu"), "nu": stack("nu")}


def _leaves(tree, prefix: Path = ()):
    """(path, leaf) of every leaf of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _inception_to_torch(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    return a.T if a.ndim == 2 else a  # (in, out) -> (out, in)


def _inception_to_flax(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    return a.T if a.ndim == 2 else a


def inception_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The port's Inception-V3 state dict (parameters and running
    statistics) from flax's ``{"params", "batch_stats"}`` tree of numpy
    arrays; ``model.load_state_dict(...)`` (strict) then checks that every
    leaf found its tensor and every tensor its leaf."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            out[".".join(path)] = torch.from_numpy(np.array(
                _inception_to_torch(np.asarray(leaf, np.float32))))
    return out


def inception_grads_to_flax(tensors: Dict[str, torch.Tensor], like) -> dict:
    """A flax-shaped tree of numpy arrays from tensors keyed like the
    port's parameters (gradients, parameters); ``like`` is the flax
    ``params`` tree (or ``{"params": ...}``) giving structure and shapes."""
    out: dict = {}
    for path, leaf in _leaves(_inner(like)):
        a = _inception_to_flax(
            tensors[".".join(path)].detach().float().cpu().numpy())
        if a.shape != np.shape(leaf):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, flax has "
                             f"{np.shape(leaf)}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def batch_stats_to_flax(model: torch.nn.Module) -> dict:
    """The model's running statistics (its buffers) as flax's
    ``batch_stats`` tree of numpy arrays."""
    out: dict = {}
    for key, t in model.named_buffers():
        *path, leaf = key.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return out
