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

The tree is the one ``horovod_tpu.models.transformer.Transformer.init``
returns, as numpy arrays (``{"params": {...}}`` or the inner dict). Layouts
differ: a flax ``Dense`` kernel is ``(in, out)`` where ``nn.Linear.weight``
is ``(out, in)``; the attention's ``DenseGeneral`` q/k/v kernels are
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
