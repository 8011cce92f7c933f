"""Carry weights (and gradients) between the JAX package's flax parameter
tree and the port's ``Transformer`` state dict.

The tree is the one ``horovod_tpu.models.transformer.Transformer.init``
returns, as numpy arrays (``{"params": {...}}`` or the inner dict). Layouts
differ: a flax ``Dense`` kernel is ``(in, out)`` where ``nn.Linear.weight``
is ``(out, in)``; the attention's ``DenseGeneral`` q/k/v kernels are
``(d, heads, head_dim)`` with ``(heads, head_dim)`` biases, and its ``out``
kernel is ``(heads, head_dim, d)``. Each entry of :func:`key_map` pairs a
flax path with a torch key and the two layout conversions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

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
