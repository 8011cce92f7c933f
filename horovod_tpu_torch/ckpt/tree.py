"""The checkpoint layer's flatten, in ``jax.tree_util``'s order.

A leaf's key in a shard file (``{tree}/{i}``, ``horovod_tpu/ckpt/
writer.py:180-210``) and in the rank-0 sidecar (the ``/``-joined path,
``horovod_tpu/checkpoint.py:67-83``) comes from its place in the JAX
package's flatten. The port flattens in exactly that order, so a
checkpoint cross-reads between the packages:

* a ``dict`` by sorted key, an ``OrderedDict`` (a ``state_dict()``) in its
  own order;
* a ``NamedTuple`` by field (path element ``.<field>``), a list or tuple in
  order (path element the index);
* ``None`` is a node with no leaves;
* a ``ZeroSpec`` is static (no leaves), as the JAX package registers it;
* everything else, and whatever ``is_leaf`` accepts (a sharded ZeRO state),
  is one leaf.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

from horovod_tpu_torch.parallel.zero import ZeroSpec


class _Node(NamedTuple):
    kind: str        # "leaf", "none", "static", "dict", "odict", "nt", "seq"
    cls: Any         # the container's type (to rebuild it), or the static
    keys: tuple      # dict keys / namedtuple fields, in flatten order
    children: tuple  # of _Node


_LEAF = _Node("leaf", None, (), ())
_NONE = _Node("none", None, (), ())


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(x, path: tuple, is_leaf, out: list) -> _Node:
    if is_leaf is not None and is_leaf(x):
        out.append((path, x))
        return _LEAF
    if x is None:
        return _NONE
    if isinstance(x, ZeroSpec):
        return _Node("static", x, (), ())
    if isinstance(x, dict):
        if isinstance(x, collections.OrderedDict):
            kind, keys = "odict", tuple(x)
        else:
            kind, keys = "dict", tuple(sorted(x))
        return _Node(kind, type(x), keys, tuple(
            _flatten(x[k], path + (str(k),), is_leaf, out) for k in keys))
    if _is_namedtuple(x):
        fields = type(x)._fields
        return _Node("nt", type(x), fields, tuple(
            _flatten(getattr(x, f), path + (f".{f}",), is_leaf, out)
            for f in fields))
    if isinstance(x, (list, tuple)):
        return _Node("seq", type(x), (), tuple(
            _flatten(v, path + (str(i),), is_leaf, out)
            for i, v in enumerate(x)))
    out.append((path, x))
    return _LEAF


def flatten_with_path(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                      ) -> Tuple[List[Tuple[tuple, Any]], _Node]:
    """``([(path, leaf), ...], treedef)``: ``path`` a tuple of strings."""
    out: list = []
    treedef = _flatten(tree, (), is_leaf, out)
    return out, treedef


def flatten(tree, is_leaf=None) -> Tuple[list, _Node]:
    """``(leaves, treedef)`` in the JAX package's order."""
    pairs, treedef = flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in pairs], treedef


def path_key(path: tuple) -> str:
    """The rank-0 sidecar's key of a leaf: its path joined by ``/``."""
    return "/".join(path) or "<root>"


def unflatten(treedef: _Node, leaves) -> Any:
    """Rebuild the tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _NONE) is not _NONE:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def _build(node: _Node, it):
    if node.kind == "leaf":
        try:
            return next(it)
        except StopIteration:
            raise ValueError("unflatten: fewer leaves than the tree holds") \
                from None
    if node.kind == "none":
        return None
    if node.kind == "static":
        return node.cls
    children = [_build(c, it) for c in node.children]
    if node.kind in ("dict", "odict"):
        return node.cls(zip(node.keys, children))
    if node.kind == "nt":
        return node.cls(*children)
    return node.cls(children)
