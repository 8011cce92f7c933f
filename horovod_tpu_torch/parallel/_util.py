"""Shared helpers for the parallelism strategy modules (port of
``horovod_tpu/parallel/_util.py``): trees of tensors (nested dicts, lists
and tuples whose leaves are tensors), and the model-parallel axes as
process groups (the JAX package names mesh axes; the port has no mesh)."""

from __future__ import annotations

import torch
import torch.distributed as dist


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        if any(not isinstance(t, dict) or t.keys() != first.keys()
               for t in trees):
            raise ValueError("the trees do not share one structure")
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        if any(type(t) is not type(first) or len(t) != len(first)
               for t in trees):
            raise ValueError("the trees do not share one structure")
        return type(first)(_tree_map(fn, *leaves)
                           for leaves in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage (or per-expert) parameter trees along a
    new leading axis: every leaf becomes ``torch.stack`` of the stages'
    leaves. The trees must share one structure."""
    per_stage_params = list(per_stage_params)
    if not per_stage_params:
        raise ValueError("stack_stage_params needs at least one tree")
    return _tree_map(lambda *leaves: torch.stack(leaves, dim=0),
                     *per_stage_params)


# ---------------------------------------------------------------------------
# The model-parallel axes as process groups
# ---------------------------------------------------------------------------

#: the JAX package's mesh axis names (``core/mesh.py``) that
#: :func:`axis_group` takes, beside a process group and ``None``
AXES = ("world", "local", "cross")


def axis_ranks(axis: str) -> list:
    """The ranks of this rank's ``axis``, in rank order. ``"local"``: the
    ``local_size`` consecutive ranks of this rank's ``cross_rank`` (one host
    of the launcher's layout, which ``runtime/hierarchy.py``'s contiguous
    slices share); ``"cross"``: the ranks with this ``local_rank``, one a
    host; ``"world"``: every rank."""
    from horovod_tpu_torch.core import basics

    st = basics._ensure_init()
    if axis == "world":
        return list(range(st.size))
    local = st.local_size
    if local < 1 or st.size % local:
        raise ValueError(f"local_size {local} does not tile world "
                         f"{st.size} into hosts")
    if axis == "local":
        first = st.cross_rank * local
        return list(range(first, first + local))
    if axis == "cross":
        return list(range(st.local_rank, st.size, local))
    raise ValueError(f"unknown axis {axis!r}: a process group or one of "
                     f"{AXES}")


def axis_group(axis=None):
    """The process group of a model-parallel axis: ``axis`` itself when it
    is a group, the default group (every rank) for ``None`` or
    ``"world"``, else the group of :func:`axis_ranks`. Never the runtime's
    data group, on which the cycle thread issues from its own stream.

    A group is made once a generation (``init()`` to ``shutdown()``) and
    kept in the global state; ``shutdown()`` destroys it. It is made
    with ``new_group(use_local_synchronization=True)``: only its members
    take part, and its name is a hash of its ranks, not the world's
    running group count. The runtime's cycle thread makes the two-level
    collectives' groups by that count at a cycle no caller can foresee,
    so a group made from the caller's thread by the count could take
    another number on each rank; a hashed name is the same on every rank
    whatever the threads' order."""
    if axis is not None and not isinstance(axis, str):
        return axis
    from horovod_tpu_torch.core import state as state_mod

    ranks = axis_ranks(axis or "world")
    st = state_mod.global_state()
    if len(ranks) == st.size:
        return dist.group.WORLD
    key = tuple(ranks)
    with st.lock:
        group = st.axis_groups.get(key)
        if group is None:
            group = dist.new_group(ranks, use_local_synchronization=True)
            st.axis_groups[key] = group
    return group


def group_rank_size(group) -> tuple:
    """``(rank in group, group size)``."""
    return dist.get_rank(group), dist.get_world_size(group)


def group_peer(group, index: int) -> int:
    """The global rank of the group's member at ``index`` (modulo its
    size)."""
    return dist.get_global_rank(group, index % dist.get_world_size(group))
