"""Shared helpers for the parallelism strategy modules (port of
``horovod_tpu/parallel/_util.py``), on trees of tensors: nested dicts,
lists and tuples whose leaves are tensors."""

from __future__ import annotations

import torch


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
