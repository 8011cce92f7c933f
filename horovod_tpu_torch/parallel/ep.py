"""Expert parallelism: the Switch-style MoE layer with all-to-all token
routing (port of ``horovod_tpu/parallel/ep.py``).

Experts live one a rank, and the world takes the place of the JAX
package's mesh axis: each rank's tokens are routed top-1, packed into
per-expert capacity buffers, exchanged through the runtime's all-to-all
(``enqueue_alltoall``, NCCL between GPUs, gloo on the CPU), processed by
this rank's expert, and exchanged back to be combined with the gate
probabilities. Shapes are static: tokens beyond an expert's capacity are
dropped (their output is zero), the Switch Transformer contract.

Each exchange is a named op (``<name>.dispatch``, ``<name>.combine``, and
``.grad`` after either in the backward), so the names repeat every step and
the runtime's response cache answers them from the second. Autograd goes
through both: the backward of a tiled all-to-all is the same all-to-all of
the gradient (``lax.all_to_all``'s transpose). The public
``hvd.alltoall`` stays without a gradient, as the JAX package's PyTorch
binding has it.

The router is the caller's (any ``(tokens, n_experts)`` logits);
:func:`load_balance_loss` is the Switch auxiliary loss that keeps routing
uniform.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from horovod_tpu_torch.core import basics
from horovod_tpu_torch.ops import collectives


class _Exchange(torch.autograd.Function):
    """A tiled all-to-all over dim 0 under ``name``; its backward is the
    same exchange of the gradient under ``<name>.grad``."""

    @staticmethod
    def forward(ctx, tensor, name):
        ctx.name = name
        return collectives.alltoall(tensor.contiguous(), name=name)

    @staticmethod
    def backward(ctx, grad):
        return collectives.alltoall(grad.contiguous(),
                                    name=f"{ctx.name}.grad"), None


def switch_moe(x: torch.Tensor, gate_logits: torch.Tensor,
               expert_fn: Callable, expert_params, capacity: int, *,
               name: str = "moe") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE over the world's experts, one a rank.

    ``x``: (tokens, d) this rank's tokens; ``gate_logits``: (tokens,
    world size); ``expert_params``: this rank's expert weights;
    ``expert_fn(params, h) -> h`` is the expert body; ``capacity`` is the
    per-(rank, expert) token budget; ``name`` names the two exchanges, and
    must be the same on every rank and every step.

    Returns ``(y, router_probs)``, where dropped tokens contribute zeros.
    An expert's gradient sums over every rank's tokens it served: under a
    loss averaged over the ranks (the JAX package's ``pmean``), scale it
    by ``1 / size`` (``models/moe.py`` does)."""
    n_exp = basics.size()
    d = x.shape[-1]
    if gate_logits.shape[-1] != n_exp:
        raise ValueError(
            f"router has {gate_logits.shape[-1]} experts but the world has "
            f"{n_exp} ranks; expert parallelism needs one expert a rank")

    probs = torch.softmax(gate_logits.float(), dim=-1)
    expert_idx = probs.argmax(dim=-1)  # (T,)
    gate = probs.gather(-1, expert_idx[:, None])[:, 0]

    # position of each token within its expert's capacity buffer
    onehot = F.one_hot(expert_idx, n_exp)  # (T, E)
    pos_in_expert = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=-1)
    keep = pos_in_expert < capacity

    # pack: (E, C, d) dispatch buffer; dropped tokens add zeros
    safe_pos = torch.where(keep, pos_in_expert, 0)
    dispatch = x.new_zeros(n_exp, capacity, d).index_put(
        (expert_idx, safe_pos), x * keep[:, None].to(x.dtype),
        accumulate=True)

    # route: chunk e of every rank -> rank e; received layout is
    # (source rank, C, d) for this rank's expert
    received = _Exchange.apply(dispatch, f"{name}.dispatch")
    expert_out = expert_fn(expert_params,
                           received.reshape(n_exp * capacity, d))
    expert_out = expert_out.reshape(n_exp, capacity, d)

    # route back: chunk s returns to source rank s
    returned = _Exchange.apply(expert_out, f"{name}.combine")

    # unpack and weight by the gate; dropped tokens stay zero
    y = returned[expert_idx, safe_pos]
    y = y * (gate * keep.to(gate.dtype))[:, None].to(y.dtype)
    return y, probs


def load_balance_loss(probs: torch.Tensor,
                      name: Optional[str] = None) -> torch.Tensor:
    """Switch Transformer auxiliary loss: ``n_exp * sum_e f_e * P_e``,
    minimised (=1) by uniform routing. ``probs``: (tokens, n_experts)
    router softmax. With ``name``, the statistics are averaged over the
    ranks through the differentiable allreduce (``<name>.frac_tokens``,
    ``<name>.frac_probs``), the JAX package's ``pmean`` over the axis."""
    n_exp = probs.shape[-1]
    assignment = F.one_hot(probs.argmax(dim=-1), n_exp).to(probs.dtype)
    frac_tokens = assignment.mean(dim=0)
    frac_probs = probs.mean(dim=0)
    if name is not None:
        frac_tokens = collectives.allreduce(
            frac_tokens, op=collectives.Average, name=f"{name}.frac_tokens")
        frac_probs = collectives.allreduce(
            frac_probs, op=collectives.Average, name=f"{name}.frac_probs")
    return n_exp * (frac_tokens * frac_probs).sum()


def default_capacity(tokens_per_device: int, n_experts: int,
                     capacity_factor: float = 1.25) -> int:
    """Per-(rank, expert) buffer size: even-split load times the safety
    factor, rounded up so the factor's headroom survives small ratios
    (the Switch convention)."""
    return max(1, math.ceil(tokens_per_device * capacity_factor / n_experts))
