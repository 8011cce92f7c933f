"""Mixture-of-experts language model (Switch-style), expert-parallel: port
of ``horovod_tpu/models/moe.py``.

A causal transformer LM whose MLP blocks are Switch MoE layers
(``parallel/ep.switch_moe``) with experts one a rank. Each rank holds its
own token batch; the attention and embedding parameters are replicated
(``MoeLM.shared``: their gradients are averaged over the ranks by
``DistributedOptimizer``), and each rank holds only its own expert's
``wi``/``wo`` (``MoeLM.experts``), which are never averaged.

Gradient scale: the JAX package differentiates ``pmean(lm) + aux_weight *
aux`` over the global parameters. A shared parameter's gradient is then
the mean over the ranks' losses, which a rank's own backward followed by
the average gives. An expert's gradient is ``1/size`` of the sum over the
ranks whose tokens it served, where a rank's own backward gives the sum:
so :class:`MoeLM` scales its experts' gradients by ``1/size`` (a hook on
each expert tensor). Train the experts with a plain optimizer, never
through ``DistributedOptimizer`` or ``make_train_step``, whose average
would mix them.

Numerics are the JAX model's: float32 throughout, LayerNorm with epsilon
1e-6, the tanh GELU (``jax.nn.gelu``'s default), the tied output
projection, the float32 softmax cross-entropy. The attention runs the
port's flash kernels (B1-B6 on the card), which take bfloat16: q, k and v
are cast to bfloat16 at the kernel's door and ``o`` back to float32, on
the CPU as on the card (the JAX model feeds float32 to its kernel).

Weights come from :func:`init_moe_lm`, which draws exactly the JAX
package's ``init_moe_lm`` numbers from the same ``np.random.RandomState``;
``models/convert.moe_from_jax`` carries a JAX tree across.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.core import basics
from horovod_tpu_torch.models.convert import moe_from_jax
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel import ep as ep_mod
from horovod_tpu_torch.utils.device import resolve

LN_EPS = 1e-6


def init_moe_lm(rng: np.random.RandomState, *, vocab_size: int,
                d_model: int, num_layers: int, num_heads: int, d_ff: int,
                n_experts: int, max_seq: int) -> dict:
    """The JAX package's parameter tree, as float32 numpy arrays drawn in
    its order: ``{"shared": {...}, "experts": {"layers": [{"wi", "wo"}
    ...]}}``, each expert leaf with a leading ``n_experts`` axis. Dense
    weights are ``(in, out)``, used as ``x @ w``."""

    def dense(n_in, n_out, scale=None):
        scale = scale or 1.0 / math.sqrt(n_in)
        return rng.randn(n_in, n_out).astype(np.float32) * np.float32(scale)

    def ln():
        return {"scale": np.ones((d_model,), np.float32),
                "bias": np.zeros((d_model,), np.float32)}

    shared = {
        "token_embed": rng.randn(vocab_size, d_model).astype(np.float32)
        * np.float32(0.02),
        "pos_embed": rng.randn(max_seq, d_model).astype(np.float32)
        * np.float32(0.02),
        "layers": [],
    }
    experts = {"layers": []}
    for _ in range(num_layers):
        shared["layers"].append({
            "ln1": ln(), "ln2": ln(),
            "wq": dense(d_model, d_model), "wk": dense(d_model, d_model),
            "wv": dense(d_model, d_model), "wo": dense(d_model, d_model),
            "gate": dense(d_model, n_experts, scale=0.02),
        })
        per_expert = [{"wi": dense(d_model, d_ff), "wo": dense(d_ff, d_model)}
                      for _ in range(n_experts)]
        experts["layers"].append(
            {k: np.stack([e[k] for e in per_expert]) for k in ("wi", "wo")})
    shared["final_ln"] = ln()
    return {"shared": shared, "experts": experts}


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device))


class _LayerNorm(nn.Module):
    def __init__(self, d_model: int, device):
        super().__init__()
        self.scale = _param((d_model,), device)
        self.bias = _param((d_model,), device)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, LN_EPS)


class _SharedLayer(nn.Module):
    def __init__(self, d_model: int, n_experts: int, device):
        super().__init__()
        self.ln1 = _LayerNorm(d_model, device)
        self.ln2 = _LayerNorm(d_model, device)
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param((d_model, d_model), device))
        self.gate = _param((d_model, n_experts), device)


class _Expert(nn.Module):
    def __init__(self, d_model: int, d_ff: int, device):
        super().__init__()
        self.wi = _param((d_model, d_ff), device)
        self.wo = _param((d_ff, d_model), device)


class _Shared(nn.Module):
    def __init__(self, vocab_size, d_model, num_layers, n_experts, max_seq,
                 device):
        super().__init__()
        self.token_embed = _param((vocab_size, d_model), device)
        self.pos_embed = _param((max_seq, d_model), device)
        self.layers = nn.ModuleList(_SharedLayer(d_model, n_experts, device)
                                    for _ in range(num_layers))
        self.final_ln = _LayerNorm(d_model, device)


class _Experts(nn.Module):
    def __init__(self, d_model, d_ff, num_layers, device):
        super().__init__()
        self.layers = nn.ModuleList(_Expert(d_model, d_ff, device)
                                    for _ in range(num_layers))


def _mean_over_ranks(grad: torch.Tensor) -> torch.Tensor:
    return grad / basics.size()


class MoeLM(nn.Module):
    """The MoE LM of this rank: the replicated ``shared`` parameters and
    this rank's expert of each layer (``experts``). ``n_experts`` defaults
    to the world size; ``rank`` (default this process's) picks the expert.
    Parameters are made on ``device`` (default: the card) from ``seed``:
    the JAX package's ``init_moe_lm(np.random.RandomState(seed), ...)``.
    State-dict keys are the JAX tree's paths joined with dots
    (``shared.layers.0.wq``, ``experts.layers.0.wi``)."""

    def __init__(self, vocab_size: int, d_model: int, num_layers: int,
                 num_heads: int, d_ff: int, max_seq: int,
                 n_experts: Optional[int] = None, device=None, seed: int = 0,
                 rank: Optional[int] = None):
        super().__init__()
        device = resolve(device)
        if d_model % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide d_model "
                             f"({d_model})")
        n_experts = basics.size() if n_experts is None else n_experts
        rank = basics.rank() if rank is None else rank
        if not 0 <= rank < n_experts:
            raise ValueError(f"rank {rank} holds no expert of {n_experts}")
        self.num_heads, self.n_experts = num_heads, n_experts
        self.shared = _Shared(vocab_size, d_model, num_layers, n_experts,
                              max_seq, device)
        self.experts = _Experts(d_model, d_ff, num_layers, device)
        for p in self.experts.parameters():
            p.register_hook(_mean_over_ranks)
        if device.type != "meta":
            tree = init_moe_lm(np.random.RandomState(seed),
                               vocab_size=vocab_size, d_model=d_model,
                               num_layers=num_layers, num_heads=num_heads,
                               d_ff=d_ff, n_experts=n_experts,
                               max_seq=max_seq)
            self.load_state_dict(moe_from_jax(tree, rank))

    def forward(self, tokens: torch.Tensor, capacity: int):
        """``(logits, aux)``: see :func:`apply_moe_lm`."""
        return apply_moe_lm(self, tokens, capacity)


def _attention(lp: _SharedLayer, x: torch.Tensor, num_heads: int):
    b, s, d = x.shape
    hd = d // num_heads

    def heads(w):  # bfloat16 at the kernel's door
        return (x @ w).reshape(b, s, num_heads, hd).transpose(1, 2) \
            .to(torch.bfloat16).contiguous()

    o = flash_attention(heads(lp.wq), heads(lp.wk), heads(lp.wv),
                        causal=True).float()
    return o.transpose(1, 2).reshape(b, s, d) @ lp.wo


def _expert_fn(p: _Expert, h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h @ p.wi, approximate="tanh") @ p.wo


def apply_moe_lm(model: MoeLM, tokens: torch.Tensor,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass of this rank's ``(batch, seq)`` tokens: float32
    ``(batch, seq, vocab)`` logits and the mean auxiliary load-balance
    loss over the layers. Layer ``i``'s exchanges are named ``moe.l<i>``
    (``.dispatch``, ``.combine``) and its balance statistics
    ``moe.l<i>.aux``."""
    shared = model.shared
    b, s = tokens.shape
    x = shared.token_embed[tokens.long()] + shared.pos_embed[None, :s, :]

    aux_total = 0.0
    for i, (lp, xp) in enumerate(zip(shared.layers, model.experts.layers)):
        x = x + _attention(lp, lp.ln1(x), model.num_heads)
        h = lp.ln2(x)
        flat = h.reshape(b * s, -1)
        y, probs = ep_mod.switch_moe(flat, flat @ lp.gate, _expert_fn, xp,
                                     capacity, name=f"moe.l{i}")
        aux_total = aux_total + ep_mod.load_balance_loss(
            probs, name=f"moe.l{i}.aux")
        x = x + y.reshape(b, s, -1)

    x = shared.final_ln(x)
    logits = x @ shared.token_embed.T
    return logits, aux_total / len(shared.layers)


def moe_lm_loss(model: MoeLM, tokens: torch.Tensor, capacity: int, *,
                aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token loss averaged over the ranks (``moe.lm``, the
    differentiable allreduce) plus ``aux_weight`` times the balance
    loss: the JAX package's ``pmean(lm) + aux_weight * aux``."""
    logits, aux = apply_moe_lm(model, tokens, capacity)
    lm = F.cross_entropy(logits[:, :-1].flatten(0, 1),
                         tokens[:, 1:].long().flatten())
    return (collectives.allreduce(lm, op=collectives.Average, name="moe.lm")
            + aux_weight * aux)
