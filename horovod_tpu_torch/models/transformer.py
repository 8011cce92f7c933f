"""Transformer model family in PyTorch: BERT-style encoders and GPT-style
causal decoders, training path.

Port of ``horovod_tpu/models/transformer.py`` (``SelfAttention``'s
non-decode branch, ``Mlp``, ``TransformerLayer``, ``Transformer``, the
model constructors and the losses). Numerics follow the flax modules:

* parameters are float32, compute is ``dtype`` (bfloat16 by default): each
  dense layer casts its input, kernel and bias to ``dtype``, as
  ``nn.Dense(dtype=bf16, param_dtype=f32)`` does;
* LayerNorm uses flax's epsilon 1e-6 and normalises in float32;
* GELU is the tanh approximation (flax ``nn.gelu`` default);
* the output projection is tied to the token embedding, and the gathered
  MLM head casts the embedding to ``dtype`` (``:387``, ``:433``);
* attention runs :func:`horovod_tpu_torch.ops.flash_attention` (the Hopper
  kernels on the card, the plain version on the CPU; ``FLASH_FUSED_BWD=1``
  sends its backward to the fused kernel);
* :func:`causal_lm_loss_chunked` projects the vocab a chunk of positions at
  a time under ``torch.utils.checkpoint``, as the JAX package's
  ``jax.checkpoint`` scan does.

The KV-cache ``decode``/``paged`` serving branches are not ported yet.
Weights carry across from the JAX package with ``models/convert.py``.
"""

from __future__ import annotations

import math
from functools import partial
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.utils.device import resolve

LN_EPS = 1e-6  # flax nn.LayerNorm default


def _dense(x, layer: nn.Linear, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense init: truncated normal (2 std) with variance
    1/fan_in, fan_in = the contracted width (``Linear.in_features``)."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm: eps 1e-6, statistics and scale in float32, output in
    ``dtype``."""

    def __init__(self, d_model, dtype=torch.bfloat16, device=None):
        super().__init__(d_model, eps=LN_EPS, device=device)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention on the flash kernels."""

    def __init__(self, d_model: int, num_heads: int, causal: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide d_model "
                             f"({d_model})")
        self.num_heads, self.causal, self.dtype = num_heads, causal, dtype
        self.query = nn.Linear(d_model, d_model, device=device)
        self.key = nn.Linear(d_model, d_model, device=device)
        self.value = nn.Linear(d_model, d_model, device=device)
        self.out = nn.Linear(d_model, d_model, device=device)

    def forward(self, x):
        b, s, d = x.shape
        h = self.num_heads
        # one (d, 3d) product for q, k and v; the parameters stay separate
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
        bias = torch.cat([self.query.bias, self.key.bias, self.value.bias])
        qkv = F.linear(x.to(self.dtype), w.to(self.dtype), bias.to(self.dtype))
        # (b, s, 3, h, dh) -> 3 x (b, h, s, dh)
        q, k, v = (t.contiguous() for t in
                   qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4))
        o = flash_attention(q, k, v, causal=self.causal)
        o = o.transpose(1, 2).reshape(b, s, d)
        return _dense(o, self.out, self.dtype)


class Mlp(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.wi = nn.Linear(d_model, d_ff, device=device)
        self.wo = nn.Linear(d_ff, d_model, device=device)

    def forward(self, x):
        h = F.gelu(_dense(x, self.wi, self.dtype), approximate="tanh")
        return _dense(h, self.wo, self.dtype)


class TransformerLayer(nn.Module):
    """Pre-LayerNorm block: x + Attn(LN(x)); x + MLP(LN(x))."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 causal: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model, dtype, device)
        self.attention = SelfAttention(d_model, num_heads, causal, dtype,
                                       device)
        self.ln2 = LayerNorm(d_model, dtype, device)
        self.mlp = Mlp(d_model, d_ff, dtype, device)

    def forward(self, x):
        x = x + self.attention(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class Transformer(nn.Module):
    """Embeddings -> N layers -> final LayerNorm -> tied logits.

    ``causal=True`` makes a GPT-style decoder, ``causal=False`` a BERT-style
    encoder. Parameters are made on ``device`` (default: the card, see
    :func:`horovod_tpu_torch.utils.device.resolve`) from ``seed`` with
    flax's initialisers (normal(0.02) embeddings, LeCun-normal dense
    kernels)."""

    def __init__(self, vocab_size: int, d_model: int = 768,
                 num_layers: int = 12, num_heads: int = 12, d_ff: int = 3072,
                 max_seq: int = 512, causal: bool = False,
                 dtype=torch.bfloat16, device=None, seed: int = 0):
        super().__init__()
        device = resolve(device)
        self.vocab_size, self.max_seq, self.dtype = vocab_size, max_seq, dtype
        self.token_embed = nn.Parameter(
            torch.empty(vocab_size, d_model, device=device))
        self.pos_embed = nn.Parameter(torch.empty(max_seq, d_model,
                                                  device=device))
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, num_heads, d_ff, causal, dtype, device)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model, dtype, device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        if self.token_embed.is_meta:  # shapes only, no values to draw
            return
        gen = torch.Generator(self.token_embed.device).manual_seed(seed)
        self.token_embed.normal_(0.0, 0.02, generator=gen)
        self.pos_embed.normal_(0.0, 0.02, generator=gen)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, token_ids: torch.Tensor, pos_offset: int = 0,
                output: str = "logits") -> torch.Tensor:
        """``pos_offset`` is the global position of the first token.
        ``output="hidden"`` returns the final-norm hidden states
        (batch, seq, d_model) without the vocab projection, for
        :func:`masked_lm_loss_gathered`; ``"logits"`` returns float32
        (batch, seq, vocab) logits."""
        if token_ids.ndim != 2:
            raise ValueError("expected (batch, seq) int token ids")
        seq = token_ids.shape[1]
        if pos_offset + seq > self.max_seq:
            raise ValueError(f"pos_offset {pos_offset} + seq {seq} exceeds "
                             f"max_seq={self.max_seq}")
        x = (F.embedding(token_ids, self.token_embed).to(self.dtype)
             + self.pos_embed[pos_offset:pos_offset + seq].to(self.dtype))
        for layer in self.layers:
            x = layer(x)
        x = self.final_norm(x)
        if output == "hidden":
            return x
        return (x @ self.token_embed.to(self.dtype).T).float()


# BERT family (bidirectional encoders; BERT-Large: 24 layers, hidden 1024,
# 16 heads).
BertBase = partial(Transformer, d_model=768, num_layers=12, num_heads=12,
                   d_ff=3072, causal=False)
BertLarge = partial(Transformer, d_model=1024, num_layers=24, num_heads=16,
                    d_ff=4096, causal=False)

# GPT family (causal decoders).
GPT2Small = partial(Transformer, d_model=768, num_layers=12, num_heads=12,
                    d_ff=3072, max_seq=1024, causal=True)
GPT2Medium = partial(Transformer, d_model=1024, num_layers=24, num_heads=16,
                     d_ff=4096, max_seq=1024, causal=True)


def _cross_entropy(logits, labels):
    return F.cross_entropy(logits.flatten(0, -2), labels.long().flatten(),
                           reduction="none").view(labels.shape)


def masked_lm_loss(logits, labels, mask):
    """BERT MLM objective: mean cross-entropy over masked positions only."""
    loss = _cross_entropy(logits, labels)
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / mask.sum().clamp(min=1.0)


def masked_lm_loss_gathered(hidden, embed_matrix, positions, labels,
                            weights=None):
    """MLM objective over a fixed set of masked positions, with the tied
    vocab projection applied after gathering them, so the (batch, seq,
    vocab) logits never exist. ``positions``/``labels``/``weights`` are
    (batch, M); ``weights=None`` counts every prediction."""
    idx = positions.long()[..., None].expand(-1, -1, hidden.shape[-1])
    gathered = torch.gather(hidden, 1, idx)
    logits = (gathered @ embed_matrix.to(gathered.dtype).T).float()
    loss = _cross_entropy(logits, labels)
    if weights is None:
        return loss.mean()
    w = weights.to(loss.dtype)
    return (loss * w).sum() / w.sum().clamp(min=1.0)


def causal_lm_loss(logits, token_ids):
    """Next-token prediction: shift-by-one cross-entropy."""
    return _cross_entropy(logits[:, :-1], token_ids[:, 1:]).mean()


def _chunk_loss(hidden, emb, labels, weights):
    logits = (hidden @ emb.T).float()
    return (_cross_entropy(logits, labels) * weights).sum()


def causal_lm_loss_chunked(hidden, embed_matrix, token_ids, chunk: int = 128):
    """Next-token cross-entropy ``chunk`` positions at a time, the tied vocab
    projection inside the loop, so the (batch, seq, vocab) float32 logits
    never exist. Each chunk runs under ``torch.utils.checkpoint``: its
    logits are recomputed in the backward instead of kept. Equals
    :func:`causal_lm_loss` of the full logits up to float32 summation order.
    ``hidden`` (batch, seq, d) from ``model(..., output="hidden")``,
    ``embed_matrix`` the tied (vocab, d) embedding, ``token_ids`` (batch,
    seq); ``chunk`` must divide seq."""
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"chunk ({chunk}) must divide seq ({s})")
    emb = embed_matrix.to(hidden.dtype)
    # position i predicts token i+1; the last position is weighted 0 so
    # every chunk is alike
    labels = torch.cat([token_ids[:, 1:], token_ids.new_zeros(b, 1)], dim=1)
    weights = torch.ones(b, s, device=hidden.device)
    weights[:, -1] = 0.0
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        c = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_loss, hidden[:, c], emb,
                                   labels[:, c], weights[:, c],
                                   use_reentrant=False)
    return total / (b * (s - 1))


def sample_masked_positions(rng: np.random.Generator, batch: int, seq: int,
                            num_predictions: int) -> np.ndarray:
    """Per row, ``num_predictions`` distinct positions, sorted: an int32
    (batch, M) array (BERT's ``max_predictions_per_seq`` layout)."""
    pos = np.stack([rng.choice(seq, size=num_predictions, replace=False)
                    for _ in range(batch)])
    return np.sort(pos, axis=1).astype(np.int32)


def random_tokens(rng: np.random.Generator, batch: int, seq: int,
                  vocab_size: int) -> np.ndarray:
    """Synthetic token batch for benchmarks (uniform vocab draw)."""
    return rng.integers(0, vocab_size, size=(batch, seq), dtype=np.int32)
