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
  sends its backward to the fused kernel), or the model's ``attention_fn``
  (``:98, 248, 289``), called as ``attention_fn(q, k, v, causal=...)`` on
  (batch, heads, seq, head_dim): ``ring_attention`` or
  ``ulysses_attention`` over a sequence sharded on the ranks, with
  ``pos_offset`` giving each rank its shard's global position;
* :func:`causal_lm_loss_chunked` projects the vocab a chunk of positions at
  a time under ``torch.utils.checkpoint``, as the JAX package's
  ``jax.checkpoint`` scan does;
* the options ``fused_qkv`` (one ``qkv`` projection, ``:99, 118-126``) and
  ``remat`` (each layer under ``torch.utils.checkpoint``, ``:288,
  374-375``) are the JAX model's; under ``remat`` the backward runs each
  layer's forward again, so the flash forward launches twice a layer a
  step.

The serving branches (``:37-62, 131-201, 257-266, 328-354``) are the same
modules and parameters run with per-row ``positions`` and a :class:`KVCache`
that the caller (``serve/kv_cache.py``, ``serve/paging.py``) owns, instead
of flax's ``clone(decode=True)`` and its mutable ``cache`` collection: the
new tokens' keys and values are written into the cache in place
(``index_put_``), so a decode step's tensors keep their storage from step
to step (the engine captures the step once as a CUDA graph), and attention
runs :func:`cached_attention`, plain PyTorch as the JAX package's is plain
XLA. A dense cache holds ``(slots, max_seq, heads, head_dim)`` per layer,
its batch rows the input's rows; a paged one ``(pages, page_tokens, heads,
head_dim)``, read and written through a per-row ``page_table``.

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
NEG_INF = float("-inf")  # the JAX package's flash_attention.NEG_INF


def cached_attention(q, k, v, q_positions):
    """Masked attention against an absolute-position KV cache
    (``horovod_tpu/models/transformer.py:37-62``).

    ``q``: (batch, heads, new, head_dim), the new tokens' queries;
    ``k``/``v``: (batch, heads, cache_len, head_dim), the whole cache of
    each row, freshly written and stale rows alike; ``q_positions``:
    (batch, new) absolute position of each query. Key ``i`` is attendable
    by a query at position ``p`` only when ``i <= p``: stale rows of an
    earlier occupant and padded prefill rows sit at positions the request
    has not reached, and decode overwrites each before a query reaches it.
    The scores are taken in ``q``'s dtype, then scaled and softmaxed in
    float32; the probabilities go back to ``v``'s dtype for the second
    product."""
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    key_ids = torch.arange(k.shape[2], device=q.device)
    mask = key_ids[None, None, None, :] <= q_positions[:, None, :, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


class KVCache:
    """Per-layer key and value tensors of the serving path, owned by an
    engine and written in place by :meth:`Transformer.forward`.

    Dense (:meth:`dense`): ``(slots, max_seq, heads, head_dim)`` a layer,
    batch row ``b`` of the input reading and writing cache row ``b``;
    :meth:`rows` narrows every tensor to some rows (a prefill's slot).
    Paged (:meth:`paged`): ``(pages, page_tokens, heads, head_dim)`` a
    layer, reached through the forward's ``page_table``."""

    def __init__(self, k: list, v: list, paged: bool = False):
        self.k, self.v, self.paged = k, v, paged

    @classmethod
    def _make(cls, model, rows: int, tokens: int, paged: bool):
        attn = model.layers[0].attention
        shape = (rows, tokens, attn.num_heads,
                 model.token_embed.shape[1] // attn.num_heads)
        dev = model.token_embed.device
        n = len(model.layers)
        return cls([torch.zeros(shape, dtype=model.dtype, device=dev)
                    for _ in range(n)],
                   [torch.zeros(shape, dtype=model.dtype, device=dev)
                    for _ in range(n)], paged)

    @classmethod
    def dense(cls, model, slots: int) -> "KVCache":
        return cls._make(model, slots, model.max_seq, False)

    @classmethod
    def paged(cls, model, pages: int, page_tokens: int) -> "KVCache":
        return cls._make(model, pages, page_tokens, True)

    def rows(self, start: int, n: int = 1) -> "KVCache":
        """Views of rows ``start:start + n`` of every tensor (dense)."""
        return KVCache([t.narrow(0, start, n) for t in self.k],
                       [t.narrow(0, start, n) for t in self.v])

    def zero_(self) -> "KVCache":
        for t in self.k + self.v:
            t.zero_()
        return self

    def copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` onto page ``dst`` in every layer (paged)."""
        for t in self.k + self.v:
            t[dst].copy_(t[src])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.k + self.v)


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
    """Multi-head self-attention on the flash kernels.

    ``fused_qkv=True`` holds one ``qkv`` projection of ``3 * d_model``
    outputs, ordered (3, heads, head_dim) as the JAX package's ``qkv``
    ``DenseGeneral`` (``(d, 3, heads, head_dim)``) orders them; else
    ``query``, ``key`` and ``value``, concatenated for the one product.
    ``attention_fn(q, k, v, causal=...)`` replaces ``flash_attention``
    when given (it holds no parameters)."""

    def __init__(self, d_model: int, num_heads: int, causal: bool = False,
                 dtype=torch.bfloat16, device=None, fused_qkv: bool = False,
                 attention_fn=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide d_model "
                             f"({d_model})")
        self.num_heads, self.causal, self.dtype = num_heads, causal, dtype
        self.fused_qkv = fused_qkv
        self.attention_fn = attention_fn
        if fused_qkv:
            self.qkv = nn.Linear(d_model, 3 * d_model, device=device)
        else:
            self.query = nn.Linear(d_model, d_model, device=device)
            self.key = nn.Linear(d_model, d_model, device=device)
            self.value = nn.Linear(d_model, d_model, device=device)
        self.out = nn.Linear(d_model, d_model, device=device)

    def forward(self, x, positions=None, kv=None, page_table=None):
        """``kv`` (this layer's ``(k, v)`` cache tensors) selects the
        serving path: the new tokens sit at ``positions`` (batch,) onward,
        their keys and values go into the cache and attention runs
        against the whole cache (:func:`cached_attention`)."""
        b, s, d = x.shape
        h = self.num_heads
        if self.fused_qkv:
            qkv = _dense(x, self.qkv, self.dtype)
        else:  # one (d, 3d) product; the parameters stay separate
            w = torch.cat([self.query.weight, self.key.weight,
                           self.value.weight])
            bias = torch.cat([self.query.bias, self.key.bias,
                              self.value.bias])
            qkv = F.linear(x.to(self.dtype), w.to(self.dtype),
                           bias.to(self.dtype))
        if kv is not None:
            o = self._cached(qkv.view(b, s, 3, h, d // h), positions, kv,
                             page_table)
            return _dense(o.reshape(b, s, d), self.out, self.dtype)
        # (b, s, 3, h, dh) -> 3 x (b, h, s, dh)
        q, k, v = (t.contiguous() for t in
                   qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4))
        attn = self.attention_fn or flash_attention
        o = attn(q, k, v, causal=self.causal)
        o = o.transpose(1, 2).reshape(b, s, d)
        return _dense(o, self.out, self.dtype)

    def _cached(self, qkv, positions, kv, page_table):
        """The decode branches (``horovod_tpu/models/transformer.py:
        131-201``): write this step's keys and values into the cache at
        their absolute positions, then attend over the row's whole cache.
        ``qkv`` is (b, new, 3, heads, head_dim); returns (b, new, heads,
        head_dim)."""
        cache_k, cache_v = kv
        b, new = qkv.shape[:2]
        q, k, v = qkv.unbind(2)
        abs_pos = (positions.long()[:, None]
                   + torch.arange(new, device=qkv.device))
        if page_table is None:
            # dense: batch row i is cache row i
            rows = torch.arange(b, device=qkv.device)[:, None].expand(b, new)
            idx = (rows, abs_pos)
            cache_k.index_put_(idx, k.to(cache_k.dtype))
            cache_v.index_put_(idx, v.to(cache_v.dtype))
            k_all, v_all = cache_k, cache_v
        else:
            T = cache_k.shape[1]
            table = page_table.long()
            width = table.shape[1]
            # positions past the mapped table (padded prefill garbage)
            # clamp onto the trailing scratch column
            blk = torch.clamp(abs_pos // T, max=width - 1)
            idx = (torch.gather(table, 1, blk), abs_pos % T)
            cache_k.index_put_(idx, k.to(cache_k.dtype))
            cache_v.index_put_(idx, v.to(cache_v.dtype))
            # the row's pages, flattened: key index i is absolute
            # position i, so the dense mask holds unchanged
            k_all = cache_k[table].flatten(1, 2)
            v_all = cache_v[table].flatten(1, 2)
        o = cached_attention(q.transpose(1, 2), k_all.transpose(1, 2),
                             v_all.transpose(1, 2), abs_pos)
        return o.transpose(1, 2)


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
                 causal: bool = False, dtype=torch.bfloat16, device=None,
                 fused_qkv: bool = False, attention_fn=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model, dtype, device)
        self.attention = SelfAttention(d_model, num_heads, causal, dtype,
                                       device, fused_qkv, attention_fn)
        self.ln2 = LayerNorm(d_model, dtype, device)
        self.mlp = Mlp(d_model, d_ff, dtype, device)

    def forward(self, x, positions=None, kv=None, page_table=None):
        x = x + self.attention(self.ln1(x), positions, kv, page_table)
        return x + self.mlp(self.ln2(x))


class Transformer(nn.Module):
    """Embeddings -> N layers -> final LayerNorm -> tied logits.

    ``causal=True`` makes a GPT-style decoder, ``causal=False`` a BERT-style
    encoder. Parameters are made on ``device`` (default: the card, see
    :func:`horovod_tpu_torch.utils.device.resolve`) from ``seed`` with
    flax's initialisers (normal(0.02) embeddings, LeCun-normal dense
    kernels).

    ``fused_qkv`` gives each attention one ``qkv`` projection (see
    :class:`SelfAttention`; :func:`fuse_qkv_state` carries an unfused
    model's weights across). ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (the JAX package's ``nn.remat``): the
    backward recomputes the layer's forward, the flash forward included,
    instead of keeping its activations. ``attention_fn`` goes to every
    layer's :class:`SelfAttention`."""

    def __init__(self, vocab_size: int, d_model: int = 768,
                 num_layers: int = 12, num_heads: int = 12, d_ff: int = 3072,
                 max_seq: int = 512, causal: bool = False,
                 dtype=torch.bfloat16, device=None, seed: int = 0,
                 remat: bool = False, fused_qkv: bool = False,
                 attention_fn=None):
        super().__init__()
        device = resolve(device)
        self.vocab_size, self.max_seq, self.dtype = vocab_size, max_seq, dtype
        self.remat = remat
        self.token_embed = nn.Parameter(
            torch.empty(vocab_size, d_model, device=device))
        self.pos_embed = nn.Parameter(torch.empty(max_seq, d_model,
                                                  device=device))
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, num_heads, d_ff, causal, dtype, device,
                             fused_qkv, attention_fn)
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
                output: str = "logits", positions=None,
                cache: "KVCache | None" = None,
                page_table=None) -> torch.Tensor:
        """``pos_offset`` is the global position of the first token.
        ``output="hidden"`` returns the final-norm hidden states
        (batch, seq, d_model) without the vocab projection, for
        :func:`masked_lm_loss_gathered`; ``"logits"`` returns float32
        (batch, seq, vocab) logits.

        ``cache`` selects the serving path (``:328-354``): each batch row
        starts at its own absolute position, ``positions`` (batch,); its
        position embeddings are gathered per row (clamped at ``max_seq -
        1``), and every layer writes and attends its cache (a paged cache
        through ``page_table``, (batch, blocks) page ids)."""
        if token_ids.ndim != 2:
            raise ValueError("expected (batch, seq) int token ids")
        seq = token_ids.shape[1]
        if cache is not None:
            return self._decode(token_ids, positions, cache, page_table,
                                output)
        if pos_offset + seq > self.max_seq:
            raise ValueError(f"pos_offset {pos_offset} + seq {seq} exceeds "
                             f"max_seq={self.max_seq}")
        x = (F.embedding(token_ids, self.token_embed).to(self.dtype)
             + self.pos_embed[pos_offset:pos_offset + seq].to(self.dtype))
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        x = self.final_norm(x)
        if output == "hidden":
            return x
        return (x @ self.token_embed.to(self.dtype).T).float()

    def _decode(self, token_ids, positions, cache, page_table, output):
        if positions is None:
            raise ValueError("the serving path needs per-row positions")
        if cache.paged != (page_table is not None):
            raise ValueError("a paged cache needs a page_table, a dense "
                             "one none")
        seq = token_ids.shape[1]
        pos_idx = torch.clamp(
            positions.long()[:, None]
            + torch.arange(seq, device=token_ids.device),
            max=self.max_seq - 1)
        x = (F.embedding(token_ids, self.token_embed).to(self.dtype)
             + self.pos_embed[pos_idx].to(self.dtype))
        for layer, k, v in zip(self.layers, cache.k, cache.v):
            x = layer(x, positions, (k, v), page_table)
        x = self.final_norm(x)
        if output == "hidden":
            return x
        return (x @ self.token_embed.to(self.dtype).T).float()


def fuse_qkv_state(state: dict) -> dict:
    """An unfused model's state dict as a ``fused_qkv=True`` model's: each
    layer's ``query``, ``key`` and ``value`` weights and biases,
    concatenated in that order, become its ``qkv`` (the other entries stay
    as they are)."""
    out = {}
    for key, t in state.items():
        head, _, leaf = key.rpartition(".")
        prefix, _, name = head.rpartition(".")
        if name == "query":
            out[f"{prefix}.qkv.{leaf}"] = torch.cat(
                [state[f"{prefix}.{n}.{leaf}"]
                 for n in ("query", "key", "value")])
        elif name not in ("key", "value") or not prefix.endswith("attention"):
            out[key] = t
    return out


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
