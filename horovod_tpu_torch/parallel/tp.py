"""Tensor parallelism: Megatron's layout of the transformer family, with
its collectives written out (port of ``horovod_tpu/parallel/tp.py:38-128``).

The JAX package annotates shardings and lets GSPMD insert the collectives.
Here they are explicit, over the TP axis' process group:

* column-parallel layers (q/k/v, ``mlp.wi``) hold a slice of the output
  features and of the bias; their input passes an operator that is the
  identity forward and an allreduce of the gradient backward;
* row-parallel layers (``attention.out``, ``mlp.wo``) hold a slice of the
  input features; their partial products are summed by an allreduce
  (float32) and the bias, replicated, is added once, after it;
* the token embedding is sharded over the vocab: each rank looks up the
  tokens of its rows (zeros for the others) and an allreduce sums them;
* the tied head multiplies by the local rows and gathers the vocab-sharded
  logits with a differentiable allgather (its backward keeps this rank's
  columns of the replicated gradient);
* everything else is replicated: its inputs and gradients are the same on
  every rank of the group, so it stays in step without a collective.

Each rank runs attention on its ``heads / N`` heads, with the model's
``attention_fn`` or the flash kernels on the card: the JAX package swaps in
:func:`xla_attention` only because a Pallas call does not partition under
pjit (``tp.py:38-49``). Gradients are averaged over ``batch_axis`` only.
A step first checks that the runtime holds no named collective in flight
(``ops/collectives.assert_collective_lane_clear``).
A fused ``qkv`` matches no rule and stays replicated, as in the JAX
package: each rank then runs every head, and the row-parallel output
projection takes this rank's slice of the attention's output.

Usage::

    model = GPT2Small(vocab_size=..., device=...)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    placed, step, batch_group = tp_train_step(
        model, opt, dict(model.named_parameters()),
        transformer_tp_rules("local"), loss_fn=lm_loss, batch_axis="cross")
    loss = step(tokens, tokens)   # this rank's share of the batch
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
)
from horovod_tpu_torch.parallel._util import axis_group, group_rank_size


def xla_attention(q, k, v, causal):
    """The plain attention of the TP models of the JAX package
    (``attention_reference``, float32 scores, autograd's backward). The
    port's TP runs the flash kernels per rank; this is for callers that
    want the JAX package's numerics."""
    return attention_reference(q, k, v, causal=causal)


def transformer_tp_rules(axis="local"):
    """``(pattern, axis, dim)`` rules for the transformer family: a
    parameter whose name fully matches ``pattern`` is sharded over
    ``axis`` along ``dim`` of its torch layout (``(out, in)`` for a
    weight). q/k/v and ``mlp.wi`` are column-parallel (dim 0, their biases
    too), ``attention.out`` and ``mlp.wo`` row-parallel (dim 1), the token
    embedding ``(vocab, d_model)`` is sharded over the vocab; the rest is
    replicated. Default axis: ``local``, as the JAX package's."""
    return [
        (r".*attention\.(query|key|value)\.weight", axis, 0),
        (r".*attention\.(query|key|value)\.bias", axis, 0),
        (r".*attention\.out\.weight", axis, 1),
        (r".*mlp\.wi\.weight", axis, 0),
        (r".*mlp\.wi\.bias", axis, 0),
        (r".*mlp\.wo\.weight", axis, 1),
        (r"(.*\.)?token_embed", axis, 0),
    ]


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter's share on one rank: slice ``index`` of ``parts`` equal
    slices along ``dim``."""

    dim: int
    index: int
    parts: int

    def local(self, t: torch.Tensor) -> torch.Tensor:
        size = t.shape[self.dim]
        if size % self.parts:
            raise ValueError(f"dim {self.dim} of {tuple(t.shape)} does not "
                             f"split into {self.parts} equal slices")
        n = size // self.parts
        return t.narrow(self.dim, self.index * n, n)


def params_shardings(params, group, rules) -> dict:
    """``{name: Shard or None}`` for ``params`` (a name -> tensor mapping,
    ``named_parameters()``'s names): the first rule whose pattern fully
    matches the name shards it over ``group`` (a process group or axis
    name) along the rule's dim; the rest get ``None`` (replicated). The
    rules' own axes are ignored here: ``group`` stands for them, as the
    JAX package's ``mesh`` does."""
    index, parts = group_rank_size(axis_group(group))
    compiled = [(re.compile(pat), dim) for pat, _, dim in rules]
    plan = {}
    for name in params:
        plan[name] = None
        for pat, dim in compiled:
            if pat.fullmatch(name):
                plan[name] = Shard(dim, index, parts)
                break
    return plan


# ---------------------------------------------------------------------------
# Megatron's operators
# ---------------------------------------------------------------------------


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyIn(torch.autograd.Function):
    """Identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """The sum over the group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """The group's slices concatenated along the last dim, in rank order;
    the backward keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        me, n = group_rank_size(group)
        ctx.me, ctx.width = me, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.width
        return grad[..., ctx.me * w:(ctx.me + 1) * w], None


class _Megatron:
    """The transformer's forward under a plan: each layer's attention and
    MLP column- then row-parallel (or replicated), the embedding and head
    over the vocab. Follows ``models/transformer.Transformer.forward``."""

    def __init__(self, model, plan: dict, group):
        self.model, self.plan, self.group = model, plan, group
        self.index, self.parts = group_rank_size(group)
        self.dtype = model.dtype
        names = {id(p): n for n, p in model.named_parameters()}
        self._name = lambda p: names[id(p)]

    def _sharded(self, p, dim: int) -> bool:
        s = self.plan.get(self._name(p))
        if s is not None and s.dim != dim:
            raise ValueError(f"{self._name(p)} is sharded along dim {s.dim}; "
                             f"Megatron's layout shards it along {dim} or "
                             "not at all")
        return s is not None

    def _col(self, x, layers) -> tuple:
        """``x`` through the concatenated ``layers``; ``(y, local)``:
        column-parallel when their weights are sharded (dim 0, with their
        biases), else the replicated product."""
        local = [self._sharded(lyr.weight, 0) for lyr in layers]
        if any(local) != all(local) or any(
                self._sharded(lyr.bias, 0) != s
                for lyr, s in zip(layers, local)):
            raise ValueError("a column-parallel group's weights and biases "
                             "must be sharded together")
        if local[0]:
            x = _CopyIn.apply(x, self.group)
        w = torch.cat([lyr.weight for lyr in layers])
        b = torch.cat([lyr.bias for lyr in layers])
        dt = self.dtype
        return F.linear(x.to(dt), w.to(dt), b.to(dt)), local[0]

    def _row(self, x, x_local: bool, layer):
        dt = self.dtype
        if self._sharded(layer.bias, 0):
            raise ValueError(f"{self._name(layer.bias)}: a row-parallel "
                             "layer's bias is replicated")
        if not self._sharded(layer.weight, 1):
            if x_local:
                raise ValueError(
                    f"{self._name(layer.weight)} is replicated but its "
                    "input is column-parallel: shard it along dim 1")
            return F.linear(x.to(dt), layer.weight.to(dt),
                            layer.bias.to(dt))
        if not x_local:  # a replicated input: this rank's features of it
            w = x.shape[-1] // self.parts
            x = _CopyIn.apply(x, self.group)[..., self.index * w:
                                             (self.index + 1) * w]
        partial = F.linear(x.to(dt), layer.weight.to(dt)).float()
        return (_ReduceOut.apply(partial, self.group)
                + layer.bias.to(dt).float()).to(dt)

    def attention(self, att, x):
        b, s, _ = x.shape
        layers = [att.qkv] if att.fused_qkv else [att.query, att.key,
                                                  att.value]
        qkv, local = self._col(x, layers)
        dh = att.out.weight.shape[0] // att.num_heads
        h = qkv.shape[-1] // (3 * dh)
        q, k, v = (t.contiguous() for t in
                   qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4))
        attn = att.attention_fn or flash_attention
        o = attn(q, k, v, causal=att.causal)
        o = o.transpose(1, 2).reshape(b, s, h * dh)
        return self._row(o, local, att.out)

    def mlp(self, mlp, x):
        h, local = self._col(x, [mlp.wi])
        return self._row(F.gelu(h, approximate="tanh"), local, mlp.wo)

    def layer(self, layer, x):
        x = x + self.attention(layer.attention, layer.ln1(x))
        return x + self.mlp(layer.mlp, layer.ln2(x))

    def __call__(self, token_ids, pos_offset: int = 0):
        m, dt = self.model, self.dtype
        seq = token_ids.shape[1]
        if pos_offset + seq > m.max_seq:
            raise ValueError(f"pos_offset {pos_offset} + seq {seq} exceeds "
                             f"max_seq={m.max_seq}")
        emb = m.token_embed
        if self._sharded(emb, 0):
            rows = emb.shape[0]
            ids = token_ids.long() - self.index * rows
            mine = (ids >= 0) & (ids < rows)
            e = F.embedding(ids.clamp(0, rows - 1), emb) \
                * mine[..., None].to(emb.dtype)
            e = _ReduceOut.apply(e, self.group)
        else:
            e = F.embedding(token_ids, emb)
        x = e.to(dt) + m.pos_embed[pos_offset:pos_offset + seq].to(dt)
        for layer in m.layers:
            if m.remat and torch.is_grad_enabled():
                x = checkpoint(self.layer, layer, x, use_reentrant=False)
            else:
                x = self.layer(layer, x)
        x = m.final_norm(x)
        if not self._sharded(emb, 0):
            return (x @ emb.to(dt).T).float()
        x = _CopyIn.apply(x, self.group)
        return _GatherLast.apply((x @ emb.to(dt).T).float(), self.group)


def _tp_axis(rules):
    axes = {axis for _, axis, _ in rules}
    if len(axes) != 1:
        raise ValueError(f"the rules name the axes {sorted(map(str, axes))};"
                         " tensor parallelism runs over one")
    return axes.pop()


def tp_train_step(model, optimizer, params, rules,
                  loss_fn: Optional[Callable] = None,
                  batch_axis="cross"):
    """A train step with Megatron-sharded parameters.

    ``model`` is a ``models.transformer.Transformer``; ``optimizer`` a
    ``torch.optim`` optimizer over ``model.parameters()`` that has not
    stepped yet, and not one that exchanges gradients itself
    (``DistributedOptimizer`` averages over the world). ``params`` (a name
    -> tensor mapping of the unsharded values, ``named_parameters()``'s
    names) is placed by ``rules`` over their one axis: each parameter of
    the model takes this rank's slice, in place, so the optimizer sees
    the local shapes. ``batch_axis`` is the data-parallel axis the batch
    is split over (``None``: the batch is replicated).

    Returns ``(placed, step, batch_group)``: the model's parameters by
    name, now local; ``step(inputs, labels) -> loss`` with
    ``make_train_step``'s signature (the forward, ``loss_fn(logits,
    labels)``, the backward, the gradients averaged over ``batch_group``,
    the optimizer's step), on this rank's share of the batch, returning the
    loss averaged over ``batch_group``; and the batch's group (``None``
    when replicated)."""
    from horovod_tpu_torch import training

    if getattr(optimizer, "exchanges_gradients", False):
        raise TypeError("tp_train_step averages the gradients over "
                        "batch_axis itself; give it the optimizer that "
                        "DistributedOptimizer wraps")
    for attr in ("layers", "token_embed", "pos_embed", "final_norm"):
        if not hasattr(model, attr):
            raise TypeError("tp_train_step runs the transformer family "
                            "(models.transformer.Transformer)")
    group = axis_group(_tp_axis(rules))
    batch_group = None if batch_axis is None else axis_group(batch_axis)
    plan = params_shardings(params, group, rules)
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = params[name]
            if plan[name] is not None:
                src = plan[name].local(src)
            p.data = src.detach().to(p.device, p.dtype).clone(
                memory_format=torch.contiguous_format)
    forward = _Megatron(model, plan, group)
    loss_fn = loss_fn or training.default_loss_fn
    placed = dict(model.named_parameters())
    n_batch = 1 if batch_group is None else group_rank_size(batch_group)[1]

    def step(inputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        collectives.assert_collective_lane_clear()
        optimizer.zero_grad(set_to_none=True)
        model.train()
        loss = loss_fn(forward(inputs), labels)
        loss.backward()
        loss = loss.detach().float().reshape(1)
        if n_batch > 1:
            # one allreduce: every gradient and the loss, averaged
            grads = [p.grad for p in placed.values() if p.grad is not None]
            flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss])
            dist.all_reduce(flat, group=batch_group)
            flat /= n_batch
            at = 0
            for g in grads:
                g.copy_(flat[at:at + g.numel()].view_as(g))
                at += g.numel()
            loss = flat[at:]
        optimizer.step()
        return loss[0]

    return placed, step, batch_group
