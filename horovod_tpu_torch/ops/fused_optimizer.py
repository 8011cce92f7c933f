"""AdamW over a flat ZeRO-1 master/moment shard in one Hopper kernel.

Port of ``horovod_tpu/ops/pallas/fused_optimizer.py``: one pass over the
whole flat float32 master/mu/nu shard of a dtype group
(``parallel/zero.py``), reading the reduced gradient shard in any float
dtype and emitting the updated parameters in the parameter dtype (fp32
master weights for bf16 training). Same math as
:mod:`horovod_tpu_torch.ops.fused_adamw`, on ``csrc/adamw.cu``
``flat_adamw_kernel``.

Departures from the JAX package:

* master, mu and nu are updated in place and returned; only ``p`` is a
  new tensor. For BERT-Large's padded world-1 shard (536,870,912
  elements) that saves a second 6.4 GB copy of the three buffers on the
  card;
* there is no size gating: the kernel masks its own ragged tail;
* ``HOROVOD_SHARDED_FUSED_KERNEL`` is not read. On the TPU it chooses jnp
  over the kernel; on the card that would be a fallback hiding the kernel.

The plain PyTorch version (:func:`flat_adamw_reference`, written from
``_jnp_flat``) runs only for tensors on the CPU; for CUDA tensors the
wrapper launches the kernel or raises. :data:`LAUNCHES` counts launches.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.ops import fused_adamw as _fa
from horovod_tpu_torch.ops import kernel_build

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flat_adamw": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flat_adamw_reference(master, mu, nu, grad, scalars, eps, out_dtype):
    """Plain AdamW over a flat shard (``_jnp_flat``): new
    ``(p[out_dtype], master, mu, nu)``."""
    b1, b2, ibc1, ibc2, lr, wd, eps = _fa.scalar_tensors(scalars, eps)
    gf = grad.float()
    m2 = b1 * mu + (1 - b1) * gf
    v2 = b2 * nu + (1 - b2) * gf * gf
    w2 = master - lr * ((m2 * ibc1) / (torch.sqrt(v2 * ibc2) + eps)
                        + wd * master)
    return w2.to(out_dtype), w2, m2, v2


def _check(master, mu, nu, grad) -> None:
    for name, t in (("master", master), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32 or t.ndim != 1:
            raise ValueError(f"flat_adamw_shard: {name} must be a 1-D "
                             f"float32 shard, got {t.dtype} {tuple(t.shape)}")
    if not master.shape == mu.shape == nu.shape == grad.shape:
        raise ValueError(f"flat_adamw_shard: lengths differ: master "
                         f"{tuple(master.shape)}, mu {tuple(mu.shape)}, nu "
                         f"{tuple(nu.shape)}, grad {tuple(grad.shape)}")
    if not grad.is_floating_point():
        raise TypeError(f"flat_adamw_shard: grad must be a float tensor, "
                        f"got {grad.dtype}")


@torch.no_grad()
def flat_adamw_shard(master: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, grad: torch.Tensor, scalars, *,
                     eps: float, out_dtype: torch.dtype):
    """One AdamW pass over a flat float32 master shard.

    ``master``/``mu``/``nu`` are 1-D float32, ``grad`` the reduced gradient
    shard of the same length in any float dtype, ``scalars`` the float32
    6-vector ``[b1, b2, 1/(1-b1^t), 1/(1-b2^t), lr, wd]``
    (:func:`horovod_tpu_torch.ops.fused_adamw.adamw_scalars`). Updates
    master, mu and nu in place and returns ``(p[out_dtype], master, mu,
    nu)`` with ``p`` a new tensor."""
    _check(master, mu, nu, grad)
    if kernel_build.on_cpu("flat_adamw_shard", (master, mu, nu, grad)):
        p, w2, m2, v2 = flat_adamw_reference(master, mu, nu, grad, scalars,
                                             eps, out_dtype)
        master.copy_(w2)
        mu.copy_(m2)
        nu.copy_(v2)
        return p, master, mu, nu
    for t in (master, mu, nu, grad):
        _fa.check_kernel_tensor("flat_adamw", t)
    if out_dtype not in _fa.DTYPE_CODES:
        raise TypeError(f"flat_adamw kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")
    n = master.numel()
    if n == 0:
        return master.new_empty(0, dtype=out_dtype), master, mu, nu
    lib = _fa.lib()
    p = torch.empty(n, dtype=out_dtype, device=master.device)
    err = lib.hvd_flat_adamw(
        master.data_ptr(), mu.data_ptr(), nu.data_ptr(), grad.data_ptr(),
        p.data_ptr(), n, _fa.DTYPE_CODES[grad.dtype],
        _fa.DTYPE_CODES[out_dtype], *(float(x) for x in scalars), float(eps),
        torch.cuda.current_stream(master.device).cuda_stream)
    kernel_build.check_error(lib, err, "flat adamw")
    LAUNCHES["flat_adamw"] += 1
    return p, master, mu, nu
