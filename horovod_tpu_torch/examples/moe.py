"""Mixture-of-experts training with expert parallelism on the port (port of
``examples/jax_moe.py``): a Switch-style MoE block whose experts live one a
rank, trained end to end with the load-balance auxiliary loss. Token
routing rides two all-to-alls of the runtime a step (and two in the
backward). The data is synthetic (seeded), so nothing is downloaded.

    python -m horovod_tpu_torch.examples.moe [--steps 50] [--device cpu]

As in the JAX example, the objective is the ranks' mean squared error
averaged over the ranks plus the weighted balance loss: the router's
gradient is averaged by ``DistributedOptimizer``, and this rank's expert,
which every rank's tokens reach, keeps ``1/size`` of its summed gradient.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--tokens-per-device", type=int, default=128)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--aux-weight", type=float, default=0.01)
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    n_exp, rank = hvd.size(), hvd.rank()
    d = args.d_model
    capacity = hvd.default_capacity(args.tokens_per_device, n_exp)

    # every rank draws every expert, as the JAX example does, and keeps
    # its own
    rng = np.random.RandomState(0)
    experts = hvd.stack_stage_params([
        {"wi": torch.from_numpy(rng.randn(d, 4 * d).astype(np.float32)
                                * np.float32(0.1)),
         "wo": torch.from_numpy(rng.randn(4 * d, d).astype(np.float32)
                                * np.float32(0.1))}
        for _ in range(n_exp)])
    mine = {k: v[rank].clone().to(dev).requires_grad_()
            for k, v in experts.items()}
    for p in mine.values():
        p.register_hook(lambda g: g / hvd.size())
    gate = torch.from_numpy(rng.randn(d, n_exp).astype(np.float32)
                            * np.float32(0.1)).to(dev).requires_grad_()

    total = n_exp * args.tokens_per_device
    x_all = rng.randn(total, d).astype(np.float32)
    target_all = np.tanh(rng.randn(total, d)).astype(np.float32)
    rows = slice(rank * args.tokens_per_device,
                 (rank + 1) * args.tokens_per_device)
    x = torch.from_numpy(x_all[rows]).to(dev)
    target = torch.from_numpy(target_all[rows]).to(dev)

    def expert_fn(p, h):
        return F.gelu(h @ p["wi"], approximate="tanh") @ p["wo"]

    opt_gate = hvd.DistributedOptimizer(torch.optim.Adam([gate], lr=args.lr),
                                        named_parameters=[("gate", gate)])
    opt_expert = torch.optim.Adam(list(mine.values()), lr=args.lr)
    for i in range(args.steps):
        opt_gate.zero_grad()
        opt_expert.zero_grad()
        y, probs = hvd.switch_moe(x, x @ gate, expert_fn, mine, capacity,
                                  name="moe")
        mse = hvd.allreduce(((y - target) ** 2).mean(), name="moe.mse")
        aux = hvd.load_balance_loss(probs, name="moe.aux")
        loss = mse + args.aux_weight * aux
        loss.backward()
        opt_gate.step()
        opt_expert.step()
        if rank == 0 and i % 10 == 0:
            print(f"step {i}: loss {loss.item():.4f} "
                  f"({n_exp} experts, capacity {capacity})", flush=True)
    if rank == 0:
        print(f"final loss {loss.item():.4f}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
