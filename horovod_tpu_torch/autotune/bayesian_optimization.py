"""Bayesian optimization with Expected Improvement (a copy of
``horovod_tpu/autotune/bayesian_optimization.py``: numpy and scipy only, so
the port keeps its own; given the same samples and seed both give the same
bits).

The reference's BO (reference:
horovod/common/optim/bayesian_optimization.cc:34-80): an Expected
Improvement acquisition over the GP posterior, maximized by multi-restart
gradient optimization (the reference uses vendored L-BFGS; here
scipy.optimize L-BFGS-B, which is the same algorithm).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy import optimize
from scipy.stats import norm

from horovod_tpu_torch.autotune.gaussian_process import GaussianProcessRegressor


class BayesianOptimization:
    """Maximizes an unknown f over a box via EI (reference:
    bayesian_optimization.h — NextSample/AddSample surface)."""

    def __init__(self, bounds, alpha: float = 1e-8, xi: float = 0.01,
                 n_restarts: int = 16, seed: int = 0):
        self.bounds = np.asarray(bounds, dtype=np.float64)  # (d, 2)
        assert self.bounds.ndim == 2 and self.bounds.shape[1] == 2
        self.dim = len(self.bounds)
        self.xi = xi
        self.n_restarts = n_restarts
        self._gp = GaussianProcessRegressor(alpha=alpha)
        self._X: List[np.ndarray] = []
        self._y: List[float] = []
        self._rng = np.random.RandomState(seed)

    # -- sample bookkeeping -------------------------------------------------
    def add_sample(self, x, y: float) -> None:
        self._X.append(np.asarray(x, dtype=np.float64).ravel())
        self._y.append(float(y))

    @property
    def n_samples(self) -> int:
        return len(self._X)

    def best(self) -> Optional[tuple]:
        if not self._y:
            return None
        i = int(np.argmax(self._y))
        return self._X[i], self._y[i]

    # -- normalized coordinates (unit box) ----------------------------------
    def _to_unit(self, x: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (x - lo) / np.maximum(hi - lo, 1e-12)

    def _from_unit(self, u: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + u * (hi - lo)

    def _expected_improvement(self, U: np.ndarray, f_best: float
                              ) -> np.ndarray:
        mu, sigma = self._gp.predict(U)
        imp = mu - f_best - self.xi
        z = imp / sigma
        return imp * norm.cdf(z) + sigma * norm.pdf(z)

    def next_sample(self) -> np.ndarray:
        """Next point to evaluate: random while under-sampled, else the EI
        maximum from L-BFGS-B restarts at random unit-box starts
        (reference: bayesian_optimization.cc:34-80)."""
        if self.n_samples < max(2, self.dim):
            return self._from_unit(self._rng.uniform(size=self.dim))

        U = np.array([self._to_unit(x) for x in self._X])
        self._gp.fit(U, np.array(self._y))
        f_best = max(self._y)

        def neg_ei(u):
            return -float(self._expected_improvement(u[None, :], f_best)[0])

        best_u, best_v = None, np.inf
        starts = self._rng.uniform(size=(self.n_restarts, self.dim))
        for u0 in starts:
            res = optimize.minimize(
                neg_ei, u0, method="L-BFGS-B",
                bounds=[(0.0, 1.0)] * self.dim)
            if res.fun < best_v:
                best_v, best_u = res.fun, res.x
        if best_u is None:  # all restarts failed — fall back to random
            best_u = self._rng.uniform(size=self.dim)
        return self._from_unit(np.clip(best_u, 0.0, 1.0))
