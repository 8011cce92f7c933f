"""Gaussian-process regression for the autotuner (a copy of
``horovod_tpu/autotune/gaussian_process.py``: numpy only, so the port keeps
its own; given the same samples both give the same bits).

The reference's GP (reference:
horovod/common/optim/gaussian_process.cc/.h:46-78 — RBF kernel, Cholesky
fit, posterior mean/std predict, used by Expected Improvement). The
reference implements this in C++ on Eigen; here it is ~60 lines of numpy —
the matrices are tiny (tens of samples, 2-3 dims), so there is nothing for
native code to win.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class GaussianProcessRegressor:
    """GP with an RBF kernel and additive observation noise.

    ``alpha`` is the noise regularization added to the kernel diagonal
    (reference: the GP noise knob HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE
    scales this).
    """

    def __init__(self, alpha: float = 1e-8, length_scale: float = 1.0,
                 signal_variance: float = 1.0):
        self.alpha = alpha
        self.length_scale = length_scale
        self.signal_variance = signal_variance
        self._X: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self._chol: Optional[np.ndarray] = None
        self._alpha_vec: Optional[np.ndarray] = None

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        # squared-exponential: k(a,b) = s2 * exp(-||a-b||^2 / (2 l^2))
        d2 = (np.sum(A * A, axis=1)[:, None] + np.sum(B * B, axis=1)[None, :]
              - 2.0 * A @ B.T)
        np.maximum(d2, 0.0, out=d2)
        return self.signal_variance * np.exp(
            -0.5 * d2 / (self.length_scale ** 2))

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64).ravel()
        # normalize targets so the fixed kernel amplitude is reasonable
        self._y_mean = float(np.mean(y))
        self._y_std = float(np.std(y)) or 1.0
        yn = (y - self._y_mean) / self._y_std
        K = self._kernel(X, X)
        K[np.diag_indices_from(K)] += self.alpha
        self._chol = np.linalg.cholesky(K)
        self._alpha_vec = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, yn))
        self._X = X

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation at ``X`` (denormalized)."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        if self._X is None:
            return (np.zeros(len(X)) + self._y_mean,
                    np.full(len(X), np.sqrt(self.signal_variance)))
        Ks = self._kernel(X, self._X)
        mu = Ks @ self._alpha_vec
        v = np.linalg.solve(self._chol, Ks.T)
        var = self.signal_variance - np.sum(v * v, axis=0)
        np.maximum(var, 1e-12, out=var)
        return (mu * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)
