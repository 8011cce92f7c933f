"""The autotuner (port of ``horovod_tpu/autotune/``; reference:
horovod/common/parameter_manager.cc and optim/{bayesian_optimization,
gaussian_process}.cc): the Gaussian process, the Bayesian optimization
and the parameter manager are copies of the JAX package's numpy modules;
``probe.py`` measures the card's HBM and the data group's NCCL
bandwidth and keeps them in the probe cache."""

from horovod_tpu_torch.autotune.bayesian_optimization import \
    BayesianOptimization
from horovod_tpu_torch.autotune.gaussian_process import \
    GaussianProcessRegressor
from horovod_tpu_torch.autotune.parameter_manager import (ParameterManager,
                                                          Params)

__all__ = ["BayesianOptimization", "GaussianProcessRegressor",
           "ParameterManager", "Params"]
