"""Analytic targets of the sampler workload (port of ``l2hmc_tpu/targets``)."""

from l2hmc_tpu_torch.targets.distributions import (  # noqa: F401
    GMM,
    Gaussian,
    GaussianFunnel,
    RoughWell,
    gen_ring,
    gmm_axes,
    gmm_diagonal,
    gmm_one_per_axis,
    gmm_single_axis,
    quadratic_gaussian,
    random_tilted_gaussian,
    scg_2d,
)
