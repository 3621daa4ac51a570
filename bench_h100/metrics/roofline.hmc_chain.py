"""Share of its roofline of the fused HMC chain kernel
(``ops/leapfrog.py hmc_chain`` -> ``csrc/hmc_chain.cu``), in %."""

from bench_h100.lib.readings import roofline


def read(r):
    return roofline(r, "hmc_chain")
