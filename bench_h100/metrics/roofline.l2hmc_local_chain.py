"""Share of its roofline of the local stencil chain kernel
(``ops/l2hmc_kernel.py l2hmc_local_chain`` ->
``csrc/l2hmc_local_chain.cu``), in %."""

from bench_h100.lib.readings import roofline


def read(r):
    return roofline(r, "l2hmc_local_chain")
