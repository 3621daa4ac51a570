"""Work of the cells of ``u1_64x64_local``: the local stencil chain
(``l2hmc_local_chain``, c4 L1, K = 4) on 64x64 links, by the frozen
arithmetic of ``counts/u1.py``."""

from bench_h100.counts.u1 import (  # noqa: F401
    call_work, conditioner_flops_per_transition)
