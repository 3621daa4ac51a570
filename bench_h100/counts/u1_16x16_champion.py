"""Work of the cells of ``u1_16x16_champion``: the trained MLP chain
(``l2hmc_chain``, hidden 64, K = 3) and its HMC baseline (``hmc_chain``,
K = 5) on 16x16 links, by the frozen arithmetic of ``counts/u1.py``."""

from bench_h100.counts.u1 import (  # noqa: F401
    call_work, conditioner_flops_per_transition)
