"""Issue-rate probes: dependency chains of one op class, plain and kernel.

Port of the chains of ``benchmarks/vpu_roofline.py`` (``measure_rates`` and
its in-kernel edition ``measure_rates_pallas``).  A probe applies its body
``m`` times to every element of a float32 array, each step depending on the
last.  :data:`PROBES` lists the bodies with the op counts of one step;
:func:`probe_chain_reference` is the plain PyTorch loop, :func:`probe_chain`
launches ``csrc/issue_rates.cu`` for a CUDA tensor.
``l2hmc_tpu_torch/benchmarks/vpu_roofline.py`` times both at two chain
lengths and turns the slopes into per-class rates.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.leapfrog import check_cuda_input


class Probe(NamedTuple):
    """A probe body and the ops of one step: ``n_target`` of its class,
    ``n_cheap`` cheap ones around it."""

    name: str
    body: Callable[[torch.Tensor], torch.Tensor]
    n_target: int
    n_cheap: int


# the bodies of vpu_roofline.py's probes, and atan2 (the port's kernels call
# atan2f where the TPU kernels build an arctangent from div and cheap ops);
# the order is the probe id of csrc/issue_rates.cu
PROBES = (
    Probe("cheap", lambda x: x * 0.9995 + 2e-4, 2, 0),
    Probe("exp", lambda x: torch.exp(-x), 1, 1),
    Probe("trig", lambda x: torch.sin(x + 0.7), 1, 1),
    Probe("log", lambda x: torch.log(x + 1.5), 1, 1),
    Probe("div", lambda x: 1.7 / (x + 1.2), 1, 1),
    Probe("floor", lambda x: (x - torch.floor(x * 0.73)) * 0.9 + 0.05, 1, 4),
    Probe("atan2", lambda x: torch.atan2(x + 0.3, x + 1.1), 1, 2),
)
PROBE_IDS = {p.name: i for i, p in enumerate(PROBES)}


def probe_chain_reference(x: torch.Tensor, probe: str, m: int) -> torch.Tensor:
    """``m`` dependent steps of ``probe``'s body on ``x`` (plain PyTorch)."""
    body = PROBES[PROBE_IDS[probe]].body
    for _ in range(m):
        x = body(x)
    return x


def probe_chain(x: torch.Tensor, probe: str, m: int) -> torch.Tensor:
    """``m`` dependent steps of ``probe``'s body on every element of ``x``.

    A CPU tensor runs :func:`probe_chain_reference`.  A CUDA tensor (float32,
    contiguous) launches the kernel of ``csrc/issue_rates.cu`` on a copy of
    ``x`` — one thread per element, the chain in a register — or raises.
    """
    if probe not in PROBE_IDS:
        raise ValueError(f"probe must be one of {tuple(PROBE_IDS)}: "
                         f"{probe!r}")
    if m < 0:
        raise ValueError(f"m={m}: the chain length is >= 0")
    if not x.is_cuda:
        return probe_chain_reference(x, probe, m)
    check_cuda_input("x", x)
    out = x.clone()
    lib = _cuda.library()
    dev = x.device
    probe_chain.launches += 1
    _cuda.check(lib.issue_rates_launch(
        out.data_ptr(), out.numel(), PROBE_IDS[probe], m, dev.index or 0,
        _cuda.stream_handle(dev)), "issue_rates_launch")
    return out


probe_chain.launches = 0
