"""Work of one launch of the conv stacks' kernel (``networks/nets.py
ConvNet`` -> ``ops/conv_stack.py`` -> ``csrc/conv_stack.cu``,
``conv_stack_kernel``): both input slots of one conditioner call, counted
from the configuration's shapes, never from the program.

Per chain on a lattice of ``d`` sites with even sides: each slot a ``k1 x
k1`` conv of ``f`` filters on the full lattice and a ``k2 x k2`` conv of
``2 f`` filters at stride 2 (``d / 4`` positions); the position's slot
takes the cos/sin features (4 channels for ``u1``), the other slot one
per-link field (2 channels).  2 FLOPs per multiply-add, at the float32 rate
outside tensor cores (the kernel's arithmetic); bytes: each slot's input
read once and its output written once.  At 8192 chains of 16x16: 2.886
GFLOP (43.1 us at 67 TFLOP/s) and 117.4 MB (35.1 us at 3.35 TB/s) a
launch.
"""

from __future__ import annotations

from bench_h100.counts.u1 import FLOAT_BYTES


def slot_channels(sampler: dict) -> tuple:
    """Input channels of the position's slot and of the other slot."""
    return (4 if sampler["group"] == "u1" else 2), 2


def chain_macs(d: int, sampler: dict) -> int:
    """Multiply-adds of both slots' stacks for one chain."""
    f1 = sampler["num_filters"]
    k1, k2 = sampler["filter_size1"], sampler["filter_size2"]
    return sum(d * f1 * cin * k1 * k1 + d // 4 * 2 * f1 * f1 * k2 * k2
               for cin in slot_channels(sampler))


def chain_bytes(d: int, sampler: dict) -> int:
    """Bytes of both slots for one chain: the inputs (``cin d`` floats
    each) and the outputs (``2 f d / 4`` floats each)."""
    out = 2 * sampler["num_filters"] * (d // 4)
    return FLOAT_BYTES * sum(cin * d + out for cin in slot_channels(sampler))


def least_seconds(b: int, d: int, sampler: dict, peaks: dict) -> float:
    """The least time of one launch over ``b`` chains: its FLOPs at the
    float32 peak or its bytes at the memory peak, whichever is longer."""
    if d % 4:
        raise ValueError(f"{d} sites: the sides must be even")
    return max(2.0 * b * chain_macs(d, sampler)
               / peaks["float32_flops_per_s"],
               b * chain_bytes(d, sampler) / peaks["hbm_bytes_per_s"])
