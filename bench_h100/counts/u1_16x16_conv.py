"""Work of the cells of ``u1_16x16_conv``: the eval chunk of the conv
L2HMC sampler (``train/gauge.py make_eval_chunk``, the periodic-CNN
conditioner, the split integrator) and the Wilson kernels it launches,
counted from the configuration's shapes, never from the program.

- The conditioner, per call and chain: each conv stack (a ``k1 x k1``
  conv of ``f`` filters on the full lattice, a ``k2 x k2`` conv of ``2 f``
  filters at stride 2), the two embeddings of the flattened stacks and the
  time pair into the trunk width ``h``, the ``h x h`` layer and the fused
  ``h x 3 (2 d)`` head; 2 FLOPs per multiply-add.  The split integrator
  calls it ``4 K`` times per transition (``2 K`` momentum half-kicks,
  ``2 K`` position updates).
- The Wilson kernels (``csrc/wilson.cu``), per launch of ``b`` chains of
  ``d`` sites by kind (the ``KIND`` of ``wilson_kernel<KIND, ROUTE>``):
  each input read once and each output written once.
"""

from __future__ import annotations

from bench_h100.counts.u1 import FLOAT_BYTES, Work

# Wilson kernel kinds (csrc/wilson.cu enum Kind) -> floats per chain as a
# function of the sites d: the forward reads the links (2 d) and writes the
# action and sin P; the action-only variant writes the action alone; the
# fused force reads the links and the chain's coefficient and writes the
# force (2 d); the backward reads sin P and the coefficient; the double
# backward reads the links, the coefficient and the cotangent and writes
# both gradients
WILSON_FLOATS = {
    0: lambda d: 2 * d + 1 + d,
    1: lambda d: 2 * d + 1,
    2: lambda d: 2 * d + 1 + 2 * d,
    3: lambda d: d + 1 + 2 * d,
    4: lambda d: 2 * d + 1 + 2 * d + 2 * d + 1,
}


def conv_macs(d: int, sampler: dict) -> int:
    """Multiply-adds of one conditioner call per chain on a lattice of
    ``d`` sites with even sides (the stride-2 conv keeps ``d / 4``): the
    position slot (cos/sin, 4 channels) and the momentum slot (2 channels)
    each through a conv stack, then the trunk and the heads."""
    if d % 4:
        raise ValueError(f"{d} sites: the sides must be even")
    f1 = sampler["num_filters"]
    f2 = 2 * f1
    k1, k2 = sampler["filter_size1"], sampler["filter_size2"]
    h = sampler["num_hidden"]
    flat = d // 4 * f2

    def stack(cin):
        return d * f1 * cin * k1 * k1 + d // 4 * f2 * f1 * k2 * k2

    trunk = 2 * flat * h + 2 * h + h * h + h * 3 * (2 * d)
    return stack(4) + stack(2) + trunk


def conditioner_flops_per_transition(sampler: dict, d: int) -> float:
    """One chain transition's conditioner FLOPs (``mfu.sample``'s
    numerator): ``4 K`` calls of :func:`conv_macs`, 2 FLOPs each."""
    return 2.0 * 4 * sampler["num_leapfrog"] * conv_macs(d, sampler)


def wilson_bytes(kind: int, b: int, d: int) -> float:
    """Bytes of one Wilson launch of ``kind`` over ``b`` chains of ``d``
    sites."""
    return float(FLOAT_BYTES * b * WILSON_FLOATS[kind](d))


def call_work(config: dict, work: dict) -> Work:
    """One eval call (``work``: chains, transitions per call): the
    conditioner's products as matrix work and the Wilson launches' bytes
    (the forces ``K + 1`` and the two action-only energies per transition)
    with the links in and out; the chunk's elementwise work is not counted
    (0): the chunk is many kernels, whose roofline no reader takes."""
    lt, lx = config["lattice"]
    d = lt * lx
    b, n = work["chains"], work["transitions_per_call"]
    k = config["sampler"]["num_leapfrog"]
    flops = conditioner_flops_per_transition(config["sampler"], d) * b * n
    per_transition = ((k + 1) * wilson_bytes(2, b, d)
                      + 2 * wilson_bytes(1, b, d))
    return Work(flops, 0.0,
                n * per_transition + FLOAT_BYTES * 2 * b * 2 * d)
