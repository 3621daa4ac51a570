"""The work of one call of a fused U(1) chain kernel, counted from its shapes
for the work the algorithm needs: the yardstick of the rooflines and of
``mfu``, frozen here.

A call runs ``n`` transitions of ``b`` chains on ``d`` sites (2 d links).
Three terms, each the least time it could take at its peak:

- ``matrix_flops``: the conditioner's products, 2 per multiply-add, work a
  matrix unit can do (once: not the tensor-core passes a kernel may take
  to reach float32 accuracy, nor anything it recomputes);
- ``other_ops``: every other operation of the transition, one per element
  operation, at the float32 rate without tensor cores;
- ``bytes``: each input read once and each output written once (links in
  and out, the three ``(n, b)`` traces, the weights once per call).
"""

from __future__ import annotations

from dataclasses import dataclass

# HMC, per site: a leapfrog step's 25 operations (plaquette 3, sincos 2,
# two kicks of 3, two drifts with their wrap of 7) and a transition's 15
# (energy change and the accept select)
HMC_OPS_PER_SITE_STEP = 25
HMC_OPS_PER_SITE = 15
# The trained transition outside its conditioner (features, circle map,
# log-Jacobian, masks, direction fusion, kicks, force, energy change,
# accept), per site: the plain transition's element operations with the
# conditioner left out, 689 at K = 3, 903 at K = 4 and 1117 at K = 5, so
# 214 per leapfrog step and 47 per transition
L2HMC_OPS_PER_SITE_STEP = 214
L2HMC_OPS_PER_SITE = 47
FLOAT_BYTES = 4


@dataclass(frozen=True)
class Work:
    matrix_flops: float
    other_ops: float
    bytes: float


def io_bytes(b: int, d: int, n: int, weights: int = 0) -> float:
    """Links in and out, three ``(n, b)`` traces, the weights once."""
    return FLOAT_BYTES * (2 * b * 2 * d + 3 * n * b + weights)


def hmc(b: int, d: int, num_leapfrog: int, n: int) -> Work:
    ops = b * d * (HMC_OPS_PER_SITE_STEP * num_leapfrog + HMC_OPS_PER_SITE)
    return Work(0.0, float(ops) * n, io_bytes(b, d, n))


def mlp_macs(d: int, hidden: int) -> int:
    """Multiply-adds of one MLP conditioner call per chain: the in-projection
    of the 6 d features and the 2 time rows, the trunk, the three heads."""
    return (6 * d + 2) * hidden + hidden * hidden + hidden * 6 * d


def stencil_macs(d: int, channels: int, layers: int) -> int:
    """Multiply-adds of one local conditioner call per chain: per site the
    5-point stencil over 6 input channels, ``layers - 1`` stencils over
    ``channels`` and the 1x1 head to 6 outputs; the time rows once."""
    c = channels
    per_site = 5 * 6 * c + (layers - 1) * 5 * c * c + 6 * c
    return d * per_site + 2 * c


def l2hmc(b: int, d: int, num_leapfrog: int, n: int, macs: int,
          weights: int) -> Work:
    """A trained chain's call: ``3 K + 1`` conditioner calls per transition
    (K + 1 momentum kicks, 2 K position half-updates) of ``macs`` each."""
    calls = 3 * num_leapfrog + 1
    ops = b * d * (L2HMC_OPS_PER_SITE_STEP * num_leapfrog
                   + L2HMC_OPS_PER_SITE)
    return Work(2.0 * b * calls * macs * n, float(ops) * n,
                io_bytes(b, d, n, weights))


def conditioner_flops_per_transition(sampler: dict, d: int) -> float:
    """One chain transition's conditioner FLOPs (``mfu``'s numerator)."""
    return 2.0 * (3 * sampler["num_leapfrog"] + 1) * _macs(sampler, d)


def _macs(sampler: dict, d: int) -> int:
    if sampler["network"] == "mlp":
        return mlp_macs(d, sampler["hidden"])
    return stencil_macs(d, sampler["channels"], sampler["layers"])


def _weights(sampler: dict, d: int) -> int:
    """Floats of both nets and the masks."""
    if sampler["network"] == "mlp":
        h = sampler["hidden"]
        one = mlp_macs(d, h) + 2 * h + 3 * 2 * d + 2 * 2 * d
    else:
        c = sampler["channels"]
        one = (5 * 6 * c + 2 * c + c + (sampler["layers"] - 1) * (5 * c * c + c)
               + 6 * c + 6 + 4)
    return 2 * one + sampler["num_leapfrog"] * 2 * d


def call_work(config: dict, work: dict) -> Work:
    """The work of one call as a driver reports it (``work``: the kernel,
    its chains, transitions per call and leapfrog steps) under
    ``config``, whose ``sampler`` gives a trained kernel's net."""
    lt, lx = config["lattice"]
    d = lt * lx
    b, n, k = work["chains"], work["transitions_per_call"], work["num_leapfrog"]
    if work["kernel"] == "hmc_chain":
        return hmc(b, d, k, n)
    s = config["sampler"]
    return l2hmc(b, d, k, n, _macs(s, d), _weights(s, d))
