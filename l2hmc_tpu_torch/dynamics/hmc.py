"""Plain Hamiltonian Monte Carlo baseline (port of ``l2hmc_tpu/dynamics/hmc.py``).

Standard leapfrog + MH accept with the same potential/kinetic conventions as
the learned sampler; :func:`hmc_chain`, a chain of them for any potential
(the thermalizer of ``benchmarks/smc_u1.py``, the building block of AIS and
SMC); and the U(1) chain entry :func:`hmc_chain_u1_fused`, which runs the
fused chain of ``ops/leapfrog.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from l2hmc_tpu_torch.lattice.u1 import chain_total
from l2hmc_tpu_torch.ops import leapfrog as fused

PotentialFn = Callable[[torch.Tensor], torch.Tensor]


class HMCOut(NamedTuple):
    x_out: torch.Tensor
    accept_prob: torch.Tensor
    accept_mask: torch.Tensor


def _grad(potential_fn, x, beta):
    """d/dx [beta U(x)] without a graph: the potential's ``force`` where it
    has one, else autograd."""
    force = getattr(potential_fn, "force", None)
    if force is not None:
        with torch.no_grad():
            return force(x, beta)
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(beta * potential_fn(xg)), xg)
    return g


def leapfrog(potential_fn: PotentialFn, x, v, beta, eps, num_steps: int):
    """Half-kick, K-1 full (drift, kick), drift, half-kick."""
    v = v - 0.5 * eps * _grad(potential_fn, x, beta)
    for _ in range(num_steps - 1):
        x = x + eps * v
        v = v - eps * _grad(potential_fn, x, beta)
    x = x + eps * v
    v = v - 0.5 * eps * _grad(potential_fn, x, beta)
    return x, v


def hmc_transition(potential_fn: PotentialFn, x: torch.Tensor, beta, eps,
                   num_steps: int, generator: Optional[torch.Generator] = None,
                   v: Optional[torch.Tensor] = None,
                   u: Optional[torch.Tensor] = None,
                   sharding=None) -> HMCOut:
    """One HMC transition for a batch of chains.

    Momenta ``v (B, d)`` and accept uniforms ``u (B,)`` are drawn from
    ``generator`` unless injected.  With a ``sharding``
    (``parallel/spatial.py``), ``x`` and ``v`` are this rank's slab
    columns, ``potential_fn`` a slab potential (``ops/wilson.py
    make_slab_potential_fn``), the kinetic energy is added over 'space',
    and drawn momenta are the global draw's slab columns.
    """
    if v is None:
        shape = x.shape if sharding is None else (
            x.shape[0], sharding.shape.x_dim)
        v = torch.randn(shape, generator=generator, dtype=x.dtype,
                        device=x.device)
        if sharding is not None:
            v = sharding.columns(v).contiguous()
    if u is None:
        u = torch.rand((x.shape[0],), generator=generator, dtype=x.dtype,
                       device=x.device)

    def hamiltonian(x, v):
        kinetic = chain_total(torch.sum(v * v, dim=-1), sharding)
        return beta * potential_fn(x) + 0.5 * kinetic

    xp, vp = leapfrog(potential_fn, x, v, beta, eps, num_steps)
    dh = hamiltonian(x, v) - hamiltonian(xp, vp)
    prob = torch.exp(torch.clamp(dh, max=0.0))
    prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
    accept = (u < prob).to(x.dtype)
    x_out = accept[:, None] * xp + (1.0 - accept[:, None]) * x
    return HMCOut(x_out=x_out, accept_prob=prob, accept_mask=accept)


def hmc_chain_u1_fused(links: torch.Tensor, generator: torch.Generator,
                       eps: float, beta: float, num_leapfrog: int,
                       num_samples: int, hop: bool = False):
    """U(1) HMC chain on the fused chain of ``ops/leapfrog.py``.

    ``links (B, Lt, Lx, 2)`` angles.  Returns ``(links_out, plaq_trace
    (T, B), charge_trace (T, B), accept_probs (T, B))``.  On a CUDA tensor
    the whole chain runs in one launch of the hand-written kernel (or
    raises); on a CPU tensor the plain version runs.  ``hop=True`` appends
    one exact instanton hop per transition.
    """
    return fused.hmc_chain(links, generator, eps, beta, num_leapfrog,
                           num_samples, hop=hop)


@torch.no_grad()
def hmc_chain(potential_fn: PotentialFn, x0: torch.Tensor, beta,
              generator: Optional[torch.Generator], eps, num_leapfrog: int,
              num_samples: int, wrap_fn: Optional[Callable] = None,
              draws=None, sharding=None):
    """Run ``num_samples`` HMC transitions from ``x0 (B, d)``.

    Returns ``(samples (T, B, d), accept_probs (T, B))``; each sample is
    the state after its transition (and ``wrap_fn``).  ``draws``, a
    sequence of ``(v, u)`` per transition, replaces the generator's;
    ``sharding``: see :func:`hmc_transition`.
    """
    x = x0
    xs, probs = [], []
    for t in range(num_samples):
        v, u = draws[t] if draws is not None else (None, None)
        out = hmc_transition(potential_fn, x, beta, eps, num_leapfrog,
                             generator, v=v, u=u, sharding=sharding)
        x = out.x_out if wrap_fn is None else wrap_fn(out.x_out)
        xs.append(x)
        probs.append(out.accept_prob)
    return torch.stack(xs), torch.stack(probs)
