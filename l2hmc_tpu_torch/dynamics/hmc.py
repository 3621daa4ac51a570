"""Plain Hamiltonian Monte Carlo baseline (port of ``l2hmc_tpu/dynamics/hmc.py``).

Standard leapfrog + MH accept with the same potential/kinetic conventions as
the learned sampler, plus the U(1) chain entry :func:`hmc_chain_u1_fused`,
which runs the fused chain of ``ops/leapfrog.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

PotentialFn = Callable[[torch.Tensor], torch.Tensor]


class HMCOut(NamedTuple):
    x_out: torch.Tensor
    accept_prob: torch.Tensor
    accept_mask: torch.Tensor


def _grad(potential_fn, x, beta):
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
                   u: Optional[torch.Tensor] = None) -> HMCOut:
    """One HMC transition for a batch of chains.

    Momenta ``v (B, d)`` and accept uniforms ``u (B,)`` are drawn from
    ``generator`` unless injected.
    """
    if v is None:
        v = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device)
    if u is None:
        u = torch.rand((x.shape[0],), generator=generator, dtype=x.dtype,
                       device=x.device)

    def hamiltonian(x, v):
        return beta * potential_fn(x) + 0.5 * torch.sum(v * v, dim=-1)

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
    return hmc_chain(links, generator, eps, beta, num_leapfrog, num_samples,
                     hop=hop)
