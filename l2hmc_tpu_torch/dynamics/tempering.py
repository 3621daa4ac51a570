"""Parallel tempering (replica exchange) over a beta ladder (port of
``l2hmc_tpu/dynamics/tempering.py``).

The ladder is stacked into the batch: a state is ``(R, C, d)``, R rungs x C
chains, and every rung's local transition runs as one flat ``(R*C, d)`` HMC
transition with per-chain ``beta`` and ``eps`` (the Wilson potential's
``force`` takes a per-chain beta, so on the card that is the Wilson kernel
for all rungs at once).  The swap phase is elementwise selects between
adjacent rung slices; nothing goes to the host.

Exactness: each rung's HMC transition is ``p_beta_i``-stationary, and the
swap satisfies detailed balance for ``prod_i exp(-beta_i U(x_i))`` with
acceptance ``min(1, exp((beta_i - beta_j)(U_i - U_j)))``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from l2hmc_tpu_torch.dynamics.hmc import hmc_transition

PotentialFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """Static ladder: ``betas`` descending, ``betas[0]`` the target coupling
    whose rung is measured; ``eps`` the per-rung leapfrog step."""

    betas: Tuple[float, ...]
    eps: Tuple[float, ...]
    num_steps: int = 5

    def __post_init__(self):
        if len(self.betas) != len(self.eps):
            raise ValueError("betas and eps must have equal length")
        if list(self.betas) != sorted(self.betas, reverse=True):
            raise ValueError("betas must be descending (target first)")

    @property
    def num_rungs(self) -> int:
        return len(self.betas)


class PTOut(NamedTuple):
    x: torch.Tensor            # (R, C, d)
    accept_prob: torch.Tensor  # (R, C) local HMC acceptance
    swap_mask: torch.Tensor    # (R-1, C) 1 where pair (i, i+1) swapped
    swap_prob: torch.Tensor    # (R-1, C) swap MH probability (0 off parity)


@torch.no_grad()
def pt_transition(potential_fn: PotentialFn, x: torch.Tensor, cfg: PTConfig,
                  generator: Optional[torch.Generator], parity: int,
                  v: Optional[torch.Tensor] = None,
                  u: Optional[torch.Tensor] = None,
                  u_swap: Optional[torch.Tensor] = None) -> PTOut:
    """One PT round: per-rung HMC, then one swap phase over the pairs
    ``(i, i+1)`` with ``i % 2 == parity`` (alternate it per round).

    The HMC momenta ``v (R*C, d)`` and accept uniforms ``u (R*C,)``, and the
    swap uniforms ``u_swap (R-1, C)``, are drawn from ``generator`` unless
    given.
    """
    r, c, d = x.shape
    kw = dict(dtype=x.dtype, device=x.device)
    betas = torch.tensor(cfg.betas, **kw)
    eps = torch.tensor(cfg.eps, **kw)

    # local phase: one flat transition over all rungs
    beta_flat = torch.repeat_interleave(betas, c)            # (R*C,)
    eps_flat = torch.repeat_interleave(eps, c)[:, None]      # (R*C, 1)
    out = hmc_transition(potential_fn, x.reshape(r * c, d), beta_flat,
                         eps_flat, cfg.num_steps, generator, v=v, u=u)
    x = out.x_out.reshape(r, c, d)
    accept = out.accept_prob.reshape(r, c)

    # swap phase: adjacent-rung exchange at the given parity
    pot = potential_fn(x.reshape(r * c, d)).reshape(r, c)
    d_beta = betas[:-1] - betas[1:]                          # (R-1,)
    d_u = pot[:-1] - pot[1:]                                 # (R-1, C)
    active = (torch.arange(r - 1, device=x.device) % 2 == parity)[:, None]
    log_alpha = d_beta[:, None] * d_u
    prob = torch.where(active, torch.exp(torch.clamp(log_alpha, max=0.0)),
                       torch.zeros_like(log_alpha))
    if u_swap is None:
        u_swap = torch.rand(prob.shape, generator=generator, **kw)
    swap = (u_swap < prob).to(x.dtype)

    # same-parity pairs are disjoint: one select pass per neighbour
    zero = torch.zeros_like(swap[:1])
    take_upper = torch.cat([swap, zero])                     # rung i takes i+1
    take_lower = torch.cat([zero, swap])                     # rung i takes i-1
    x_up = torch.cat([x[1:], x[-1:]])
    x_dn = torch.cat([x[:1], x[:-1]])
    x = (take_upper[..., None] * x_up + take_lower[..., None] * x_dn
         + (1.0 - take_upper - take_lower)[..., None] * x)
    return PTOut(x=x, accept_prob=accept, swap_mask=swap, swap_prob=prob)


def make_pt_chunk(potential_fn: PotentialFn, cfg: PTConfig, chunk_size: int,
                  wrap_fn=None, observables_fn=None):
    """``chunk(x, generator, round0) -> (x, metrics)``: ``chunk_size`` PT
    rounds.  ``metrics`` holds per-round ``(chunk_size, ...)`` tensors on
    the device: ``accept_prob (R,)`` and ``swap_rate (R-1,)`` (swaps over
    active pairs), plus the rung-0 observables of ``observables_fn(x[0])
    -> dict``.  ``round0`` is the global round counter, so the swap parity
    keeps alternating across chunks."""

    @torch.no_grad()
    def chunk(x, generator, round0: int):
        per_round = []
        for i in range(chunk_size):
            out = pt_transition(potential_fn, x, cfg, generator,
                                (round0 + i) % 2)
            x = out.x if wrap_fn is None else wrap_fn(out.x)
            active = torch.sum(out.swap_prob > 0, dim=1)
            m = {"accept_prob": torch.mean(out.accept_prob, dim=1),
                 "swap_rate": torch.sum(out.swap_mask, dim=1)
                 / torch.clamp(active, min=1)}
            if observables_fn is not None:
                m.update(observables_fn(x[0]))
            per_round.append(m)
        return x, {k: torch.stack([m[k] for m in per_round])
                   for k in per_round[0]}

    return chunk
