"""Multinomial HMC with randomized trajectory placement, the NUTS-class
baseline, and Nesterov dual averaging of the step size (port of
``l2hmc_tpu/dynamics/nuts.py``).

Per transition (Betancourt 2017, section A.3): draw a uniform split
``f ~ U{0..L}`` per chain, integrate ``f`` leapfrog steps forward and
``L - f`` backward from the start point (one fixed-length trajectory holding
the start at a uniformly random offset), and select the next state from the
``L + 1`` trajectory states with probability proportional to ``exp(-H)``
(progressive multinomial).  Fixed shapes, exact detailed balance.  The
u-turn fraction is a diagnostic for choosing ``L``.

Forces come from the potential's ``force`` where it has one (the Wilson
kernel of ``ops/wilson.py`` on the card), else from autograd.  The dual
averaging state is four float32 scalars on the device of the acceptance
that drives it, so an update never waits for the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from l2hmc_tpu_torch.dynamics.hmc import _grad

PotentialFn = Callable[[torch.Tensor], torch.Tensor]


class MultinomialHMCOut(NamedTuple):
    x_out: torch.Tensor
    accept_stat: torch.Tensor    # mean min(1, exp(H0-H)) over trajectory
    uturn_frac: torch.Tensor     # fraction of chains whose trajectory u-turned


class MultinomialDraws(NamedTuple):
    """The randomness of one transition: momenta ``v0 (B, d)``, split points
    ``f (B,)`` in ``{0..L}`` and selection uniforms ``us (L, B)``."""

    v0: torch.Tensor
    f: torch.Tensor
    us: torch.Tensor


def draw_multinomial(generator, b: int, d: int, num_steps: int,
                     device=None) -> MultinomialDraws:
    kw = dict(generator=generator, device=device)
    return MultinomialDraws(
        torch.randn((b, d), **kw), torch.randint(0, num_steps + 1, (b,), **kw),
        torch.rand((num_steps, b), **kw))


@torch.no_grad()
def multinomial_hmc_transition(potential_fn: PotentialFn, x: torch.Tensor,
                               beta, eps, num_steps: int = 16,
                               generator: Optional[torch.Generator] = None,
                               draws: Optional[MultinomialDraws] = None
                               ) -> MultinomialHMCOut:
    """One multinomial-HMC transition for a batch of chains ``x (B, d)``;
    the randomness is drawn from ``generator`` unless ``draws`` is given."""
    batch = x.shape[0]
    if draws is None:
        draws = draw_multinomial(generator, batch, x.shape[1], num_steps,
                                 x.device)
    v0, f, us = draws

    def hamiltonian(x_, v_):
        return beta * potential_fn(x_) + 0.5 * torch.sum(v_ * v_, dim=-1)

    def leapfrog_step(x_, v_, direction):
        e = direction[:, None] * eps
        vh = v_ - 0.5 * e * _grad(potential_fn, x_, beta)
        xn = x_ + e * vh
        vn = vh - 0.5 * e * _grad(potential_fn, xn, beta)
        return xn, vn

    h0 = hamiltonian(x, v0)
    # the forward branch from (x, v0), the backward one from (x, -v0)
    xc, vc, xb, vb = x, v0, x, -v0
    log_sum_w = torch.zeros(batch, dtype=x.dtype, device=x.device)
    x_sel = x
    acc_sum = torch.zeros_like(log_sum_w)
    dot_min = torch.full_like(log_sum_w, float("inf"))
    for t in range(num_steps):
        forward = t < f          # (B,) this step extends the forward branch
        fw = forward[:, None]
        direction = torch.where(forward, 1.0, -1.0).to(x.dtype)
        xn, vn = leapfrog_step(torch.where(fw, xc, xb),
                               torch.where(fw, vc, vb), direction)
        xc, vc = torch.where(fw, xn, xc), torch.where(fw, vn, vc)
        xb, vb = torch.where(fw, xb, xn), torch.where(fw, vb, vn)

        h = hamiltonian(xn, vn)
        log_w = h0 - h
        log_w = torch.where(torch.isfinite(log_w), log_w,
                            torch.full_like(log_w, -float("inf")))
        new_log_sum = torch.logaddexp(log_sum_w, log_w)
        take = (us[t] < torch.exp(log_w - new_log_sum))[:, None]
        x_sel = torch.where(take, xn, x_sel)
        log_sum_w = new_log_sum

        acc_sum = acc_sum + torch.clamp(torch.exp(h0 - h), max=1.0)
        # u-turn diagnostic across the full span
        dot_min = torch.minimum(dot_min, torch.sum((xc - xb) * vn, dim=-1))
    return MultinomialHMCOut(
        x_out=x_sel, accept_stat=acc_sum / num_steps,
        uturn_frac=torch.mean((dot_min < 0).to(torch.float32)))


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor


def dual_averaging_init(eps0: float, device=None) -> DualAveragingState:
    log_eps = torch.log(torch.tensor(eps0, dtype=torch.float32,
                                     device=device))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps.clone(),
                              h_bar=zero, t=zero.clone())


def dual_averaging_update(state: DualAveragingState,
                          accept_stat: torch.Tensor, target: float = 0.7,
                          gamma: float = 0.05, t0: float = 10.0,
                          kappa: float = 0.75) -> DualAveragingState:
    """Nesterov dual averaging on log eps (Hoffman & Gelman 2014, Alg. 5)."""
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = ((1.0 - eta_h) * state.h_bar
             + eta_h * (target - torch.mean(accept_stat)))
    log_eps = state.log_eps_avg - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps_avg,
                              h_bar=h_bar, t=t)


@torch.no_grad()
def nuts_chain(potential_fn: PotentialFn, x0: torch.Tensor, beta,
               generator: Optional[torch.Generator], num_samples: int,
               eps0: float = 0.1, max_steps: int = 16, adapt_steps: int = 0,
               draws=None):
    """Multinomial-HMC chain with optional dual-averaging warmup.

    Returns ``(samples (T, B, d), accept_stats (T, B), uturn_fracs (T,))``.
    The first ``adapt_steps`` transitions run at the controller's
    exploration eps and update it; the rest at its smoothed average, which
    stays on the device.  ``draws``, a :class:`MultinomialDraws` per
    transition, replaces the generator's.
    """
    x = x0
    da = dual_averaging_init(eps0, x0.device)
    xs, accs, uturns = [], [], []
    for i in range(num_samples):
        adapting = i < adapt_steps
        eps = torch.exp(da.log_eps if adapting else da.log_eps_avg)
        out = multinomial_hmc_transition(
            potential_fn, x, beta, eps, max_steps, generator,
            draws[i] if draws is not None else None)
        if adapting:
            da = dual_averaging_update(da, out.accept_stat)
        x = out.x_out
        xs.append(x)
        accs.append(out.accept_stat)
        uturns.append(out.uturn_frac)
    return torch.stack(xs), torch.stack(accs), torch.stack(uturns)
