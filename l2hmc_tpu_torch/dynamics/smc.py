"""Sequential Monte Carlo over a beta ladder (port of
``l2hmc_tpu/dynamics/smc.py``).

An annealed particle ensemble over beta with importance reweighting,
systematic resampling and MCMC (HMC) move steps: BASELINE.json config 5.
The particle population lives on the batch axis.  Resampling is selected,
not branched: every rung computes the ancestor indices and ``torch.where``
picks between the resampled and the kept population, so no rung waits for
the host.

The fused move (:func:`make_u1_fused_move`) runs all the transitions of a
rung in one launch of ``csrc/hmc_chain.cu`` on a CUDA tensor (the plain
version on a CPU one).

A difference from the reference, kept on purpose: when float32 rounding
leaves the last cumulative weight below the last systematic point,
``searchsorted`` returns ``n``.  ``jnp.take`` then gives a NaN particle;
an index ``n`` on the card is a device-side assert.  The port clamps the
index to ``n - 1`` (:func:`systematic_resample`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch


class SMCState(NamedTuple):
    x: torch.Tensor          # (n, d) particles
    log_w: torch.Tensor      # (n,) unnormalized log-weights
    log_z: torch.Tensor      # scalar accumulated log normalizer


def effective_sample_size(log_w: torch.Tensor) -> torch.Tensor:
    """ESS of normalized weights: 1 / sum(w^2)."""
    w = torch.softmax(log_w, dim=0)
    return 1.0 / torch.sum(w * w)


def draw_resample_u0(generator, n: int, device=None) -> torch.Tensor:
    """The systematic resampling offset ``u0 ~ U[0, 1/n)`` (0-d)."""
    return torch.rand((), generator=generator, device=device) * (1.0 / n)


def systematic_resample(generator: Optional[torch.Generator],
                        log_w: torch.Tensor,
                        u0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Systematic (low-variance) resampling -> ancestor indices ``(n,)``,
    each at most ``n - 1``.  ``u0`` (0-d, in ``[0, 1/n)``) is drawn from
    ``generator`` unless given."""
    n = log_w.shape[0]
    if u0 is None:
        u0 = draw_resample_u0(generator, n, log_w.device)
    cum = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    pts = u0 + torch.arange(n, dtype=log_w.dtype, device=log_w.device) / n
    # side='left', as jnp.searchsorted
    idx = torch.searchsorted(cum, pts, right=False)
    return torch.clamp(idx, max=n - 1)


def _log_mean(log_w: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(log_w, dim=0) - np.log(log_w.shape[0])


@torch.no_grad()
def smc_beta_ladder(generator: Optional[torch.Generator], x0: torch.Tensor,
                    potential_fn: Callable[[torch.Tensor], torch.Tensor],
                    betas: Sequence[float], move_fn,
                    ess_threshold: float = 0.5, u0s=None):
    """Anneal particles ``x0`` (drawn at ``betas[0]``) up the beta ladder.

    ``move_fn(x, beta, generator) -> x`` applies one or more MCMC
    transitions targeting ``exp(-beta U)``.  Resampling triggers where
    ESS < ``ess_threshold * n``; the indices are always computed and the
    population ``where``-selected.  ``u0s``, one resampling offset per rung,
    replaces the generator's draws.

    Returns ``(SMCState, ess_trace (rungs,))`` with the final particles and
    the accumulated ``log Z(beta_end)/Z(beta_0)`` estimate.
    """
    # float32 rungs, as the reference's jnp.linspace ladder
    betas = np.asarray(betas, dtype=np.float32)
    n = x0.shape[0]
    dev = x0.device
    x = x0
    log_w = torch.zeros(n, dtype=x0.dtype, device=dev)
    log_z = torch.zeros((), dtype=x0.dtype, device=dev)
    ess_trace = []
    for r in range(len(betas) - 1):
        b_prev, b_curr = betas[r], betas[r + 1]
        u0 = (u0s[r] if u0s is not None
              else draw_resample_u0(generator, n, dev))
        # reweight: w *= exp(-(b_curr - b_prev) U(x))
        log_w = log_w - float(b_curr - b_prev) * potential_fn(x)

        # adaptive resampling (selected, not branched)
        ess = effective_sample_size(log_w)
        do_resample = ess < ess_threshold * n
        idx = systematic_resample(generator, log_w, u0)
        x = torch.where(do_resample, x.index_select(0, idx), x)
        # log_z accumulates the mean weight at resampling time
        log_z = log_z + torch.where(do_resample, _log_mean(log_w),
                                    torch.zeros_like(log_z))
        log_w = torch.where(do_resample, torch.zeros_like(log_w), log_w)

        # MCMC move at the current temperature
        x = move_fn(x, float(b_curr), generator)
        ess_trace.append(ess)
    # fold in the remaining weights
    log_z = log_z + _log_mean(log_w)
    return SMCState(x=x, log_w=log_w, log_z=log_z), torch.stack(ess_trace)


def weighted_mean(log_w: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Importance-weighted ensemble mean ``sum(softmax(log_w) * values)``:
    the final population generally carries residual weights (resampling
    triggers only below the ESS threshold), so an unweighted mean is biased
    exactly when the final ESS is lowest."""
    return torch.sum(torch.softmax(log_w, dim=0) * values)


def _eps(num_plaquettes: int, beta: float) -> float:
    """The volume-scaled step ``(64/n_plaq)^(1/4) * 0.4/sqrt(beta)``
    (leapfrog error grows ~V eps^4), in float32 as the reference forms it."""
    scale = (64.0 / num_plaquettes) ** 0.25
    return float(np.float32(scale * 0.4) / np.sqrt(np.float32(beta)))


def make_u1_hmc_move(potential_fn, wrap_fn, num_plaquettes: int,
                     leapfrog: int, moves_per_rung: int):
    """SMC move for U(1): ``moves_per_rung`` HMC transitions at the
    volume-scaled step (:func:`_eps`).  ``move(x, beta, generator,
    draws=None)``; ``draws``, a ``(v, u)`` per transition, replaces the
    generator's."""
    from l2hmc_tpu_torch.dynamics.hmc import hmc_transition

    def move(x, b, generator, draws=None):
        eps = _eps(num_plaquettes, b)
        for m in range(moves_per_rung):
            v, u = draws[m] if draws is not None else (None, None)
            out = hmc_transition(potential_fn, x, b, eps, leapfrog, generator,
                                 v=v, u=u)
            x = wrap_fn(out.x_out)
        return x

    return move


def make_u1_fused_move(shape, leapfrog: int, moves_per_rung: int):
    """SMC move on the fused HMC chain of ``ops/leapfrog.py``: all
    ``moves_per_rung`` transitions of a rung in one call, at the step of
    :func:`make_u1_hmc_move`.  On a CUDA tensor that is one launch of
    ``csrc/hmc_chain.cu`` (or it raises); on a CPU tensor the plain
    version runs."""
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    def move(x, b, generator):
        links = x.reshape(x.shape[0], shape.time_size, shape.space_size, 2)
        links, _, _, _ = hmc_chain(links, generator,
                                   _eps(shape.num_plaquettes, b), b,
                                   leapfrog, moves_per_rung)
        return links.reshape(x.shape)

    return move


def u1_log_z_exact_factorized(num_plaquettes: int, beta_init, beta_final):
    """Analytic anchor: per-plaquette ``log[I0(b1)e^{-b1} / I0(b0)e^{-b0}]``
    times the plaquette count (2-D U(1) factorizes up to the global charge
    constraint)."""
    from scipy.special import i0e

    return num_plaquettes * float(
        np.log(i0e(beta_final)) - np.log(i0e(beta_init)))
