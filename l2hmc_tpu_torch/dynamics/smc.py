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

With a ``mesh`` (``parallel/mesh.py``) the population is sharded over
'data' (the reference's ``chain_sharding`` of the particles, which XLA
turns into collectives): each rank reweights and moves its slice; the
log-weights (n floats per rung) are all-gathered, so the ESS, the
normalizations, log Z and the systematic indices are the unsharded
ladder's arithmetic on every rank; the resample all-gathers the particles
and each rank keeps its slice of the selected ones.  The moves draw the
global randomness and slice it, so on the CPU an n-rank ladder repeats the
one-process ladder's draws.

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

from l2hmc_tpu_torch.utils import trace


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
                    ess_threshold: float = 0.5, u0s=None, mesh=None):
    """Anneal particles ``x0`` (drawn at ``betas[0]``) up the beta ladder.

    ``move_fn(x, beta, generator) -> x`` applies one or more MCMC
    transitions targeting ``exp(-beta U)``.  Resampling triggers where
    ESS < ``ess_threshold * n``; the indices are always computed and the
    population ``where``-selected.  ``u0s``, one resampling offset per rung,
    replaces the generator's draws.

    Returns ``(SMCState, ess_trace (rungs,))`` with the final particles and
    the accumulated ``log Z(beta_end)/Z(beta_0)`` estimate.  With a
    ``mesh``, ``x0`` is this rank's slice of the population, the state's
    ``x`` and ``log_w`` are this rank's, and log Z and the ESS are the
    global ones (the same on every rank); ``move_fn`` should then draw for
    the global population (``make_u1_*_move(..., mesh=mesh)``).
    """
    from l2hmc_tpu_torch.parallel.mesh import gather_chains, shard_chains

    # float32 rungs, as the reference's jnp.linspace ladder
    betas = np.asarray(betas, dtype=np.float32)
    n = x0.shape[0] * (mesh.size("data") if mesh is not None else 1)
    dev = x0.device
    x = x0
    log_w_local = torch.zeros(x0.shape[0], dtype=x0.dtype, device=dev)
    log_z = torch.zeros((), dtype=x0.dtype, device=dev)
    ess_trace = []
    for r in range(len(betas) - 1):
        with trace.span("smc.rung"):
            b_prev, b_curr = betas[r], betas[r + 1]
            u0 = (u0s[r] if u0s is not None
                  else draw_resample_u0(generator, n, dev))
            with trace.span("smc.reweight"):
                # reweight: w *= exp(-(b_curr - b_prev) U(x))
                log_w_local = (log_w_local
                               - float(b_curr - b_prev) * potential_fn(x))
                log_w = gather_chains(log_w_local, mesh)

            # adaptive resampling (selected, not branched)
            with trace.span("smc.resample"):
                ess = effective_sample_size(log_w)
                do_resample = ess < ess_threshold * n
                idx = shard_chains(systematic_resample(generator, log_w, u0),
                                   mesh)
                x = torch.where(do_resample,
                                gather_chains(x, mesh).index_select(0, idx),
                                x)
                # log_z accumulates the mean weight at resampling time
                log_z = log_z + torch.where(do_resample, _log_mean(log_w),
                                            torch.zeros_like(log_z))
                log_w_local = torch.where(do_resample,
                                          torch.zeros_like(log_w_local),
                                          log_w_local)

            # MCMC move at the current temperature
            with trace.span("smc.move"):
                x = move_fn(x, float(b_curr), generator)
            ess_trace.append(ess)
    # fold in the remaining weights
    log_z = log_z + _log_mean(gather_chains(log_w_local, mesh))
    return (SMCState(x=x, log_w=log_w_local, log_z=log_z),
            torch.stack(ess_trace))


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


def _global_draws(generator, x, mesh):
    """One HMC transition's ``(v, u)`` for the global population, sliced to
    this rank's particles ``x``."""
    from l2hmc_tpu_torch.parallel.mesh import shard_chains

    b = x.shape[0] * (mesh.size("data") if mesh is not None else 1)
    kw = dict(generator=generator, dtype=x.dtype, device=x.device)
    v = torch.randn((b, *x.shape[1:]), **kw)
    u = torch.rand((b,), **kw)
    return shard_chains(v, mesh), shard_chains(u, mesh)


def make_u1_hmc_move(potential_fn, wrap_fn, num_plaquettes: int,
                     leapfrog: int, moves_per_rung: int, mesh=None):
    """SMC move for U(1): ``moves_per_rung`` HMC transitions at the
    volume-scaled step (:func:`_eps`).  ``move(x, beta, generator,
    draws=None)``; ``draws``, a ``(v, u)`` per transition, replaces the
    generator's.  With a ``mesh`` the generator's draws are the global
    population's, sliced to this rank's particles."""
    from l2hmc_tpu_torch.dynamics.hmc import hmc_transition

    def move(x, b, generator, draws=None):
        eps = _eps(num_plaquettes, b)
        for m in range(moves_per_rung):
            v, u = (draws[m] if draws is not None
                    else _global_draws(generator, x, mesh))
            out = hmc_transition(potential_fn, x, b, eps, leapfrog, generator,
                                 v=v, u=u)
            x = wrap_fn(out.x_out)
        return x

    return move


def hmc_chain_on_draws(links, v0s, v1s, us, eps, beta, num_leapfrog):
    """``ops.leapfrog.hmc_chain`` on injected draws, with the arguments of
    ``hmc_chain_reference``: the kernel of ``csrc/hmc_chain.cu`` on a CUDA
    tensor, the plain version on a CPU one."""
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    return hmc_chain(links, None, eps, beta, num_leapfrog, v0s.shape[0],
                     rand_arrays=(v0s, v1s, us))


def make_u1_fused_move(shape, leapfrog: int, moves_per_rung: int,
                       mesh=None, chain=None):
    """SMC move on the fused HMC chain of ``ops/leapfrog.py``: all
    ``moves_per_rung`` transitions of a rung in one call, at the step of
    :func:`make_u1_hmc_move`.  On a CUDA tensor that is one launch of
    ``csrc/hmc_chain.cu`` (or it raises) on the kernel's Philox stream; on
    a CPU tensor the plain version runs on the generator's draws for the
    global population, sliced to this rank's particles (so an n-rank move
    repeats the one-process move).

    On the card with a ``mesh`` of more than one 'data' rank, the kernel's
    Philox stream is keyed by (seed, chain, transition) with the chain
    counted on its rank, so each rank seeds its launch with the shared
    draw plus its 'data' coordinate, and the ranks' particles draw
    independent momenta.

    ``chain``, a function with ``hmc_chain_reference``'s arguments, runs
    each rung on the generator's draws on any device:
    ``hmc_chain_reference`` (the plain version) or
    :func:`hmc_chain_on_draws` (the kernel on injected draws), which hold
    the kernel against its plain version on the same draws."""
    from l2hmc_tpu_torch.ops.leapfrog import (draw_hmc_randomness, draw_seed,
                                              hmc_chain)
    from l2hmc_tpu_torch.parallel.mesh import shard_chains

    data = mesh.size("data") if mesh is not None else 1

    def move(x, b, generator):
        links = x.reshape(x.shape[0], shape.time_size, shape.space_size, 2)
        eps = _eps(shape.num_plaquettes, b)
        if links.is_cuda and chain is None:
            gen = generator
            if data > 1:
                gen = torch.Generator(device=links.device).manual_seed(
                    draw_seed(generator) + mesh.coords["data"])
            links = hmc_chain(links, gen, eps, b, leapfrog,
                              moves_per_rung)[0]
        else:
            full = draw_hmc_randomness(
                generator, moves_per_rung, x.shape[0] * data,
                shape.num_plaquettes, False, links.device)
            rand = [shard_chains(a.transpose(0, 1), mesh).transpose(0, 1)
                    .contiguous() for a in full]
            links = (chain or hmc_chain_on_draws)(links, *rand, eps, b,
                                                  leapfrog)[0]
        return links.reshape(x.shape)

    return move


def u1_log_z_exact_factorized(num_plaquettes: int, beta_init, beta_final):
    """Analytic anchor: per-plaquette ``log[I0(b1)e^{-b1} / I0(b0)e^{-b0}]``
    times the plaquette count (2-D U(1) factorizes up to the global charge
    constraint)."""
    from scipy.special import i0e

    return num_plaquettes * float(
        np.log(i0e(beta_final)) - np.log(i0e(beta_init)))
