"""Joint (K, eps) auto-tuning for HMC and the trained L2HMC kernel (port of
``l2hmc_tpu/train/autotune.py``).

HMC (:func:`tune_hmc`): for each K in the grid, dual averaging drives eps to
a target acceptance (``dynamics/nuts.py``), then timed probe chains at a
small multiplicative eps grid around it score cost-normalized
decorrelation: the ESS of the average-plaquette trace per wall second.

Trained kernel (:func:`tune_l2hmc`): anchored at HMC's optimal trajectory
length ``lambda* = K* eps*``; for each candidate K, ``eps = mult lambda*/K``
is frozen, a short probe training runs, and the same timed score picks K.

The probe's clock.  The score is effective samples per wall second, so a
probe must time the path that would serve the cell.  The JAX package times
a jitted scan of ``make_eval_chunk``; the port's ``make_eval_chunk`` is
eager and bound by the host's launches (tens of transitions per second), so
timing it would rank cells by their launch count, which grows with K.  So
a probe runs the cell's serving path on the card (:func:`probe_route`):

- an HMC cell: ``ops/leapfrog.py hmc_chain`` (``csrc/hmc_chain.cu``);
- a trained cell of the MLP, ``merge_v_halves``, ``u1`` family with fixed
  eps: ``ops/l2hmc_kernel.py l2hmc_chain`` (``csrc/l2hmc_chain.cu``);
- any other family (conv, local, the split integrator): ``make_eval_chunk``,
  eager and host-bound, so its score is a host-bound one.

This is the same function under the port's own compiled path: the fused
chains compute the transitions of ``make_eval_chunk``, and on CPU tensors
run their plain versions.  ``torch.cuda.synchronize()`` precedes every
clock read.  Draws come from one ``torch.Generator`` (the reference folds
its key per cell).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _trace(msg):
    """Per-cell progress to stderr: probe phases run for minutes at large
    volume with no output otherwise."""
    print(f"[tune {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    num_steps: int                # chosen K
    eps: float                    # chosen step size
    score: float                  # eff-samples/s at the chosen cell
    accept: float                 # measured acceptance at the chosen cell
    cells: Tuple[Dict, ...]       # every probed cell, for the record


def _lag1_ess(trace: np.ndarray) -> float:
    """Lag-1 autocorrelation ESS proxy ``(1 - rho1) / (1 + rho1)``, averaged
    over chains; for ranking cells, not for reporting absolute ESS."""
    x = trace - trace.mean(axis=0, keepdims=True)
    num = (x[1:] * x[:-1]).sum(axis=0)
    den = (x * x).sum(axis=0) + 1e-30
    rho1 = np.clip(num / den, -0.999, 0.999)
    return float(np.mean((1.0 - rho1) / (1.0 + rho1)))


def _hmc_cfg(base, k: int, eps: float):
    return dataclasses.replace(
        base, hmc=True, network_arch="zero", num_steps=k, eps_init=eps,
        eps_trainable=False, merge_v_halves=False)


def probe_route(cfg) -> str:
    """The path that serves ``cfg``'s cell and times its probe:
    ``'hmc_chain'``, ``'l2hmc_chain'`` or ``'eval_chunk'``."""
    if cfg.hmc:
        return "hmc_chain"
    if (cfg.network_arch == "mlp" and cfg.merge_v_halves
            and cfg.group == "u1" and cfg.action == "wilson"
            and not cfg.eps_trainable and not cfg.both_directions
            and not cfg.use_bf16 and cfg.hidden <= 256):
        return "l2hmc_chain"
    return "eval_chunk"


def _make_probe_chunk(cfg, chunk: int = 200, route: Optional[str] = None):
    """``run(params, x, beta, generator) -> (x, plaq trace (chunk, 64),
    mean accept)`` on the cell's serving path (:func:`probe_route`, or
    ``route``); ``run.route`` names it.  eps is read from ``params`` at
    each call, so every eps cell of a K shares one ``run``."""
    from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train.gauge import build_dynamics, make_eval_chunk

    route = route or probe_route(cfg)
    shape = cfg.shape
    if route == "eval_chunk":
        base = make_eval_chunk(cfg, chunk)

        def run(params, x, beta, generator):
            x, m = base(params, x, beta, generator)
            return x, m["plaqs"][:, :64], torch.mean(m["accept_prob"])
    else:
        from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_chain
        from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

        dyn_cfg = build_dynamics(cfg)[0]

        @torch.no_grad()
        def run(params, x, beta, generator):
            eps = float(get_eps(params, dyn_cfg))
            links = u1.to_links(x, shape)
            if route == "hmc_chain":
                links, pl, _, pr = hmc_chain(links, generator, eps, beta,
                                             cfg.num_steps, chunk)
            else:
                links, pl, _, pr = l2hmc_chain(
                    links, params, generator, eps, beta, cfg.num_steps,
                    chunk, bounded_q=cfg.bounded_q)
            return u1.to_flat(links), pl[:, :64], torch.mean(pr)

    run.route = route
    return run


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _timed_probe(cfg, params, x, beta, generator, steps: int,
                 chunk: int = 200, run=None):
    """Run ``steps`` transitions (after one untimed warm chunk); return
    ``(plaq trace (T, 64) numpy, mean accept, wall seconds, x)``."""
    if run is None:
        run = _make_probe_chunk(cfg, chunk)
    x, _, acc = run(params, x, beta, generator)
    float(acc)
    traces, accs = [], []
    _sync(x)
    t0 = time.perf_counter()
    for _ in range(max(steps // chunk, 1)):
        x, pl, acc = run(params, x, beta, generator)
        traces.append(pl)
        accs.append(acc)
    _sync(x)
    wall = time.perf_counter() - t0
    trace = torch.cat(traces).double().cpu().numpy()
    return trace, float(torch.stack(accs).double().mean()), wall, x


@torch.no_grad()
def _da_tune_eps(cfg, x, beta, generator, da_steps: int,
                 target: float) -> float:
    """Dual-averaging eps search at fixed K over the dynamics transition;
    the controller's state stays on the device, read once at the end."""
    from l2hmc_tpu_torch.dynamics.nuts import (
        dual_averaging_init, dual_averaging_update,
    )
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train.gauge import build_dynamics, init_params

    params = init_params(cfg, generator, x.device)
    _, dyn = build_dynamics(cfg)
    da = dual_averaging_init(float(cfg.eps_init), x.device)
    for _ in range(da_steps):
        params.raw_eps.copy_(torch.exp(da.log_eps))
        out = dyn["transition"](params, x, beta, generator)
        da = dual_averaging_update(da, torch.mean(out.accept_prob),
                                   target=target)
        x = u1.wrap(out.x_out)
    return float(torch.exp(da.log_eps_avg))


def _probe_score(trace: np.ndarray, wall: float, chains: int,
                 estimator: str) -> float:
    """eff-samples/s of a probe trace: ``'sokal'`` the production FFT/Sokal
    ESS (``analysis/stats.calc_ess``, the estimator the final comparison
    is scored with), ``'lag1'`` the cheap proxy."""
    if estimator == "lag1":
        ess = _lag1_ess(trace)
    else:
        from l2hmc_tpu_torch.analysis import stats

        ess = float(np.mean([stats.calc_ess(trace[:, c])
                             for c in range(trace.shape[1])]))
    return ess * trace.shape[0] * chains / wall


def _tile_chains(x: torch.Tensor, n: int) -> torch.Tensor:
    """Tile a ``(chains, x_dim)`` state up to ``n`` chains (production-batch
    probes: small batches are latency-bound and over-rank fine-step
    cells)."""
    if n <= x.shape[0]:
        return x[:n]
    reps = -(-n // x.shape[0])
    return x.repeat(reps, 1)[:n]


def tune_hmc(base_cfg, x, beta: float, generator,
             k_grid: Sequence[int] = (3, 4, 5, 6, 8), da_steps: int = 300,
             probe_steps: int = 1000, target_accept: float = 0.8,
             eps_grid: Sequence[float] = (0.85, 1.0, 1.15),
             estimator: str = "sokal", probe_chains: int = 0) -> TuneResult:
    """Joint (K, eps) search for plain HMC.

    ``base_cfg`` fixes the lattice and chains; ``x`` is a thermalized chain
    state ``(chains, x_dim)`` on the device to tune on.  Per K: dual
    averaging on ``x`` finds the eps of the target acceptance, then each
    ``eps_grid`` multiple is probe-scored at ``probe_chains`` (``x`` tiled;
    0: the config's chains), all on one probe chain state."""
    from l2hmc_tpu_torch.train.gauge import init_params

    n_probe = probe_chains or base_cfg.num_chains
    x_probe = _tile_chains(x, n_probe)
    probe_cfg_chains = dataclasses.replace(base_cfg, num_chains=n_probe)

    cells = []
    best = None
    for k in k_grid:
        cfg_k = _hmc_cfg(base_cfg, k, base_cfg.eps_init)
        eps_da = _da_tune_eps(cfg_k, x, beta, generator, da_steps,
                              target_accept)
        probe_run = _make_probe_chunk(_hmc_cfg(probe_cfg_chains, k, eps_da))
        for mult in eps_grid:
            eps_k = eps_da * mult
            cfg_k = _hmc_cfg(probe_cfg_chains, k, eps_k)
            params = init_params(cfg_k, generator, x.device)
            trace, acc, wall, x_probe = _timed_probe(
                cfg_k, params, x_probe, beta, generator, probe_steps,
                run=probe_run)
            score = _probe_score(trace, wall, n_probe, estimator)
            cell = {"K": k, "eps": round(eps_k, 5), "accept": round(acc, 4),
                    "score": round(score, 1), "eps_da": round(eps_da, 5),
                    "probe_s": round(wall, 4), "route": probe_run.route}
            cells.append(cell)
            _trace(f"hmc cell K={k} eps={eps_k:.4f}: score {score:.0f} "
                   f"acc {acc:.3f} ({probe_run.route}, {wall:.3f} s)")
            if best is None or score > best[0]:
                best = (score, k, eps_k, acc)
    return TuneResult(num_steps=best[1], eps=round(best[2], 5),
                      score=best[0], accept=best[3], cells=tuple(cells))


def tune_l2hmc(base_cfg, generator, hmc_opt: TuneResult,
               k_grid: Sequence[int] = (2, 3, 4, 5),
               probe_train_steps: int = 2000, probe_steps: int = 1000,
               eps_grid: Sequence[float] = (0.8, 1.0, 1.2),
               estimator: str = "sokal", probe_chains: int = 0,
               probe_seeds: int = 1, device=None) -> TuneResult:
    """Choose the trained kernel's (K, eps) around HMC's optimal trajectory
    length ``lambda* = K* eps*``.

    Per K and ``mult`` in ``eps_grid``, ``eps = mult lambda*/K`` is frozen,
    ``probe_train_steps`` train steps run (in chunks of 250, the base
    config's beta anneal) from a fresh state on ``device`` (``None``: the
    first CUDA device), and the timed probe scores the trained params at
    ``beta_final``; ``probe_seeds`` > 1 averages over trainings.  Coarse-K
    cells need O(10k) training steps before the conditioners rescue their
    acceptance: pass the production length where the hardware affords it.
    """
    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.train.gauge import init_train_state, make_train_chunk

    device = resolve_device(device)
    lam = hmc_opt.num_steps * hmc_opt.eps
    n_probe = probe_chains or base_cfg.num_chains
    cells = []
    best = None
    for k in k_grid:
        cfg_k0 = dataclasses.replace(
            base_cfg, num_steps=k, eps_init=lam / k, eps_trainable=False,
            train_steps=probe_train_steps)
        chunk = make_train_chunk(cfg_k0, 250)
        probe_run = _make_probe_chunk(
            dataclasses.replace(cfg_k0, num_chains=n_probe))
        for mult in eps_grid:
            eps_k = mult * lam / k
            cfg_k = dataclasses.replace(cfg_k0, eps_init=eps_k)
            probe_cfg = dataclasses.replace(cfg_k, num_chains=n_probe)
            seed_scores, seed_accs, seed_taccs, walls = [], [], [], []
            for _ in range(probe_seeds):
                state = init_train_state(cfg_k, generator, device)
                for _ in range(max(probe_train_steps // 250, 1)):
                    state, m = chunk(state, generator)
                seed_taccs.append(float(m["accept_prob"][-1]))
                trace, acc, wall, _ = _timed_probe(
                    probe_cfg, state.params, _tile_chains(state.x, n_probe),
                    base_cfg.beta_final, generator, probe_steps,
                    run=probe_run)
                seed_scores.append(
                    _probe_score(trace, wall, n_probe, estimator))
                seed_accs.append(acc)
                walls.append(wall)
            score = float(np.mean(seed_scores))
            acc = float(np.mean(seed_accs))
            cell = {"K": k, "eps": round(eps_k, 5), "accept": round(acc, 4),
                    "accept_train_end": round(float(np.mean(seed_taccs)), 4),
                    "score": round(score, 1),
                    "seed_scores": [round(s, 1) for s in seed_scores],
                    "probe_s": round(float(np.mean(walls)), 4),
                    "route": probe_run.route}
            cells.append(cell)
            _trace(f"l2hmc cell K={k} eps={eps_k:.4f}: score {score:.0f} "
                   f"acc {acc:.3f} (train-end {cell['accept_train_end']}; "
                   f"{probe_run.route})")
            if best is None or score > best[0]:
                best = (score, k, eps_k, acc)
    return TuneResult(num_steps=best[1], eps=round(best[2], 5),
                      score=best[0], accept=best[3], cells=tuple(cells))
