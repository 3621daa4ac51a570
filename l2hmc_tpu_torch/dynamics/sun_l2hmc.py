"""Trainable L2HMC-style sampler on SU(N) lattice gauge groups (port of
``l2hmc_tpu/dynamics/sun_l2hmc.py``, its complex form).

- The momentum update is augmented with the (S, T, Q) structure of the
  flat kernel, acting on the su(N) algebra coefficients::

      p' = p * exp(eps/2 S) - eps/2 (exp(eps Q) F - T),   logdet += eps/2 sum(S)

  with ``F`` the left-translation force; linear in ``p`` with (S, T, Q)
  functions of the links only, so the log-Jacobian is exact.
- The position update stays the exponential map ``U <- exp(i d eps p.T)
  U`` (``torch.linalg.matrix_exp``, then QR reunitarization): a left
  translation, Haar-measure preserving, no Jacobian.
- One shared momentum net for both half-steps; the direction is drawn per
  chain and fused with where-selects.

The net is a pointwise MLP over per-link features: the force components,
Re/Im of the traces of the two plaquettes each link borders, and the
sinusoidal leapfrog-time encoding.  Its heads start at zero, so at init
the kernel is plain Lie-group HMC.  The loss is the squared-jump form
``ls/d - d/ls`` on the gauge-invariant plaquette-trace distance.

Links are complex64 ``(B, Lt, Lx, 2, N, N)``.  ``real_pairs=True`` (the
reference's TPU workaround) raises: CUDA computes complex64 (ROADMAP.md,
"Not to port").
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from l2hmc_tpu_torch._device import resolve_device
from l2hmc_tpu_torch.dynamics.sun_hmc import (
    _left_translate,
    _reunitarize,
    algebra_force,
)
from l2hmc_tpu_torch.lattice.sun import generators, sun_action, sun_plaquette
from l2hmc_tpu_torch.lattice.sun_nd import PAIRS_NOT_PORTED
from l2hmc_tpu_torch.train.gauge import Optimizer
from l2hmc_tpu_torch.train.schedules import make_lr_schedule


class SUNNetParams(nn.Module):
    """``relu(feats @ w1 + b1)`` then the heads ``w_s``, ``w_t``, ``w_q``."""

    def __init__(self, w1, b1, w_s, w_t, w_q):
        super().__init__()
        for name, t in (("w1", w1), ("b1", b1), ("w_s", w_s), ("w_t", w_t),
                        ("w_q", w_q)):
            setattr(self, name, nn.Parameter(torch.tensor(
                np.asarray(t, np.float32))))


class SUNL2HMCParams(nn.Module):
    def __init__(self, raw_eps, net: SUNNetParams):
        super().__init__()
        self.raw_eps = nn.Parameter(torch.tensor(np.asarray(raw_eps,
                                                            np.float32)))
        self.net = net


class SUNL2HMCConfig(NamedTuple):
    n: int = 2                 # SU(N)
    num_steps: int = 3         # leapfrog steps per transition
    eps_init: float = 0.1
    eps_cap: float = 0.5       # acceptance-cliff guard
    hidden: int = 32
    eps_trainable: bool = True
    # the reference's float32 (re, im) pair links: not ported (raises)
    real_pairs: bool = False


class SUNDraws(NamedTuple):
    """One transition's randomness: momenta ``p0 (B, Lt, Lx, 2, k)``,
    directions ``d (B,)`` in {+1, -1} and accept uniforms ``u (B,)``."""

    p0: torch.Tensor
    d: torch.Tensor
    u: torch.Tensor


def _n_feats(n: int) -> int:
    return n * n - 1 + 4 + 2  # force channels + 2 plaquette (re, im) + time


def _check(cfg: SUNL2HMCConfig):
    if cfg.real_pairs:
        raise NotImplementedError(PAIRS_NOT_PORTED)


def init_sun_l2hmc(generator: Optional[torch.Generator],
                   cfg: SUNL2HMCConfig, device=None,
                   normals: Optional[torch.Tensor] = None) -> SUNL2HMCParams:
    """``w1 = normals / sqrt(f)`` (``normals (f, hidden)`` drawn unless
    given), zero ``b1`` and zero heads, ``raw_eps = eps_init``."""
    _check(cfg)
    device = resolve_device(device)
    k, f = cfg.n * cfg.n - 1, _n_feats(cfg.n)
    if normals is None:
        normals = torch.randn((f, cfg.hidden), generator=generator,
                              device=generator.device if generator is not None
                              else device)
    zeros = torch.zeros((cfg.hidden, k))
    net = SUNNetParams(normals.cpu() / np.sqrt(f), torch.zeros(cfg.hidden),
                       zeros, zeros.clone(), zeros.clone())
    return SUNL2HMCParams(np.float32(cfg.eps_init), net).to(device)


def sun_params_from_numpy(tree, device=None) -> SUNL2HMCParams:
    """Port params from the reference's ``SUNL2HMCParams`` with numpy
    leaves (``raw_eps``; ``net`` with ``w1, b1, w_s, w_t, w_q``)."""
    net = SUNNetParams(*(np.asarray(getattr(tree.net, k), np.float32)
                         for k in ("w1", "b1", "w_s", "w_t", "w_q")))
    return SUNL2HMCParams(np.asarray(tree.raw_eps, np.float32), net).to(
        resolve_device(device))


def named_leaves(params: SUNL2HMCParams):
    """The tensors by their reference pytree path, in its flatten order."""
    out = {"raw_eps": params.raw_eps}
    for k in ("w1", "b1", "w_s", "w_t", "w_q"):
        out[f"net/{k}"] = getattr(params.net, k)
    return out


def _plaq_feats_from_tr(tr_re: torch.Tensor,
                        tr_im: torch.Tensor) -> torch.Tensor:
    """(Re, Im) of the traces/N of the two plaquettes each link borders:
    link (t,x,0) borders P(t,x) and P(t,x-1); link (t,x,1) P(t,x) and
    P(t-1,x).  ``(B, Lt, Lx, 2, 4)``."""
    f0 = torch.stack([tr_re, tr_im, torch.roll(tr_re, 1, dims=-1),
                      torch.roll(tr_im, 1, dims=-1)], dim=-1)
    f1 = torch.stack([tr_re, tr_im, torch.roll(tr_re, 1, dims=-2),
                      torch.roll(tr_im, 1, dims=-2)], dim=-1)
    return torch.stack([f0, f1], dim=-2)


def _plaq_tr(u: torch.Tensor):
    p = sun_plaquette(u)
    tr = torch.diagonal(p, dim1=-2, dim2=-1).sum(-1) / u.shape[-1]
    return tr.real, tr.imag


def make_sun_dynamics(cfg: SUNL2HMCConfig, beta):
    """The transition for SU(N) links ``(B, Lt, Lx, 2, N, N)``: a dict of
    ``transition(params, u, generator)``, ``transition_with(params, u,
    draws)`` (``SUNDraws``), ``integrate(params, u, p, direction)``,
    ``force(u)``, ``get_eps(params)`` and ``draw(generator, u)``."""
    _check(cfg)
    n, K = cfg.n, cfg.num_steps
    k = n * n - 1

    def action(u):
        return sun_action(u, beta)

    def get_eps(params):
        eps = params.raw_eps
        if cfg.eps_cap > 0:
            eps = torch.clamp(eps, max=cfg.eps_cap)
        return eps

    def force(u):
        """Differentiable where ``u`` is part of a graph (a train step's
        trajectory), as the reference's grad of its loss sees it."""
        return algebra_force(action, u, generators(n, u.device),
                             create_graph=u.requires_grad)

    def kinetic(p):
        return 0.5 * torch.sum(p * p, dim=(-4, -3, -2, -1))

    def net_stq(net: SUNNetParams, u, f_force, tau):
        re, im = _plaq_tr(u)
        feats = torch.cat([f_force, _plaq_feats_from_tr(re, im),
                           tau.expand(u.shape[:-2] + (2,))], dim=-1)
        h = torch.relu(feats @ net.w1 + net.b1)
        return torch.tanh(h @ net.w_s), h @ net.w_t, torch.tanh(h @ net.w_q)

    def update_p(params, u, p, tau, d_col, d_row, eps):
        """Fused-direction augmented momentum half-step (exact logdet)."""
        f = force(u)
        s, t, q = net_stq(params.net, u, f, tau)
        half_s = 0.5 * eps * s
        a = 0.5 * eps * (torch.exp(eps * q) * f - t)
        e = torch.exp(d_col * half_s)
        p_new = torch.where(d_col > 0, p * e - a, (p + a) * e)
        return p_new, d_row * torch.sum(half_s, dim=(-4, -3, -2, -1))

    def time_enc(i):
        ang = 2.0 * np.pi * i / max(K, 1)
        return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)

    def leapfrog(params, u, p, step, d_row, eps):
        d_col = d_row[:, None, None, None, None]
        idx = torch.where(d_row > 0, float(step), float(K - 1 - step))
        tau = time_enc(idx)[:, None, None, None, :]
        gens = generators(n, u.device)
        p, ld0 = update_p(params, u, p, tau, d_col, d_row, eps)
        u = _reunitarize(_left_translate(u, (d_col * eps) * p, gens))
        p, ld1 = update_p(params, u, p, tau, d_col, d_row, eps)
        return u, p, ld0 + ld1

    def integrate(params, u, p, direction):
        """Deterministic integration at fixed per-chain direction."""
        eps = get_eps(params)
        ld = torch.zeros(u.shape[0], device=u.device)
        for step in range(K):
            u, p, dl = leapfrog(params, u, p, step, direction, eps)
            ld = ld + dl
        return u, p, ld

    def transition_with(params: SUNL2HMCParams, u, draws: SUNDraws):
        u1, p1, sumlogdet = integrate(params, u, draws.p0, draws.d)
        h0 = action(u) + kinetic(draws.p0)
        h1 = action(u1) + kinetic(p1)
        prob = torch.exp(torch.clamp(h0 - h1 + sumlogdet, max=0.0))
        prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
        accept = draws.u < prob
        acc = accept.reshape(accept.shape + (1,) * (u.ndim - 1))
        return {"x_out": torch.where(acc, u1, u), "x_proposed": u1,
                "accept_prob": prob, "accept_mask": accept,
                "sumlogdet": sumlogdet}

    def draw(generator, u):
        kw = dict(generator=generator, device=u.device)
        b = u.shape[0]
        p0 = torch.randn(u.shape[:-2] + (k,), **kw)
        d = torch.where(torch.rand((b,), **kw) < 0.5, 1.0, -1.0)
        return SUNDraws(p0, d, torch.rand((b,), **kw))

    def transition(params, u, generator):
        return transition_with(params, u, draw(generator, u))

    return {"transition": transition, "transition_with": transition_with,
            "integrate": integrate, "force": force, "get_eps": get_eps,
            "draw": draw}


def plaq_trace_distance(u_a: torch.Tensor, u_b: torch.Tensor) -> torch.Tensor:
    """Gauge-invariant squared jump ``mean_plaq |tr P_a - tr P_b|^2 / N^2``
    per sample (complex links)."""
    if not torch.is_complex(u_a):
        raise NotImplementedError(PAIRS_NOT_PORTED)
    n = u_a.shape[-1]
    ta = torch.diagonal(sun_plaquette(u_a), dim1=-2, dim2=-1).sum(-1)
    tb = torch.diagonal(sun_plaquette(u_b), dim1=-2, dim2=-1).sum(-1)
    return torch.mean(torch.abs(ta - tb) ** 2, dim=(-2, -1)) / (n * n)


def make_sun_optimizer(lr_init: float, warmup_steps: int) -> Optimizer:
    """``clip_by_global_norm(1.0)`` then Adam on the schedule ``0 -> lr``
    over ``warmup_steps``, then ``lr * 0.96^(t/1000)`` (the CLI's
    optimizer)."""
    return Optimizer(make_lr_schedule(lr_init, 1000, 0.96, warmup_steps),
                     1.0, lambda name: True)


def make_sun_train_step(cfg: SUNL2HMCConfig, beta, optimizer: Optimizer,
                        loss_scale: float = 0.1):
    """``(train_step, dyn)``: ``train_step(params, opt_state, u,
    generator=None, draws=None) -> (params, opt_state, x_out, metrics)``,
    one ESJD step (loss ``mean(ls/d - d/ls)``, ``d`` the accepted
    plaquette-trace jump + 1e-4).  Gradients pass through ``nan_to_num``;
    ``raw_eps``'s is zeroed when ``eps_trainable`` is false.  The params
    update in place; ``opt_state`` is the port ``Optimizer``'s, from
    ``optimizer.init(named_leaves(params))``."""
    dyn = make_sun_dynamics(cfg, beta)

    def train_step(params: SUNL2HMCParams, opt_state, u, generator=None,
                   draws: Optional[SUNDraws] = None):
        if draws is None:
            draws = dyn["draw"](generator, u)
        out = dyn["transition_with"](params, u, draws)
        d = plaq_trace_distance(u, out["x_proposed"]) * out["accept_prob"]
        d = d + 1e-4
        loss = torch.mean(loss_scale / d - d / loss_scale)
        leaves = named_leaves(params)
        names = list(opt_state.mu)
        got = torch.autograd.grad(loss, [leaves[k] for k in names],
                                  allow_unused=True)
        grads = {k: torch.nan_to_num(g) if g is not None
                 else torch.zeros_like(leaves[k])
                 for k, g in zip(names, got)}
        if not cfg.eps_trainable:
            grads["raw_eps"] = torch.zeros_like(grads["raw_eps"])
        updates, opt_state = optimizer.update(grads, opt_state)
        with torch.no_grad():
            for k, v in updates.items():
                leaves[k].add_(v)
        metrics = {
            "loss": loss.detach(),
            "accept_prob": torch.mean(out["accept_prob"].detach()),
            "eps": dyn["get_eps"](params).detach().clone(),
        }
        return params, opt_state, out["x_out"].detach(), metrics

    return train_step, dyn
