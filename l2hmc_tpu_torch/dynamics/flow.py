"""Gauge-equivariant normalizing-flow sampler for 2-D U(1) lattice gauge
theory (port of ``l2hmc_tpu/dynamics/flow.py``).

The plaquette-coupling flow of Kanwar et al. (arXiv:2003.06413):

- A coupling layer picks an "active" stripe of plaquettes ``x = k (mod 4)``
  (or ``t = k (mod 4)``), moves each active plaquette angle
  ``P -> h(P | ctx)`` with a mixture-of-NCP circle diffeomorphism, and
  realizes the change on one link of each active plaquette: ``U0(t,x) +=
  h(P) - P`` (stripes in x) or ``U1(t,x) -= h(P) - P`` (stripes in t).
  The Jacobian on link space is triangular: ``logdet = sum_active log
  h'(P)``.
- The conditioner sees only the gauge-invariant ``(cos P, sin P)`` of the
  context stripes ``k+1, k+2``, through periodic convs (``networks/nets.py
  conv2d_periodic``, NCHW / OIHW) whose last layer starts at zero: the
  flow starts at the identity.
- NCP kernel ``phi -> 2 atan2(e^s sin(phi/2), cos(phi/2))`` with
  derivative ``e^s / (cos^2(phi/2) + e^{2s} sin^2(phi/2))``; a convex
  mixture of them, then a per-site rotation.

The base density is uniform on links.  Every Wilson-action evaluation goes
through ``ops/wilson.py``: the kernels of ``csrc/wilson.cu`` for CUDA links
(the reverse-KL loss runs the forward and backward kernels, importance
weights and the MH accept the action-only forward, the hybrid chain's HMC
the fused force), the plain ``WilsonAction`` for CPU links.

Randomness comes from a ``torch.Generator``, or is passed in: the base
samples ``z`` and uniforms of the ``*_with`` forms and the ``draws`` of the
chains, so a test can replay JAX's draws.  Parameters are an ``nn.Module``
(:class:`FlowParams`: one :class:`FlowLayer` per coupling, convs named as
the reference's ``c1``, ``h2..hD``, ``c2``); :func:`flow_params_from_numpy`
carries the reference's (HWIO convs) across.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from l2hmc_tpu_torch._device import resolve_device
from l2hmc_tpu_torch.lattice import u1
from l2hmc_tpu_torch.networks.nets import (_Conv, _he_conv, _hwio_to_oihw,
                                           conv2d_periodic)
from l2hmc_tpu_torch.ops import wilson

_TWO_PI = 2.0 * np.pi


def wilson_action(links: torch.Tensor) -> torch.Tensor:
    """Per-sample Wilson action of ``links (B, Lt, Lx, 2)`` through
    ``ops/wilson.py``: the kernels for CUDA links, the plain
    ``WilsonAction`` for CPU ones."""
    if links.is_cuda:
        return wilson.wilson_action_kernel(links)
    return wilson.wilson_action(links)


# ---------------------------------------------------------------------------
# Circle diffeomorphism: mixture of NCPs + rotation.
# ---------------------------------------------------------------------------


def _ncp_terms(phi, w, es):
    half = 0.5 * phi[..., None]
    s, c = torch.sin(half), torch.cos(half)
    val = torch.sum(w * 2.0 * torch.atan2(es * s, c), dim=-1)
    deriv = torch.sum(w * es / (c * c + es * es * s * s), dim=-1)
    return val, deriv


def ncp_mixture(phi: torch.Tensor, scales: torch.Tensor, logits: torch.Tensor,
                offset: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``phi (...,)`` angles; ``scales/logits (..., n_mix)``; ``offset
    (...,)``.  Returns ``(phi_out, log_deriv)``, ``phi_out`` wrapped to
    ``[-pi, pi)``."""
    val, deriv = _ncp_terms(phi, torch.softmax(logits, dim=-1),
                            torch.exp(scales))
    return u1.wrap(val + offset), torch.log(deriv)


def ncp_mixture_inverse(phi_out: torch.Tensor, scales: torch.Tensor,
                        logits: torch.Tensor, offset: torch.Tensor,
                        iters: int = 40) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert :func:`ncp_mixture` by ``iters`` bisection steps and one
    Newton polish.  Returns ``(phi_in, log_deriv_at_phi_in)``.

    The bisection runs without autograd (its iterates are piecewise
    constant in the parameters); the Newton step ``phi -= (h(phi) -
    target) / h'(phi)`` is recorded, which realizes the implicit-function
    derivative ``d phi_in / d theta = -(dh/dtheta) / h'``, so
    :func:`logq_of` trains by maximum likelihood."""
    w = torch.softmax(logits, dim=-1)
    es = torch.exp(scales)
    target = u1.wrap(phi_out - offset)
    with torch.no_grad():
        wd, esd, td = w.detach(), es.detach(), target.detach()
        lo = torch.full_like(td, -np.pi)
        hi = torch.full_like(td, np.pi)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            go_hi = _ncp_terms(mid, wd, esd)[0] < td
            lo = torch.where(go_hi, mid, lo)
            hi = torch.where(go_hi, hi, mid)
        phi0 = 0.5 * (lo + hi)
    val, deriv = _ncp_terms(phi0, w, es)
    phi_in = phi0 - (val - target) / deriv
    _, deriv_in = _ncp_terms(phi_in, w, es)
    return phi_in, torch.log(deriv_in)


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Static flow configuration (the reference's fields and defaults)."""

    time_size: int = 8
    space_size: int = 8
    num_layers: int = 16          # multiple of 8: 4 offsets x 2 orientations
    n_mix: int = 6                # NCP mixture components
    hidden_channels: int = 32     # conditioner CNN width
    kernel_size: int = 3
    conditioner_depth: int = 1    # hidden conv layers in each conditioner

    def __post_init__(self):
        # the mod-4 stripes (active / side-effect / context) must stay
        # distinct around the periodic boundary, or the Jacobian silently
        # stops being triangular
        if self.time_size % 4 or self.space_size % 4:
            raise ValueError(
                "FlowConfig requires lattice sides divisible by 4 "
                f"(got {self.time_size}x{self.space_size}): the mod-4 "
                "coupling stripes wrap inconsistently otherwise")

    @property
    def shape(self) -> u1.LatticeShape:
        return u1.LatticeShape(self.time_size, self.space_size)

    @property
    def layer_plan(self):
        """Layer i: ``(axis, offset)``: axis 1 = stripes in x (update U0),
        axis 0 = stripes in t (update U1); offsets rotate 0..3."""
        return tuple((1 if (i // 4) % 2 == 0 else 0, i % 4)
                     for i in range(self.num_layers))


def _stripe_masks(lt: int, lx: int, axis: int, offset: int, device=None):
    """``(active, context)`` 0/1 float masks ``(Lt, Lx)``: stripe ``offset``
    is active, stripes ``offset+1`` and ``offset+2`` condition; the
    side-effect stripe ``offset-1`` is neither."""
    if axis == 0:
        idx = torch.arange(lt, device=device)[:, None].expand(lt, lx)
    else:
        idx = torch.arange(lx, device=device)[None, :].expand(lt, lx)
    pos = idx % 4
    active = (pos == offset).to(torch.float32)
    ctx = ((pos == (offset + 1) % 4) | (pos == (offset + 2) % 4)).to(
        torch.float32)
    return active, ctx


class FlowLayer(nn.Module):
    """One coupling layer's conditioner: ``c1`` (2 -> hidden), ``h2..hD``
    (hidden -> hidden), ``c2`` (hidden -> 2 n_mix + 1), OIHW convs."""

    def __init__(self, convs):
        super().__init__()
        for name, (w, b) in convs.items():
            setattr(self, name, _Conv(w, b))


class FlowParams(nn.ModuleList):
    """The flow's layers, in :attr:`FlowConfig.layer_plan` order."""


def _layer_shapes(cfg: FlowConfig):
    """``{name: (cout, cin)}`` of one layer's convs, in creation order."""
    h, k_out = cfg.hidden_channels, 2 * cfg.n_mix + 1
    shapes = {"c1": (h, 2)}
    for d in range(2, cfg.conditioner_depth + 1):
        shapes[f"h{d}"] = (h, h)
    shapes["c2"] = (k_out, h)
    return shapes


def init_flow(generator: Optional[torch.Generator], cfg: FlowConfig,
              device=None) -> FlowParams:
    """He-normal conditioner convs, the output conv ``c2`` zero (the flow
    starts at the identity), on ``device`` (``None``: the card); the draws
    are made on the generator's device and moved."""
    device = resolve_device(device)
    where = generator.device if generator is not None else device
    k = cfg.kernel_size
    layers = []
    for _ in range(cfg.num_layers):
        convs = {}
        for name, (cout, cin) in _layer_shapes(cfg).items():
            w = _he_conv(generator, cout, cin, k, where)
            if name == "c2":
                w = torch.zeros_like(w)
            convs[name] = (w, torch.zeros(cout, device=where))
        layers.append(FlowLayer(convs))
    return FlowParams(layers).to(device)


def flow_params_from_numpy(tree, cfg: FlowConfig, device=None) -> FlowParams:
    """Port parameters from the reference's flow params (a list of
    ``{"c1": {"w", "b"}, ..., "c2": ...}`` with numpy or JAX leaves, HWIO
    conv weights) on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    if len(tree) != cfg.num_layers:
        raise ValueError(f"expected {cfg.num_layers} layers, got {len(tree)}")
    layers = []
    for layer in tree:
        if set(layer) != set(_layer_shapes(cfg)):
            raise ValueError(f"layer convs {sorted(layer)} do not match "
                             f"the config's {sorted(_layer_shapes(cfg))}")
        convs = {}
        for name in _layer_shapes(cfg):
            w = _hwio_to_oihw(np.asarray(layer[name]["w"], np.float32))
            convs[name] = (torch.tensor(w),
                           torch.tensor(np.asarray(layer[name]["b"],
                                                   np.float32)))
        layers.append(FlowLayer(convs))
    return FlowParams(layers).to(device)


def _conditioner(layer: FlowLayer, p: torch.Tensor, ctx: torch.Tensor,
                 cfg: FlowConfig):
    """Per-site ``(scales, logits, offset)`` from the context stripes'
    ``(cos P, sin P)``; the same in both directions (a layer never touches
    its own context)."""
    feats = torch.stack([torch.cos(p), torch.sin(p)], dim=1) * ctx
    h = F.gelu(conv2d_periodic(feats, layer.c1.w, layer.c1.b),
               approximate="tanh")
    for d in range(2, cfg.conditioner_depth + 1):
        conv = getattr(layer, f"h{d}")
        h = F.gelu(conv2d_periodic(h, conv.w, conv.b), approximate="tanh")
    out = conv2d_periodic(h, layer.c2.w, layer.c2.b).permute(0, 2, 3, 1)
    n = cfg.n_mix
    return out[..., :n], out[..., n:2 * n], out[..., -1]


def _shift_links(links, delta, axis, sign):
    """``links`` with ``sign * delta`` added to U0 (stripes in x) or
    subtracted from U1 (stripes in t), both wrapped."""
    u0, u1_ = links[..., 0], links[..., 1]
    if axis == 1:
        u0 = u0 + sign * delta
    else:
        u1_ = u1_ - sign * delta
    return torch.stack([u1.wrap(u0), u1.wrap(u1_)], dim=-1)


def _coupling_forward(layer, links, axis, offset, cfg):
    active, ctx = _stripe_masks(cfg.time_size, cfg.space_size, axis, offset,
                                links.device)
    p = u1.plaq_sums(links)
    scales, logits, t_off = _conditioner(layer, p, ctx, cfg)
    p_new, log_deriv = ncp_mixture(p, scales, logits, t_off)
    delta = u1.wrap(p_new - p) * active
    logdet = torch.sum(log_deriv * active, dim=(-2, -1))
    return _shift_links(links, delta, axis, 1.0), logdet


def flow_forward(params: FlowParams, links: torch.Tensor, cfg: FlowConfig):
    """Push ``links (B, Lt, Lx, 2)`` through all layers: ``(links_out,
    logdet (B,))``, the log-determinant of d(out)/d(in)."""
    logdet = torch.zeros(links.shape[0], device=links.device)
    for layer, (axis, offset) in zip(params, cfg.layer_plan):
        links, ld = _coupling_forward(layer, links, axis, offset, cfg)
        logdet = logdet + ld
    return links, logdet


def _coupling_inverse(layer, links, axis, offset, cfg):
    active, ctx = _stripe_masks(cfg.time_size, cfg.space_size, axis, offset,
                                links.device)
    p_out = u1.plaq_sums(links)
    scales, logits, t_off = _conditioner(layer, p_out, ctx, cfg)
    p_in, log_deriv = ncp_mixture_inverse(u1.wrap(p_out), scales, logits,
                                          t_off)
    delta = u1.wrap(u1.wrap(p_out) - p_in) * active
    logdet_inv = -torch.sum(log_deriv * active, dim=(-2, -1))
    return _shift_links(links, delta, axis, -1.0), logdet_inv


def flow_inverse(params: FlowParams, links: torch.Tensor, cfg: FlowConfig):
    """Pull ``links`` back through all layers in reverse: ``(z, logdet_inv
    (B,))``, ``flow_inverse(flow_forward(z)) == z`` to bisection
    tolerance."""
    logdet_inv = torch.zeros(links.shape[0], device=links.device)
    for layer, (axis, offset) in zip(reversed(list(params)),
                                     reversed(cfg.layer_plan)):
        links, ld = _coupling_inverse(layer, links, axis, offset, cfg)
        logdet_inv = logdet_inv + ld
    return links, logdet_inv


def _logq0(cfg: FlowConfig) -> float:
    return -cfg.shape.num_links * np.log(_TWO_PI)


def logq_of(params: FlowParams, links: torch.Tensor,
            cfg: FlowConfig) -> torch.Tensor:
    """Model log-density at arbitrary states, through the numerical
    inverse: ``log q(x) = log q0 + logdet_inv(x)``."""
    _, logdet_inv = flow_inverse(params, links, cfg)
    return _logq0(cfg) + logdet_inv


# ---------------------------------------------------------------------------
# Density, training, sampling
# ---------------------------------------------------------------------------


def draw_base(generator: Optional[torch.Generator], batch: int,
              cfg: FlowConfig, device=None) -> torch.Tensor:
    """``batch`` uniform base samples ``z (B, Lt, Lx, 2)`` in ``[-pi, pi)``
    from ``generator`` (on its device unless ``device`` says otherwise)."""
    if device is None:
        device = generator.device if generator is not None else None
    u = torch.rand((batch, cfg.time_size, cfg.space_size, 2),
                   generator=generator, device=device)
    return -np.pi + _TWO_PI * u


def sample_and_logq_with(params, z: torch.Tensor, cfg: FlowConfig):
    """``(x, log q(x))`` for the base samples ``z``: ``log q = log q0 -
    logdet``."""
    x, logdet = flow_forward(params, z, cfg)
    return x, _logq0(cfg) - logdet


def sample_and_logq(params, generator, batch: int, cfg: FlowConfig):
    """Draw ``batch`` configurations and their model log-density."""
    return sample_and_logq_with(
        params, draw_base(generator, batch, cfg, _param_device(params)), cfg)


def _param_device(params) -> torch.device:
    return next(params.parameters()).device


def _ess_frac(logw: torch.Tensor) -> torch.Tensor:
    return torch.exp(2 * torch.logsumexp(logw, 0)
                     - torch.logsumexp(2 * logw, 0)) / logw.shape[0]


def reverse_kl_loss_with(params, z: torch.Tensor, beta, cfg: FlowConfig,
                         action_fn=wilson_action):
    """``E_q[log q + beta S]`` (reverse KL up to log Z) on the base samples
    ``z``, and diagnostics ``{loss, ess_frac, plaq}``.  ``action_fn``
    replaces the Wilson action's dispatch (e.g. by the plain version on
    the card, to hold the kernels against it)."""
    x, logq = sample_and_logq_with(params, z, cfg)
    logp = -beta * action_fn(x)
    loss = torch.mean(logq - logp)
    logw = (logp - logq).detach()
    return loss, {"loss": loss.detach(), "ess_frac": _ess_frac(logw),
                  "plaq": torch.mean(u1.avg_plaquette(x.detach()))}


def reverse_kl_loss(params, generator, batch: int, beta, cfg: FlowConfig):
    """:func:`reverse_kl_loss_with` on ``batch`` fresh base samples."""
    return reverse_kl_loss_with(
        params, draw_base(generator, batch, cfg, _param_device(params)),
        beta, cfg)


@torch.no_grad()
def importance_weights_with(params, z: torch.Tensor, beta, cfg: FlowConfig):
    """Samples, self-normalized log-weights and the direct
    ``log Z = logmeanexp(-beta S - log q)`` on the base samples ``z``."""
    x, logq = sample_and_logq_with(params, z, cfg)
    logw = -beta * wilson_action(x) - logq
    lse = torch.logsumexp(logw, 0)
    return x, logw - lse, lse - np.log(z.shape[0])


def importance_weights(params, generator, batch: int, beta, cfg: FlowConfig):
    """:func:`importance_weights_with` on ``batch`` fresh base samples."""
    return importance_weights_with(
        params, draw_base(generator, batch, cfg, _param_device(params)),
        beta, cfg)


def forward_kl_loss(params, x_p: torch.Tensor, cfg: FlowConfig):
    """``-E_p[log q]``: maximum likelihood on target samples ``x_p`` (the
    mass-covering KL(p||q)), differentiable through the numerical
    inverse."""
    return -torch.mean(logq_of(params, x_p, cfg))


@torch.no_grad()
def independence_mh_chain(params, generator, x0: torch.Tensor,
                          logq0: torch.Tensor, beta, num_steps: int,
                          cfg: FlowConfig,
                          draws: Optional[Sequence] = None):
    """Flow-proposal independence Metropolis: accept ``x'`` with
    ``min(1, p(x') q(x) / (p(x) q(x')))``.  ``draws``, a ``(z, u)`` per
    step (base samples ``(B, Lt, Lx, 2)`` and uniforms ``(B,)``), replaces
    the generator's.

    Returns ``(x_final, plaq_trace (T, B), accept_trace (T, B))``."""
    b = x0.shape[0]
    x, logq = x0, logq0
    logp = -beta * wilson_action(x0)
    plaqs, accs = [], []
    for t in range(num_steps):
        if draws is not None:
            z, u = draws[t]
        else:
            z = draw_base(generator, b, cfg, x0.device)
            u = torch.rand((b,), generator=generator, device=x0.device)
        xp, logqp = sample_and_logq_with(params, z, cfg)
        logpp = -beta * wilson_action(xp)
        log_acc = (logpp - logp) + (logq - logqp)
        acc = torch.log(u) < log_acc
        x = torch.where(acc[:, None, None, None], xp, x)
        logq = torch.where(acc, logqp, logq)
        logp = torch.where(acc, logpp, logp)
        plaqs.append(u1.avg_plaquette(x))
        accs.append(acc.to(x.dtype))
    return x, torch.stack(plaqs), torch.stack(accs)


@torch.no_grad()
def flow_hmc_hybrid_chain(params, generator, links0: torch.Tensor, beta,
                          num_rounds: int, hmc_per_round: int, hmc_eps,
                          hmc_leapfrog: int, cfg: FlowConfig,
                          draws: Optional[Sequence] = None):
    """Hybrid kernel: each round runs ``hmc_per_round`` HMC transitions
    (on ``ops/wilson.py``'s potential: the fused force kernel for CUDA
    links) and then one flow independence proposal, its accept using
    ``q`` at the HMC-evolved state through the numerical inverse.
    ``draws``, per round ``(hmc, z, u)`` with ``hmc`` a ``(v, u)`` per HMC
    transition, replaces the generator's.

    Returns ``(links, q_trace (R, B), plaq_trace (R, B), flow_accept (R,
    B), hmc_accept (R,))``."""
    from l2hmc_tpu_torch.dynamics.hmc import hmc_transition

    b, lt, lx, _ = links0.shape
    pot = wilson.make_potential_fn(u1.LatticeShape(lt, lx))
    links = links0
    qs, plaqs, f_acc, h_acc = [], [], [], []
    for r in range(num_rounds):
        hmc_draws, z, u = draws[r] if draws is not None else (None,) * 3
        x = links.reshape(b, -1)
        probs = []
        for m in range(hmc_per_round):
            v, uh = hmc_draws[m] if hmc_draws is not None else (None, None)
            out = hmc_transition(pot, x, beta, hmc_eps, hmc_leapfrog,
                                 generator, v=v, u=uh)
            x = u1.wrap(out.x_out)
            probs.append(out.accept_prob)
        links = x.reshape(b, lt, lx, 2)
        if z is None:
            z = draw_base(generator, b, cfg, links.device)
            u = torch.rand((b,), generator=generator, device=links.device)
        xp, logqp = sample_and_logq_with(params, z, cfg)
        logq = logq_of(params, links, cfg)
        log_acc = (-beta * wilson_action(xp) + beta * wilson_action(links)
                   + logq - logqp)
        acc = torch.log(u) < log_acc
        links = torch.where(acc[:, None, None, None], xp, links)
        qs.append(u1.topological_charge(links))
        plaqs.append(u1.avg_plaquette(links))
        f_acc.append(acc.to(torch.float32))
        h_acc.append(torch.mean(torch.stack(probs)))
    return (links, torch.stack(qs), torch.stack(plaqs), torch.stack(f_acc),
            torch.stack(h_acc))
