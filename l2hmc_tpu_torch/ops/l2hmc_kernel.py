"""Fused TRAINED L2HMC chains (U(1)): shared math, plain version, wrappers.

Port of ``l2hmc_tpu/ops/l2hmc_kernel.py``: ``merge_v_halves`` integrator,
``group='u1'`` (periodic cos/sin features and the circle diffeomorphism with
exact log-Jacobian), ``bounded_q``, per-chain random direction.  One call
runs ``N`` transitions — K+1 merged momentum kicks and 2K masked position
half-updates each, then the MH accept with non-finite rejection and,
optionally, one exact instanton hop — and returns the final links and
``(N, B)`` traces.  Two conditioner families:

- the MLP (``make_mlp_net``): :func:`pack_weights` de-interleaves the
  trained parameters (the flat state interleaves directions, ``index =
  (t*Lx + s)*2 + mu``) into per-direction blocks; :func:`l2hmc_chain`
  launches ``csrc/l2hmc_chain.cu``;
- the local 5-point stencil (``make_local_flat_net``, ``local_layers > 0``
  in the shared math): :func:`pack_local_weights`; :func:`l2hmc_local_chain`
  launches ``csrc/l2hmc_local_chain.cu``.

Two modes serve the cost decomposition (``l2hmc_tpu_torch/benchmarks``):
``ablate_nets=True`` sets S = T = Q = 0 without computing the features, the
conditioner or its heads, while the rest of the transition (circle map,
log-Jacobian, masks, direction fusion, exp factors) still runs; and the MLP
family's ``precision='bf16'`` stores the six matmul weights
(:data:`MATMUL_WEIGHTS`) as bfloat16, rounds each activation to bfloat16 at
its product and sums in float32.

:func:`l2hmc_chain_reference` is the plain PyTorch version of both families
and modes; the wrappers run it for CPU tensors.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import functools
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from l2hmc_tpu_torch.networks.nets import matmul, stencil_head, stencil_layer
from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.leapfrog import (
    CALL_SPAN,
    H100_SMEM_OPTIN,
    LAUNCH_SPAN,
    SEED_SPAN,
    _energy_change,
    _grad_flat,
    _hop_math,
    _join_links,
    _potential_fields,
    _select,
    _split_links,
    _winding_flat,
    _wrap,
    check_cuda_input,
    check_links,
    draw_seed,
)
from l2hmc_tpu_torch.utils import trace

_TWO_PI = 2.0 * np.pi
# the span of a chain call's weight preparation (utils/trace.py)
WEIGHTS_SPAN = "chain.weights"

# ordered weight-array names (the kernel receives them in this order)
WEIGHT_NAMES = (
    # XNet: merged input block, time rows, trunk, merged heads, coeffs
    "xin", "xt", "xb",
    "xh_w", "xh_b", "xhead", "xheadb0", "xheadb1",
    "xcs0", "xcs1", "xct0", "xct1",
    # VNet
    "vin", "vt", "vb",
    "vh_w", "vh_b", "vhead", "vheadb0", "vheadb1",
    "vcs0", "vcs1", "vct0", "vct1",
    # per-step hold masks, per direction (K, d)
    "mask0", "mask1",
)

# the conditioner matmul operands: stored bfloat16 under precision='bf16'
MATMUL_WEIGHTS = ("xin", "xh_w", "xhead", "vin", "vh_w", "vhead")
PRECISIONS = ("f32", "bf16")


def _deinterleave_rows(w, x_dim):
    """(x_dim, h) rows in interleaved mu order -> two (d, h) blocks."""
    if w.shape[0] != x_dim:
        raise ValueError(f"expected {x_dim} rows, got {w.shape[0]}")
    return w[0::2], w[1::2]


def _deinterleave_cols(w, x_dim):
    """(h, 3*x_dim) head columns [S | T | Q] -> two (h, 3d) blocks with the
    same [S | T | Q] order per direction."""
    h = w.shape[0]
    w3 = w.reshape(h, 3, x_dim // 2, 2)
    return w3[..., 0].reshape(h, -1), w3[..., 1].reshape(h, -1)


def pack_weights(params, x_dim: int,
                 precision: str = "f32") -> Tuple[torch.Tensor, ...]:
    """De-interleave trained MLP ``DynamicsParams`` into kernel blocks.

    XNet ``in_w`` rows are ``[v | cos-feats | sin-feats | t (2)]``; VNet rows
    ``[cos | sin | grad | t (2)]``.  The six per-direction input blocks stack
    into one ``(6d, h)`` operand (row order = the feature concat of the
    transition math) and the two head blocks into one ``(h, 6d)`` operand
    ``[dir0 | dir1]``.  Returns contiguous tensors in :data:`WEIGHT_NAMES`
    order, detached (the chain is sampling-only): float32, except the
    :data:`MATMUL_WEIGHTS` under ``precision='bf16'``, which are bfloat16.
    The bf16 chain is still an exact MH sampler: the forward map and its
    log-Jacobian use the same rounded S, T and Q.  A net with an aux input
    (``aux_dim > 0``, the VAE's) raises: the chain has no slot for it.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}: "
                         f"{precision!r}")
    d2 = x_dim
    vals = {}
    for p, net in (("x", params.xnet), ("v", params.vnet)):
        if getattr(getattr(net, "spec", None), "aux_dim", 0):
            raise ValueError(
                f"the {p}net takes an aux input (aux_dim="
                f"{net.spec.aux_dim}): the fused chain has no aux slot")
        in_w = net.in_w.detach()
        a0, a1 = _deinterleave_rows(in_w[:d2], d2)
        b0, b1 = _deinterleave_rows(in_w[d2:2 * d2], d2)
        c0, c1 = _deinterleave_rows(in_w[2 * d2:3 * d2], d2)
        head0, head1 = _deinterleave_cols(net.head_w.detach(), d2)
        hb = net.head_b.detach().reshape(3, d2 // 2, 2)
        cs = net.coeff_scale.detach().reshape(d2 // 2, 2)
        ct = net.coeff_transformation.detach().reshape(d2 // 2, 2)
        vals.update({
            # xnet rows: [w0 | w1 | m0 cos y0 | m1 cos y1 | m0 sin y0 |
            # m1 sin y1]; vnet rows: [cos y0 | cos y1 | sin y0 | sin y1 |
            # g0 | g1] — both are the slot order of in_w, de-interleaved
            p + "in": torch.cat([a0, a1, b0, b1, c0, c1], dim=0),
            p + "t": in_w[3 * d2:3 * d2 + 2],
            p + "b": net.in_b.detach()[None, :],
            p + "h_w": net.h_layer.w.detach(),
            p + "h_b": net.h_layer.b.detach()[None, :],
            p + "head": torch.cat([head0, head1], dim=1),
            p + "headb0": hb[..., 0].reshape(1, -1),
            p + "headb1": hb[..., 1].reshape(1, -1),
            p + "cs0": cs[:, 0][None, :], p + "cs1": cs[:, 1][None, :],
            p + "ct0": ct[:, 0][None, :], p + "ct1": ct[:, 1][None, :],
        })
    m = params.masks.detach().reshape(params.masks.shape[0], d2 // 2, 2)
    vals["mask0"] = m[..., 0]
    vals["mask1"] = m[..., 1]
    mm_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return tuple(vals[n].to(mm_dtype if n in MATMUL_WEIGHTS
                            else torch.float32).contiguous()
                 for n in WEIGHT_NAMES)


def local_weight_names(num_layers: int) -> Tuple[str, ...]:
    """Ordered weight names of the local (5-point stencil) conditioner
    family; :func:`l2hmc_local_chain` hands the kernel the net weights in
    this order, flattened into one array."""
    names = []
    for n in ("x", "v"):
        names += [n + "s0w", n + "s0t", n + "s0b"]
        for i in range(1, num_layers):
            names += [f"{n}s{i}w", f"{n}s{i}b"]
        names += [n + "hw", n + "hb", n + "cs", n + "ct"]
    names += ["mask0", "mask1"]
    return tuple(names)


def pack_local_weights(params, x_dim: int,
                       num_layers: int) -> Tuple[torch.Tensor, ...]:
    """``make_local_flat_net`` DynamicsParams -> tensors in
    :func:`local_weight_names` order (contiguous float32, detached).

    The stencil family is direction-split by construction (its channels are
    the direction halves), so only the per-step masks are de-interleaved.
    Shapes: ``s0w (5, cin, c)``, ``s0t (2, c)``, ``s{i}w (5, c, c)``, biases
    ``(c,)``, ``hw (c, 6)`` with outputs ``[S0 S1 T0 T1 Q0 Q1]``, ``hb
    (6,)``, ``cs``/``ct (2,)``, masks ``(K, d)``.
    """
    vals = {}
    for n, net in (("x", params.xnet), ("v", params.vnet)):
        st = net.stencils()
        if len(st) != num_layers:
            raise ValueError(f"num_layers={num_layers}, the {n}net has "
                             f"{len(st)} stencil layers")
        vals[n + "s0w"] = st[0].w
        vals[n + "s0t"] = st[0].wt
        vals[n + "s0b"] = st[0].b
        for i in range(1, num_layers):
            vals[f"{n}s{i}w"] = st[i].w
            vals[f"{n}s{i}b"] = st[i].b
        vals[n + "hw"] = net.head.w
        vals[n + "hb"] = net.head.b
        vals[n + "cs"] = net.coeff_scale
        vals[n + "ct"] = net.coeff_transformation
    m = params.masks.reshape(params.masks.shape[0], x_dim // 2, 2)
    vals["mask0"] = m[..., 0]
    vals["mask1"] = m[..., 1]
    return tuple(vals[k].detach().to(torch.float32).contiguous()
                 for k in local_weight_names(num_layers))


# ---------------------------------------------------------------------------
# Shared transition math
# ---------------------------------------------------------------------------


def _mm(a, w):
    """``a @ w``, in bf16 (:func:`matmul`) for bfloat16 weights."""
    return matmul(a, w.float(), bf16=w.dtype == torch.bfloat16)


def _heads(hh, W, net, bounded_q):
    """Trunk output -> per-direction (S, T, Q); one merged ``(h, 6d)``
    matmul for both directions."""
    hm = _mm(hh, getattr(W, net + "head"))
    d3 = hm.shape[1] // 2
    h0 = hm[:, :d3] + getattr(W, net + "headb0")
    h1 = hm[:, d3:] + getattr(W, net + "headb1")
    d = d3 // 3
    out = []
    for hi, sfx in ((h0, "0"), (h1, "1")):
        s_raw, t_raw, q_raw = hi[:, :d], hi[:, d:2 * d], hi[:, 2 * d:]
        s = torch.tanh(s_raw) * torch.exp(getattr(W, net + "cs" + sfx))
        if bounded_q:
            q_raw = torch.tanh(q_raw)
        q = q_raw * torch.exp(getattr(W, net + "ct" + sfx))
        out.append((s, t_raw, q))
    return out  # [(s0, t0, q0), (s1, t1, q1)]


def _trunk(pre, W, net):
    hh = torch.relu(pre)
    return torch.relu(_mm(hh, getattr(W, net + "h_w"))
                      + getattr(W, net + "h_b"))


def _tau_term(tau, Wt):
    """(b, 2) time encoding times the (2, h) time rows."""
    return tau[:, 0:1] * Wt[0][None, :] + tau[:, 1:2] * Wt[1][None, :]


def _time_enc(idx, K):
    ang = _TWO_PI * idx / K
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def _circle_scale(x, a):
    """``2 atan2(exp(a) sin(x/2), cos(x/2))`` with exact log-Jacobian
    ``a - log(cos^2(x/2) + exp(2a) sin^2(x/2))``."""
    s2, c2 = torch.sin(0.5 * x), torch.cos(0.5 * x)
    ea = torch.exp(a)
    y = 2.0 * torch.atan2(ea * s2, c2)
    logdet = a - torch.log(c2 * c2 + ea * ea * s2 * s2)
    return y, logdet


def _make_mlp_nets(W, bounded_q):
    """vnet/xnet closures of the MLP conditioner on the dir-split halves."""

    def vnet(trig, gg0, gg1, tau):
        cy0, cy1, sy0, sy1 = trig
        feats = torch.cat([cy0, cy1, sy0, sy1, gg0, gg1], dim=1)
        pre = _mm(feats, W.vin) + _tau_term(tau, W.vt) + W.vb
        return _heads(_trunk(pre, W, "v"), W, "v", bounded_q)

    def xnet(ww0, ww1, trig, m0, m1, tau):
        cy0, cy1, sy0, sy1 = trig
        feats = torch.cat(
            [ww0, ww1, m0 * cy0, m1 * cy1, m0 * sy0, m1 * sy1], dim=1)
        pre = _mm(feats, W.xin) + _tau_term(tau, W.xt) + W.xb
        return _heads(_trunk(pre, W, "x"), W, "x", bounded_q)

    return vnet, xnet


def _make_stencil_nets(W, lx, bounded_q, local_layers):
    """vnet/xnet closures of the local 5-point stencil conditioner
    (``make_local_flat_net`` math) on the dir-split halves; ``W`` holds
    :func:`local_weight_names` tensors.  Channel order is the reference's
    ``split_dir`` concat: VNet ``[cos y0, cos y1, sin y0, sin y1, g0, g1]``,
    XNet ``[w0, w1, m0 cos y0, m1 cos y1, m0 sin y0, m1 sin y1]``."""

    def apply_net(p, chans, tau):
        y = stencil_layer(chans, getattr(W, p + "s0w"), getattr(W, p + "s0b"),
                          lx, tau, getattr(W, p + "s0t"))
        for i in range(1, local_layers):
            y = stencil_layer(y, getattr(W, f"{p}s{i}w"),
                              getattr(W, f"{p}s{i}b"), lx)
        return stencil_head(y, getattr(W, p + "hw"), getattr(W, p + "hb"),
                            getattr(W, p + "cs"), getattr(W, p + "ct"),
                            bounded_q)

    def vnet(trig, gg0, gg1, tau):
        cy0, cy1, sy0, sy1 = trig
        return apply_net("v", [cy0, cy1, sy0, sy1, gg0, gg1], tau)

    def xnet(ww0, ww1, trig, m0, m1, tau):
        cy0, cy1, sy0, sy1 = trig
        return apply_net("x", [ww0, ww1, m0 * cy0, m1 * cy1, m0 * sy0,
                               m1 * sy1], tau)

    return vnet, xnet


def _l2hmc_transition_math(x0, x1, v0, v1, dsign, u, W, eps, beta, K, lx,
                           bounded_q, pot0, sinp, chg0, cosp, local_layers=0,
                           ablate_nets=False):
    """One trained-L2HMC transition (merge_v_halves, u1) on flat halves.

    ``dsign (B,)`` in {+1,-1}; ``u (B,)`` accept uniforms; ``W`` a namespace
    of :data:`WEIGHT_NAMES` tensors (MLP) or, with ``local_layers > 0``, of
    :func:`local_weight_names` tensors (stencil conditioner of that depth);
    ``pot0/sinp/chg0/cosp`` the carried fields of the input state.
    ``ablate_nets=True``: S = T = Q = 0 and neither the link features nor
    the conditioner are computed (only the masks of ``W`` are read).
    Returns ``(x0', x1', prob, pot, sinp, chg, cosp)`` of the output state.
    """
    d_col = dsign[:, None]
    fwd = d_col > 0
    g0, g1 = _grad_flat(sinp, lx)
    g0, g1 = beta * g0, beta * g1
    y0, y1, w0, w1 = x0, x1, v0, v1
    sumlogdet = torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    pot1, sinp1, cosp1, chg1 = pot0, sinp, cosp, chg0
    if ablate_nets:
        def vnet(*_):
            z = torch.zeros_like(x0)
            return [(z, z, z), (z, z, z)]

        xnet = vnet

        def link_trig(yy0, yy1):
            return None
    else:
        if local_layers > 0:
            vnet, xnet = _make_stencil_nets(W, lx, bounded_q, local_layers)
        else:
            vnet, xnet = _make_mlp_nets(W, bounded_q)

        def link_trig(yy0, yy1):
            return (torch.cos(yy0), torch.cos(yy1), torch.sin(yy0),
                    torch.sin(yy1))

    def kick(trig, w0_, w1_, g0_, g1_, tau, factor, ld):
        """Merged momentum kick, direction-fused (l2hmc.py update_v)."""
        (s0, t0, q0), (s1, t1, q1) = vnet(trig, g0_, g1_, tau)
        out = []
        for (w_, s_, t_, q_, g_) in ((w0_, s0, t0, q0, g0_),
                                     (w1_, s1, t1, q1, g1_)):
            hs = factor * eps * s_
            a = factor * eps * (torch.exp(eps * q_) * g_ - t_)
            e = torch.exp(d_col * hs)
            out.append(torch.where(fwd, w_ * e - a, (w_ + a) * e))
            ld = ld + dsign * torch.sum(hs, dim=1)
        return out[0], out[1], ld

    def xhalf(y0_, y1_, w0_, w1_, hold0, hold1, tau, ld, trig=None):
        """One masked position half-update on the torus (update_x, u1)."""
        if trig is None:
            trig = link_trig(y0_, y1_)
        (s0, t0, q0), (s1, t1, q1) = xnet(w0_, w1_, trig, hold0, hold1, tau)
        outs = []
        for (y_, w_, s_, t_, q_, hold) in (
                (y0_, w0_, s0, t0, q0, hold0), (y1_, w1_, s1, t1, q1, hold1)):
            es = eps * s_
            b = eps * (torch.exp(eps * q_) * w_ + t_)
            u_in = torch.where(fwd, y_, _wrap(y_ - b))
            y2, ld_e = _circle_scale(u_in, d_col * es)
            upd = torch.where(fwd, _wrap(y2 + b), y2)
            outs.append(hold * y_ + (1.0 - hold) * upd)
            ld = ld + torch.sum((1.0 - hold) * ld_e, dim=1)
        return outs[0], outs[1], ld

    for step in range(K):
        factor = 0.5 if step == 0 else 1.0
        t_fwd = 0.0 if step == 0 else step - 0.5
        t_bwd = float(K - 1) if step == 0 else K - 0.5 - step
        tau_v = _time_enc(torch.where(dsign > 0, t_fwd, t_bwd), K)
        trig = link_trig(y0, y1)
        w0, w1, sumlogdet = kick(trig, w0, w1, g0, g1, tau_v, factor,
                                 sumlogdet)

        tau_x = _time_enc(torch.where(dsign > 0, float(step),
                                      float(K - 1 - step)), K)
        hold1_0 = torch.where(fwd, W.mask0[step][None, :],
                              1.0 - W.mask0[K - 1 - step][None, :])
        hold1_1 = torch.where(fwd, W.mask1[step][None, :],
                              1.0 - W.mask1[K - 1 - step][None, :])
        y0, y1, sumlogdet = xhalf(y0, y1, w0, w1, hold1_0, hold1_1, tau_x,
                                  sumlogdet, trig=trig)
        y0, y1, sumlogdet = xhalf(y0, y1, w0, w1, 1.0 - hold1_0,
                                  1.0 - hold1_1, tau_x, sumlogdet)

        pot1, sinp1, cosp1, chg1 = _potential_fields(y0, y1, lx)
        g0, g1 = _grad_flat(sinp1, lx)
        g0, g1 = beta * g0, beta * g1

    # closing half kick at trajectory time K-1 (fwd) / 0 (bwd)
    tau_v = _time_enc(torch.where(dsign > 0, float(K - 1), 0.0), K)
    w0, w1, sumlogdet = kick(link_trig(y0, y1), w0, w1, g0, g1, tau_v, 0.5,
                             sumlogdet)

    dh = _energy_change(v0, v1, w0, w1, cosp, cosp1, beta) + sumlogdet
    prob = torch.exp(torch.clamp(dh, max=0.0))
    prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
    # reject non-finite proposals outright (l2hmc.py _sanitize)
    finite = (torch.sum(torch.abs(y0), dim=1) + torch.sum(torch.abs(y1), dim=1)
              + torch.sum(torch.abs(w0), dim=1)
              + torch.sum(torch.abs(w1), dim=1))
    prob = torch.where(torch.isfinite(finite), prob, torch.zeros_like(prob))

    acc = u < prob
    return (_select(acc, y0, x0), _select(acc, y1, x1), prob,
            _select(acc, pot1, pot0), _select(acc, sinp1, sinp),
            _select(acc, chg1, chg0), _select(acc, cosp1, cosp))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def l2hmc_chain_reference(links, params, v0s, v1s, ds, us, eps, beta,
                          num_leapfrog, bounded_q=True, hop_arrays=None,
                          local_layers=0, precision="f32", ablate_nets=False):
    """Run ``N`` trained transitions with injected randomness.

    ``links (B, Lt, Lx, 2)``; ``params`` a ``DynamicsParams`` of the MLP/u1
    family or, with ``local_layers > 0``, of the ``make_local_flat_net``
    family of that depth; ``v0s/v1s (N, B, Lt*Lx)``; ``ds/us (N, B)``.
    ``hop_arrays=(nus, uhs)`` appends one exact instanton hop after every
    transition.  ``precision='bf16'``: bfloat16 conditioner matmuls (MLP
    family; the stencil family computes in float32 and ignores it).
    ``ablate_nets=True``: S = T = Q = 0, the conditioner skipped.  Returns
    ``(links_out, plaq_trace, charge_trace, prob_trace)``.
    """
    b, lt, lx, _ = links.shape
    d = lt * lx
    if local_layers > 0:
        names = local_weight_names(local_layers)
        packed = pack_local_weights(params, 2 * d, local_layers)
    else:
        names, packed = WEIGHT_NAMES, pack_weights(params, 2 * d, precision)
    W = SimpleNamespace(**dict(zip(names, (w.to(links.device)
                                           for w in packed))))
    x0, x1 = _split_links(links)
    pot, sinp, cosp, chg = _potential_fields(x0, x1, lx)
    if hop_arrays is not None:
        nus, uhs = hop_arrays
        w0f, w1f = _winding_flat(b, d, lt, lx, links.device)
    plaqs, chgs, probs = [], [], []
    with torch.no_grad():
        for n in range(v0s.shape[0]):
            x0, x1, prob, pot, sinp, chg, cosp = _l2hmc_transition_math(
                x0, x1, v0s[n], v1s[n], ds[n], us[n], W, eps, beta,
                num_leapfrog, lx, bounded_q, pot, sinp, chg, cosp,
                local_layers, ablate_nets)
            if hop_arrays is not None:
                x0, x1, _, pot, sinp, cosp, chg = _hop_math(
                    x0, x1, pot, sinp, cosp, chg, nus[n], uhs[n], beta,
                    w0f, w1f)
            plaqs.append(1.0 - pot / d)
            chgs.append(chg)
            probs.append(prob)
    return (_join_links(x0, x1, lt, lx), torch.stack(plaqs),
            torch.round(torch.stack(chgs)), torch.stack(probs))


# ---------------------------------------------------------------------------
# Public wrapper
# ---------------------------------------------------------------------------


def draw_l2hmc_randomness(generator, n, b, d, hop, device=None):
    """``(v0s, v1s, ds, us[, nus, uhs])`` for :func:`l2hmc_chain_reference`."""
    kw = dict(generator=generator, dtype=torch.float32, device=device)

    def signs():
        return torch.randint(0, 2, (n, b), generator=generator,
                             device=device).to(torch.float32) * 2.0 - 1.0

    out = [torch.randn((n, b, d), **kw), torch.randn((n, b, d), **kw),
           signs(), torch.rand((n, b), **kw)]
    if hop:
        out += [signs(), torch.rand((n, b), **kw)]
    return tuple(out)


def _check_rand_arrays(rand_arrays, hop):
    if rand_arrays is not None and len(rand_arrays) != (6 if hop else 4):
        raise ValueError("rand_arrays must be (v0s, v1s, ds, us"
                         + (", nus, uhs)" if hop else ")"))


def _kernel_randomness(rand_arrays, generator, n, b, d):
    """``(six pointers-or-None, seed)`` for a chain kernel launch: the
    checked injected arrays, or none and a Philox seed from
    ``generator``."""
    rand = [None] * 6
    if rand_arrays is None:
        return rand, draw_seed(generator)
    shapes = [(n, b, d), (n, b, d)] + [(n, b)] * 4
    for i, (name, arr) in enumerate(zip(
            ("v0s", "v1s", "ds", "us", "nus", "uhs"), rand_arrays)):
        check_cuda_input(name, arr, shapes[i])
        rand[i] = arr
    return rand, 0


# ---------------------------------------------------------------------------
# The kernel's tensor-core products: TF32 arithmetic and the weight layout
# ---------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: what ``cvt.rna.tf32.f32`` gives (the low 13 bits zeroed after
    adding half of their range to the magnitude)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``x = hi + lo`` with both parts TF32 values (``lo`` rounded too)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as ``csrc/l2hmc_chain.cu`` forms it on tensor cores (3xTF32):
    ``hi@hi + (lo@hi + hi@lo)``, each product of two TF32 values exact in
    float32 and the sums float32; the dropped ``lo@lo`` is ~2^-22 of a
    term."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass (operands rounded once): the yardstick a
    single tensor-core pass would give."""
    return tf32_round(a) @ tf32_round(b)


# weight arrays of the chain kernel, per net then the masks: the packed
# matmul chunks and the float32 vectors, padded to the hidden width hp
MMA_NET_NAMES = ("mm", "t", "b", "hb", "headb0", "headb1", "cs0", "cs1",
                 "ct0", "ct1")
MMA_WEIGHT_NAMES = tuple(n + k for n in ("x", "v") for k in MMA_NET_NAMES) + (
    "mask0", "mask1")
CHUNK_TILES, TILE_BYTES = 32, 512       # 16 KB weight chunks of 8 warps x 4
CHUNK_BYTES = CHUNK_TILES * TILE_BYTES
KERNEL_WARPS = 8                        # warps that run the products
BLOCK_WARPS = 16                        # warps of a block
MAX_STAGES = 8
CHAINS_PER_BLOCK = (8, 4, 2)
# the cluster route (csrc/l2hmc_chain_cluster.cu): CTAs per cluster and
# chains per CTA, most first
CLUSTER_SIZES = (4, 2)
CLUSTER_CHAINS = (32, 16, 8)
CLUSTER_MAX_MT = KERNEL_WARPS           # hidden widths up to 128
H100_SMS = 132
# clusters of 2 and 4 one-CTA-per-SM blocks that an H100 SXM runs at once
# (cudaOccupancyMaxActiveClusters on the card; its GPCs hold the clusters)
H100_ACTIVE_CLUSTERS = {2: 66, 4: 30}
# a profiled window's count of launches on the cluster route
CLUSTER_COUNTER = "chain.cluster_route"


def _round_up(x, m):
    return -(-x // m) * m


def mma_geometry(d: int, h: int, precision: str = "f32") -> SimpleNamespace:
    """Layout of ``csrc/l2hmc_chain.cu``'s products at ``d`` sites, hidden
    width ``h``.  A tile is one warp's A operand of one mma (16 rows x
    ``ks`` = 8 TF32 or 16 bf16 columns, 512 bytes); a chunk 8 warps x 4
    tiles.  ``hp``: the hidden width padded (zero units, exact) to 32, 64,
    128 or 256 (bf16: 64, 128 or 256), so that ``mt = hp/16`` tile rows share
    the 8 warps of the in-projection and trunk (``wp = 8/mt`` k-groups each
    up to hp = 128; at 256 each warp covers ``rpw = 2`` tile rows) and a head
    tile row spans whole chunks.  ``n_in``, ``n_tr``, ``n_hd``: chunks of the
    in-projection (K = 6d padded to ``kp_in``), the trunk (``kp_tr``) and the
    head (M = 6d padded to ``mp_hd``, ``kq`` chunks per group of 8 tile
    rows); ``bs``, ``hs``: shared row strides of the features and the hidden
    activations (= 4 mod 32 words, so the B-operand reads of the 8 chains
    fall in distinct banks)."""
    bf16 = precision == "bf16"
    ks = 16 if bf16 else 8
    widths = (64, 128, 256) if bf16 else (32, 64, 128, 256)
    hp = next((w for w in widths if h <= w), None)
    if hp is None:
        raise ValueError(f"hidden={h}: the chain kernel takes at most "
                         f"{widths[-1]} hidden units")
    mt = hp // 16
    rpw = max(1, mt // KERNEL_WARPS)       # tile rows per product warp
    wp = max(1, KERNEL_WARPS // mt)        # k-groups per tile row
    kc = (4 // rpw) * wp                   # k-steps per narrow chunk
    kp_in = _round_up(6 * d, ks * kc)
    kp_tr = _round_up(hp, ks * kc)
    mp_hd = _round_up(6 * d, 16 * KERNEL_WARPS)
    kq = hp // (4 * ks)
    return SimpleNamespace(
        ks=ks, hp=hp, mt=mt, rpw=rpw, wp=wp, kp_in=kp_in, kp_tr=kp_tr,
        mp_hd=mp_hd, kq=kq,
        n_in=kp_in // (ks * kc), n_tr=kp_tr // (ks * kc),
        n_hd=mp_hd // (16 * KERNEL_WARPS) * kq,
        bs=_round_up(max(kp_in, mp_hd), 32) + 4,
        hs=_round_up(max(hp, kp_tr), 32) + 4)


def chain_smem_bytes(c: int, d: int, geo, stages: int) -> int:
    """Shared memory of one block of ``csrc/l2hmc_chain.cu`` (its
    ``l2hmc_chain_smem_bytes``): the weight ring and its barriers, 6 fields
    of ``c`` chains (the accepted state lives in device memory), the
    features, two hidden rows, the narrow products' partials (one slot per
    k-group and tile row) and the reductions."""
    floats = (stages * CHUNK_BYTES // 4 + 4 * MAX_STAGES + 6 * c * d
              + c * geo.bs + 2 * c * geo.hs + max(KERNEL_WARPS, geo.mt) * 128
              + BLOCK_WARPS * 4 * c + 10 * c)
    return 4 * floats


def chains_per_block(lt: int, lx: int, h: int, precision: str = "f32",
                     smem_limit: int = H100_SMEM_OPTIN,
                     max_chains: int = CHAINS_PER_BLOCK[0]):
    """``(chains per block, ring stages)`` of ``csrc/l2hmc_chain.cu`` for a
    ``lt x lx`` lattice: the most chains (8, 4 or 2, at most
    ``max_chains``) whose block fits ``smem_limit`` bytes with a ring of at
    least 2 weight chunks, and as many stages (up to 8) as then fit.
    Raises ``ValueError`` (naming the shared memory) when 2 chains do not
    fit."""
    d = lt * lx
    geo = mma_geometry(d, h, precision)
    for c in CHAINS_PER_BLOCK:
        if c > max_chains:
            continue
        base = chain_smem_bytes(c, d, geo, 0)
        stages = min(MAX_STAGES, (smem_limit - base) // CHUNK_BYTES)
        if stages >= 2:
            return c, stages
    raise ValueError(
        f"l2hmc_chain: {lt}x{lx} h={h} needs "
        f"{chain_smem_bytes(2, d, geo, 2)} B of shared memory per block (2 "
        f"chains, 2 weight chunks), the device allows {smem_limit} B")


def cluster_smem_bytes(cc: int, dl: int, geo, stages: int) -> int:
    """Shared memory of one CTA of ``csrc/l2hmc_chain_cluster.cu`` (its
    ``l2hmc_chain_cluster_smem_bytes``): the weight ring and its barriers,
    seven fields of ``cc`` chains at ``dl`` sites (the six of the block route
    and the per-site log-det), the features, two hidden rows, two buffers of
    the products' partials (8 slots of 16 rows x ``cc + 4``), the per-chain
    partial and cluster sums and scalars, and the exponentials of the
    nets' coefficients at the slab's sites.  ``geo`` is the slab's
    :func:`mma_geometry`."""
    floats = (stages * CHUNK_BYTES // 4 + 4 * MAX_STAGES + 7 * cc * dl
              + cc * geo.bs + 2 * cc * geo.hs
              + 2 * KERNEL_WARPS * 16 * (cc + 4) + 26 * cc + 8 * dl)
    return 4 * floats


def _waves(units: int, at_once: int) -> int:
    return -(-units // at_once)


def chain_route_plan(lt: int, lx: int, h: int, precision: str = "f32",
                     b: int = 1, smem_limit: int = H100_SMEM_OPTIN,
                     sms: int = H100_SMS, active_clusters=None,
                     max_chains: int = CHAINS_PER_BLOCK[0],
                     cluster: bool = True) -> SimpleNamespace:
    """How :func:`l2hmc_chain` runs ``b`` chains of ``lt x lx`` at hidden
    width ``h``: ``route`` ('block' or 'cluster'), ``cl`` (CTAs per cluster,
    1 on the block route), ``chains`` (per block, or per CTA), ``stages``
    (ring slots), ``geo`` (:func:`mma_geometry` of the block's lattice or of
    one slab), ``smem`` (bytes per block) and ``waves``.

    The block route (``csrc/l2hmc_chain.cu``) runs :func:`chains_per_block`
    chains per block, one block per SM (``sms`` at once).  The cluster route
    (``csrc/l2hmc_chain_cluster.cu``) splits each chain's rows over ``cl``
    CTAs, so that each CTA streams 1/cl of the in-projection and heads for
    its ``chains``: the first ``cl`` of :data:`CLUSTER_SIZES` that divides
    ``lt`` and ``chains`` of :data:`CLUSTER_CHAINS` whose CTA fits
    ``smem_limit`` with a ring of at least 2 chunks, at hidden widths up to
    128, whose clusters take no more waves than the block route's blocks;
    ``active_clusters(cl, chains, smem)`` is how many run at once (the
    card's ``cudaOccupancyMaxActiveClusters``; default
    :data:`H100_ACTIVE_CLUSTERS`).  ``cluster=False`` (the ablated mode)
    keeps the block route.  Raises ``ValueError`` (naming the shared memory)
    when neither route fits."""
    if active_clusters is None:
        def active_clusters(cl, chains, smem):
            return H100_ACTIVE_CLUSTERS[cl]
    d = lt * lx
    try:
        c, stages = chains_per_block(lt, lx, h, precision, smem_limit,
                                     max_chains)
    except ValueError as e:
        if not cluster:
            raise
        block, refused = None, e
    else:
        geo = mma_geometry(d, h, precision)
        block = SimpleNamespace(
            route="block", cl=1, chains=c, stages=stages, geo=geo,
            smem=chain_smem_bytes(c, d, geo, stages),
            waves=_waves(-(-b // c), sms))
    if cluster:
        for cl in CLUSTER_SIZES:
            if lt % cl:
                continue
            dl = d // cl
            geo = mma_geometry(dl, h, precision)
            if geo.mt > CLUSTER_MAX_MT:
                break
            for cc in CLUSTER_CHAINS:
                stages = min(MAX_STAGES, (smem_limit - cluster_smem_bytes(
                    cc, dl, geo, 0)) // CHUNK_BYTES)
                if stages < 2:
                    continue
                smem = cluster_smem_bytes(cc, dl, geo, stages)
                at_once = active_clusters(cl, cc, smem)
                if at_once < 1:
                    continue
                waves = _waves(-(-b // cc), at_once)
                if block is None or waves <= block.waves:
                    return SimpleNamespace(
                        route="cluster", cl=cl, chains=cc, stages=stages,
                        geo=geo, smem=smem, waves=waves)
    if block is None:
        raise refused
    return block


def _frag_index(ks: int):
    """(rows, cols), each (32 lanes, elements), of one lane's A fragment of
    mma.sync m16n8k8 (TF32: a0..a3) or m16n8k16 (bf16: a0..a3 as pairs)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    if ks == 8:
        rows, cols = [g, g + 8, g, g + 8], [t, t, t + 4, t + 4]
    else:
        rows = [g, g, g + 8, g + 8, g, g, g + 8, g + 8]
        cols = [2 * t, 2 * t + 1, 2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9,
                2 * t + 8, 2 * t + 9]
    return (torch.as_tensor(np.stack(rows, 1)),
            torch.as_tensor(np.stack(cols, 1)))


def _index_on(idx: torch.Tensor, device) -> torch.Tensor:
    """A host index tensor on ``device``.  On a card this is the blocking
    copy that indexing a card tensor with a host index makes anyway (it
    waits for the stream), made here so that it sits in a ``sync`` span."""
    if device.type != "cuda":
        return idx
    with trace.waiting():
        return idx.to(device)


def _tiles(a: torch.Tensor, ks: int) -> torch.Tensor:
    """(..., M, K) -> (..., M/16, K/ks, 32 * elements): each tile's
    fragments in lane order."""
    *lead, m, k = a.shape
    t = a.reshape(*lead, m // 16, 16, k // ks, ks).transpose(-3, -2)
    rows, cols = (_index_on(i, a.device) for i in _frag_index(ks))
    return t[..., rows, cols].reshape(*lead, m // 16, k // ks, -1)


def _pad2(a, rows, cols):
    return F.pad(a, (0, cols - a.shape[-1], 0, rows - a.shape[-2]))


def mma_pack(xin, hw, head, d, precision="f32", slabs=1) -> torch.Tensor:
    """One net's three matmul operands in the chunk order the kernel reads:
    the in-projection ``xin (6d, h)``, the trunk ``hw (h, h)`` and the merged
    heads ``head (h, 6d)``, each transposed (weights as the M operand),
    zero-padded to :func:`mma_geometry`'s shape and cut into tiles.
    In-projection and trunk chunk ``q``: warp ``w``'s tile ``s`` (``s =
    0..3``) holds tile row ``w % mt + 8 (s // kpc)``, k-step ``(q * wp + w
    // mt) * kpc + s % kpc`` (``kpc = 4 / rpw``: up to hp = 128 one row and 4
    k-steps, at 256 two rows and 2); head chunk ``(group, kq)``: warp ``w``
    holds tile row ``group * 8 + w``, k-steps ``kq * 4 + s``.  Flat, float32
    or bfloat16.

    ``slabs = CL > 1`` packs for the cluster route, whose CTA ``r`` owns the
    sites ``r dl .. (r + 1) dl - 1`` (``dl = d / CL``, whole rows): per slab,
    one after another, the in-projection's rows of the slab's six feature
    blocks, the trunk, and the heads' columns of the slab's six output
    blocks, each laid out as above at ``dl`` sites.  The slabs share each
    index gather, so the host waits as often as for one."""
    dl = d // slabs
    geo = mma_geometry(dl, hw.shape[0], precision)
    ks, mt, wp = geo.ks, geo.mt, geo.wp
    kpc = 4 // geo.rpw
    w_ = torch.arange(KERNEL_WARPS)[None, :, None]
    s_ = torch.arange(4)[None, None, :]

    def narrow(a, kp):
        tiles = _tiles(_pad2(a.float(), geo.hp, kp), ks)
        nch = tiles.shape[-2] // (kpc * wp)
        q = torch.arange(nch)[:, None, None]
        kidx = (q * wp + w_ // mt) * kpc + s_ % kpc
        rows = w_ % mt + KERNEL_WARPS * (s_ // kpc)
        return tiles[..., _index_on(rows.expand_as(kidx), tiles.device),
                     _index_on(kidx, tiles.device), :]

    def heads(a):
        tiles = _tiles(_pad2(a.float(), geo.mp_hd, geo.hp), ks)
        grp = torch.arange(geo.mp_hd // (16 * KERNEL_WARPS))[:, None, None,
                                                              None]
        kq = torch.arange(geo.kq)[None, :, None, None]
        rows = (grp * KERNEL_WARPS + w_[None]).expand(-1, geo.kq, -1, 4)
        return tiles[..., _index_on(rows, tiles.device),
                     _index_on((kq * 4 + s_[None]).expand_as(rows),
                               tiles.device), :]

    h = hw.shape[0]
    xin_s = xin.reshape(6, slabs, dl, h).transpose(0, 1).reshape(
        slabs, 6 * dl, h)
    head_s = head.reshape(h, 6, slabs, dl).permute(2, 0, 1, 3).reshape(
        slabs, h, 6 * dl)
    flat = torch.cat([
        narrow(xin_s.transpose(-1, -2), geo.kp_in).reshape(slabs, -1),
        narrow(hw.t(), geo.kp_tr).reshape(1, -1).expand(slabs, -1),
        heads(head_s.transpose(-1, -2)).reshape(slabs, -1)], dim=1)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return flat.reshape(-1).to(dtype).contiguous()


def mma_weights(weights, d, precision="f32",
                slabs=1) -> Tuple[torch.Tensor, ...]:
    """:func:`pack_weights` tensors -> the chain kernel's arrays in
    :data:`MMA_WEIGHT_NAMES` order: per net the :func:`mma_pack` chunks
    (per slab of the cluster route for ``slabs > 1``), the time rows ``(2,
    hp)``, biases ``(hp,)`` (zero for padded units), the head biases and the
    coefficients; then the masks."""
    w = dict(zip(WEIGHT_NAMES, weights))
    hp = mma_geometry(d, w["xh_w"].shape[0], precision).hp
    out = []
    for n in ("x", "v"):
        h = w[n + "h_w"].shape[0]

        def vec(a):
            return F.pad(a.float().reshape(-1, h),
                         (0, hp - h)).reshape(-1).contiguous()

        out += [mma_pack(w[n + "in"], w[n + "h_w"], w[n + "head"], d,
                         precision, slabs),
                vec(w[n + "t"]), vec(w[n + "b"]), vec(w[n + "h_b"])]
        out += [w[n + k].float().reshape(-1).contiguous()
                for k in ("headb0", "headb1", "cs0", "cs1", "ct0", "ct1")]
    return tuple(out) + (w["mask0"], w["mask1"])


def l2hmc_chain(links, params, generator, eps, beta, num_leapfrog,
                num_transitions, bounded_q=True, hop=False, rand_arrays=None,
                precision="f32", ablate_nets=False):
    """Run ``num_transitions`` fused trained L2HMC transitions.

    ``links (B, Lt, Lx, 2)`` float32 angles; ``params`` a trained MLP/u1
    ``DynamicsParams``.  Returns ``(links_out, plaq_trace (N, B),
    charge_trace (N, B), prob_trace (N, B))``; charges rounded.
    ``precision='bf16'`` runs the conditioners on bfloat16 weights;
    ``ablate_nets=True`` skips them (S = T = Q = 0), the cost-decomposition
    mode.

    A CPU tensor runs :func:`l2hmc_chain_reference`, with randomness drawn
    from ``generator`` unless ``rand_arrays=(v0s, v1s, ds, us[, nus, uhs])``
    is given.  A CUDA tensor launches the kernel — with the injected
    arrays, or with in-kernel Philox randomness seeded from ``generator`` —
    or raises, on the route :func:`chain_route_plan` picks from the shapes,
    the precision, the batch and the card's limits: the cluster route
    (``csrc/l2hmc_chain_cluster.cu``: each chain's rows split over a
    cluster of 2 or 4 CTAs of 8-32 chains, each CTA streaming its slab's
    share of the weights), or the block route (``csrc/l2hmc_chain.cu``: 2,
    4 or 8 whole chains per block, :func:`chains_per_block`), which also
    runs the ablated mode and hidden widths above 128 (up to 256,
    :func:`mma_geometry`).  A lattice that fits neither raises.  Every
    launch adds one to ``l2hmc_chain.launches``, and to
    ``l2hmc_chain.bf16_launches`` / ``l2hmc_chain.ablate_launches`` in
    those modes and ``l2hmc_chain.cluster_launches`` on the cluster route,
    which also counts :data:`CLUSTER_COUNTER` on the program's recorder.
    """
    check_links(links)
    b, lt, lx, _ = links.shape
    d = lt * lx
    n = num_transitions
    _check_rand_arrays(rand_arrays, hop)
    if not links.is_cuda:
        if rand_arrays is None:
            rand_arrays = draw_l2hmc_randomness(generator, n, b, d, hop,
                                                links.device)
        return l2hmc_chain_reference(
            links, params, *rand_arrays[:4], eps, beta, num_leapfrog,
            bounded_q, hop_arrays=tuple(rand_arrays[4:]) if hop else None,
            precision=precision, ablate_nets=ablate_nets)

    if links.dtype != torch.float32:
        raise ValueError(f"links: expected float32, got {links.dtype}")
    with trace.span(CALL_SPAN):
        return _l2hmc_chain_cuda(links, params, generator, eps, beta,
                                 num_leapfrog, n, bounded_q, hop,
                                 rand_arrays, precision, ablate_nets)


def _l2hmc_chain_cuda(links, params, generator, eps, beta, num_leapfrog, n,
                      bounded_q, hop, rand_arrays, precision, ablate_nets):
    b, lt, lx, _ = links.shape
    d = lt * lx
    dev = links.device
    bf16 = precision == "bf16"
    with trace.span(WEIGHTS_SPAN):
        packed = pack_weights(params, 2 * d, precision)
        h = packed[0].shape[1]
        K = packed[-1].shape[0]
        if K != num_leapfrog:
            raise ValueError(f"masks hold {K} steps, "
                             f"num_leapfrog={num_leapfrog}")
        lib = _cuda.library()
        idx = dev.index or 0
        plan = chain_route_plan(
            lt, lx, h, precision, b, lib.smem_optin_bytes(idx),
            _sm_count(idx), functools.partial(_active_clusters, idx, bf16),
            lib.l2hmc_chain_max_chains(), cluster=not ablate_nets)
        geo = plan.geo
        weights = mma_weights(packed, d, precision, plan.cl)
        for name, w in zip(MMA_WEIGHT_NAMES, weights):
            check_cuda_input(name, w, dtype=torch.bfloat16 if (
                bf16 and name[1:] == "mm") else torch.float32)

    x0, x1 = _split_links(links)
    with trace.span(SEED_SPAN):
        rand, seed = _kernel_randomness(rand_arrays, generator, n, b, d)
    wptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    # the accepted state's sin P and cos P (kernel scratch)
    spcp = torch.empty((2, b, d), dtype=torch.float32, device=dev)
    plaq = torch.empty((n, b), dtype=torch.float32, device=dev)
    chg = torch.empty_like(plaq)
    prob = torch.empty_like(plaq)
    l2hmc_chain.launches += 1
    l2hmc_chain.bf16_launches += int(bf16)
    l2hmc_chain.ablate_launches += int(ablate_nets)
    head = (x0.data_ptr(), x1.data_ptr(), spcp.data_ptr(),
            ctypes.cast(wptrs, ctypes.c_void_p),
            *[_cuda.ptr(r) for r in rand],
            plaq.data_ptr(), chg.data_ptr(), prob.data_ptr(),
            b, lt, lx, num_leapfrog, n)
    layout = (geo.hp, geo.mt, geo.n_in, geo.n_tr, geo.n_hd, geo.kq, geo.bs,
              geo.hs, plan.stages, idx, _cuda.stream_handle(dev))
    with trace.span(LAUNCH_SPAN):
        if plan.route == "cluster":
            l2hmc_chain.cluster_launches += 1
            trace.count(CLUSTER_COUNTER)
            _cuda.check(lib.l2hmc_chain_cluster_launch(
                *head, float(eps), float(beta), int(bounded_q), int(hop),
                int(bf16), seed, plan.cl, plan.chains, *layout),
                "l2hmc_chain_cluster_launch")
        else:
            _cuda.check(lib.l2hmc_chain_launch(
                *head, h, float(eps), float(beta), int(bounded_q), int(hop),
                int(bf16), int(ablate_nets), seed, plan.chains, *layout),
                "l2hmc_chain_launch")
    return _join_links(x0, x1, lt, lx), plaq, torch.round(chg), prob


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _active_clusters(device_index: int, bf16: bool, cl: int, chains: int,
                     smem: int) -> int:
    """Clusters of the cluster route that the card runs at once."""
    n = _cuda.library().l2hmc_chain_cluster_max_active(
        cl, chains, int(bf16), smem, device_index)
    if n < 0:
        raise RuntimeError(f"l2hmc_chain_cluster_max_active: CUDA error {-n}")
    return n


l2hmc_chain.launches = 0
l2hmc_chain.bf16_launches = 0
l2hmc_chain.ablate_launches = 0
l2hmc_chain.cluster_launches = 0

# what csrc/l2hmc_local_chain.cu takes: stencil layers of
# LOCAL_KERNEL_CHANNELS channels (a narrower net is padded) over the 6 u1
# input channels, any depth
LOCAL_KERNEL_CHANNELS = (4, 8)
LOCAL_MAX_CHANNELS = LOCAL_KERNEL_CHANNELS[-1]
LOCAL_IN_CHANNELS = 6
LOCAL_WARPS = 16


def local_net_stride(c: int, num_layers: int) -> int:
    """Floats of one net's weights in the kernel's flat array (each net
    padded to a multiple of 4): ``s0w (5, 6, c)``, ``s0t (2, c)``, ``s0b``,
    ``num_layers - 1`` hidden layers of ``(5, c, c)`` and ``c``, ``hw (6,
    c)``, ``hb (6)``, ``cs``, ``ct (2)``."""
    n = (5 * LOCAL_IN_CHANNELS * c + 3 * c + (num_layers - 1) * (5 * c * c + c)
         + 6 * c + 10)
    return -(-n // 4) * 4


def local_chain_smem_bytes(lt: int, lx: int, c: int, num_layers: int,
                           deep: bool) -> int:
    """Shared memory of one block of ``csrc/l2hmc_local_chain.cu`` (its
    ``l2hmc_local_chain_smem_bytes``): both nets' weights, the reductions,
    ten (d,) fields and, for a two-layer net off the deep route, the (c, d)
    layer-0 outputs."""
    d = lt * lx
    fields = 10 * d + (c * d if num_layers == 2 and not deep else 0)
    return 4 * (2 * local_net_stride(c, num_layers) + LOCAL_WARPS * 4 + 8
                + fields)


def local_chain_route(lt: int, lx: int, c: int, num_layers: int,
                      smem_limit: int = H100_SMEM_OPTIN):
    """``(deep, shared-memory bytes)`` of the local kernel for a ``lt x lx``
    lattice and a ``c``-channel net of ``num_layers`` layers: one or two
    layers run with every field in shared memory where the block fits
    ``smem_limit``; deeper nets, and a two-layer net that does not fit (c=8
    at 64x64), run the deep route, whose hidden-layer outputs live in
    device memory.  Raises ``ValueError`` (naming the bytes) when even the
    deep route's block does not fit."""
    if num_layers <= 2:
        smem = local_chain_smem_bytes(lt, lx, c, num_layers, False)
        if smem <= smem_limit:
            return False, smem
    deep = num_layers >= 2
    smem = local_chain_smem_bytes(lt, lx, c, num_layers, deep)
    if smem > smem_limit:
        raise ValueError(
            f"l2hmc_local_chain: {lt}x{lx} c={c} L={num_layers} needs {smem} "
            f"B of shared memory per block (1 chain), the device allows "
            f"{smem_limit} B")
    return deep, smem


def local_kernel_channels(c: int) -> int:
    """The channel count the local kernel runs a ``c``-channel net at: the
    least of :data:`LOCAL_KERNEL_CHANNELS` that holds it."""
    for k in LOCAL_KERNEL_CHANNELS:
        if c <= k:
            return k
    raise ValueError(f"channels={c}: the kernel takes at most "
                     f"{LOCAL_MAX_CHANNELS}")


def pad_local_params(params, channels: int):
    """A copy of ``make_local_flat_net`` ``DynamicsParams`` with each net
    widened to ``channels`` stencil channels.  The new channels have zero
    stencil weights (in and out), zero time rows, zero biases and zero head
    rows: their outputs are exactly 0 after the ReLU, and they add exact
    zeros to the next layer and the head, so the padded net computes the
    same S, T and Q as the original, bit for bit."""
    out = copy.deepcopy(params)
    with torch.no_grad():
        for net in (out.xnet, out.vnet):
            st = net.stencils()
            pad = channels - st[0].w.shape[2]
            if pad < 0:
                raise ValueError(f"cannot pad {st[0].w.shape[2]} channels "
                                 f"to {channels}")
            st[0].w = nn.Parameter(F.pad(st[0].w, (0, pad)))
            st[0].wt = nn.Parameter(F.pad(st[0].wt, (0, pad)))
            st[0].b = nn.Parameter(F.pad(st[0].b, (0, pad)))
            for layer in st[1:]:
                layer.w = nn.Parameter(F.pad(layer.w, (0, pad, 0, pad)))
                layer.b = nn.Parameter(F.pad(layer.b, (0, pad)))
            net.head.w = nn.Parameter(F.pad(net.head.w, (0, 0, 0, pad)))
            net.spec = dataclasses.replace(net.spec, channels=channels)
    return out


def local_kernel_weights(weights, num_layers: int) -> torch.Tensor:
    """Both nets' :func:`pack_local_weights` tensors (masks excluded) as the
    one flat array ``csrc/l2hmc_local_chain.cu`` reads: per net ``s0w, s0t,
    s0b, [s1w, s1b], hw`` transposed to ``(6, c)``, ``hb, cs, ct``, each
    net padded with zeros to a multiple of 4 floats (so every channel row is
    16-byte aligned for float4 reads)."""
    per_net = len(weights[:-2]) // 2
    flat = []
    for net in (weights[:per_net], weights[per_net:2 * per_net]):
        parts = [w.reshape(-1) for w in net]
        hw = 3 + 2 * (num_layers - 1)            # index of hw in the net
        parts[hw] = net[hw].t().contiguous().reshape(-1)
        one = torch.cat(parts)
        flat.append(F.pad(one, (0, -one.numel() % 4)))
    return torch.cat(flat).contiguous()


def l2hmc_local_chain(links, params, generator, eps, beta, num_leapfrog,
                      num_transitions, num_layers, bounded_q=True, hop=False,
                      rand_arrays=None, ablate_nets=False):
    """Run ``num_transitions`` fused trained L2HMC transitions with the
    local 5-point stencil conditioner.

    ``links (B, Lt, Lx, 2)`` float32 angles; ``params`` a
    ``make_local_flat_net``/u1 ``DynamicsParams`` with ``num_layers``
    stencil layers.  Returns ``(links_out, plaq_trace (N, B), charge_trace
    (N, B), prob_trace (N, B))``; charges rounded.

    A CPU tensor runs :func:`l2hmc_chain_reference` (``local_layers=
    num_layers``), with randomness drawn from ``generator`` unless
    ``rand_arrays=(v0s, v1s, ds, us[, nus, uhs])`` is given.  A CUDA tensor
    launches the kernel of ``csrc/l2hmc_local_chain.cu`` — with the injected
    arrays, or with in-kernel Philox randomness seeded from ``generator`` —
    or raises.  The kernel runs 4 or 8 channels; a net of fewer is padded
    (:func:`pad_local_params`, exact).  Each block runs one chain with its
    fields in shared memory; nets deeper than two layers, or whose layer-0
    outputs do not fit beside the fields, keep their hidden-layer outputs in
    device memory (:func:`local_chain_route`); a lattice whose fields alone
    do not fit raises a ``ValueError`` naming the bytes it needs.
    ``ablate_nets=True`` skips the conditioner (S = T = Q = 0); such a
    launch also adds one to ``l2hmc_local_chain.ablate_launches``.
    """
    check_links(links)
    if num_layers < 1:
        raise ValueError(f"num_layers={num_layers}: the local conditioner "
                         "has at least one stencil layer")
    b, lt, lx, _ = links.shape
    d = lt * lx
    n = num_transitions
    _check_rand_arrays(rand_arrays, hop)
    if not links.is_cuda:
        if rand_arrays is None:
            rand_arrays = draw_l2hmc_randomness(generator, n, b, d, hop,
                                                links.device)
        return l2hmc_chain_reference(
            links, params, *rand_arrays[:4], eps, beta, num_leapfrog,
            bounded_q, hop_arrays=tuple(rand_arrays[4:]) if hop else None,
            local_layers=num_layers, ablate_nets=ablate_nets)

    if links.dtype != torch.float32:
        raise ValueError(f"links: expected float32, got {links.dtype}")
    with trace.span(CALL_SPAN):
        return _l2hmc_local_chain_cuda(links, params, generator, eps, beta,
                                       num_leapfrog, n, num_layers,
                                       bounded_q, hop, rand_arrays,
                                       ablate_nets)


def _l2hmc_local_chain_cuda(links, params, generator, eps, beta,
                            num_leapfrog, n, num_layers, bounded_q, hop,
                            rand_arrays, ablate_nets):
    b, lt, lx, _ = links.shape
    d = lt * lx
    dev = links.device
    with trace.span(WEIGHTS_SPAN):
        s0w = params.xnet.stencils()[0].w
        if tuple(s0w.shape[:2]) != (5, LOCAL_IN_CHANNELS):
            raise ValueError(f"xs0w: expected (5, {LOCAL_IN_CHANNELS}, c), "
                             f"got {tuple(s0w.shape)} (u1 position features)")
        c = local_kernel_channels(s0w.shape[2])
        names = local_weight_names(num_layers)
        weights = pack_local_weights(pad_local_params(params, c), 2 * d,
                                     num_layers)
        for name, w in zip(names, weights):
            check_cuda_input(name, w)
        mask0, mask1 = weights[-2:]
        K = mask0.shape[0]
        if K != num_leapfrog or num_leapfrog < 1:
            raise ValueError(f"masks hold {K} steps, "
                             f"num_leapfrog={num_leapfrog}")
        masks = torch.stack([mask0, mask1])
        with trace.waiting():
            binary = bool(((masks == 0.0) | (masks == 1.0)).all())
        if not binary:
            raise ValueError("masks: the kernel takes binary hold masks")
        flat = local_kernel_weights(weights, num_layers)

    lib = _cuda.library()
    deep, _ = local_chain_route(lt, lx, c, num_layers,
                                lib.smem_optin_bytes(dev.index or 0))

    x0, x1 = _split_links(links)
    with trace.span(SEED_SPAN):
        rand, seed = _kernel_randomness(rand_arrays, generator, n, b, d)
    # the accepted state's sin P and cos P, per chain (kernel scratch)
    spcp = torch.empty((b, 2, d), dtype=torch.float32, device=dev)
    # the deep route's hidden-layer outputs, two (c, d) buffers per chain
    hbuf = (torch.empty((b, 2, c, d), dtype=torch.float32, device=dev)
            if deep and not ablate_nets else None)
    plaq = torch.empty((n, b), dtype=torch.float32, device=dev)
    chg = torch.empty_like(plaq)
    prob = torch.empty_like(plaq)
    l2hmc_local_chain.launches += 1
    l2hmc_local_chain.ablate_launches += int(ablate_nets)
    with trace.span(LAUNCH_SPAN):
        _cuda.check(lib.l2hmc_local_chain_launch(
            x0.data_ptr(), x1.data_ptr(), spcp.data_ptr(), _cuda.ptr(hbuf),
            flat.data_ptr(),
            mask0.data_ptr(), mask1.data_ptr(),
            *[_cuda.ptr(r) for r in rand],
            plaq.data_ptr(), chg.data_ptr(), prob.data_ptr(),
            b, lt, lx, K, n, c, num_layers, float(eps), float(beta),
            int(bounded_q), int(hop), int(ablate_nets), int(deep), seed,
            dev.index or 0, _cuda.stream_handle(dev)),
            "l2hmc_local_chain_launch")
    return _join_links(x0, x1, lt, lx), plaq, torch.round(chg), prob


l2hmc_local_chain.launches = 0
l2hmc_local_chain.ablate_launches = 0
