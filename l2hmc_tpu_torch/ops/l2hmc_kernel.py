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

:func:`l2hmc_chain_reference` is the plain PyTorch version of both; the
wrappers run it for CPU tensors.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch

from l2hmc_tpu_torch.networks.nets import stencil_head, stencil_layer
from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.leapfrog import (
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

_TWO_PI = 2.0 * np.pi

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


def pack_weights(params, x_dim: int) -> Tuple[torch.Tensor, ...]:
    """De-interleave trained MLP ``DynamicsParams`` into kernel blocks.

    XNet ``in_w`` rows are ``[v | cos-feats | sin-feats | t (2)]``; VNet rows
    ``[cos | sin | grad | t (2)]``.  The six per-direction input blocks stack
    into one ``(6d, h)`` operand (row order = the feature concat of the
    transition math) and the two head blocks into one ``(h, 6d)`` operand
    ``[dir0 | dir1]``.  Returns contiguous float32 tensors in
    :data:`WEIGHT_NAMES` order, detached (the chain is sampling-only).
    """
    d2 = x_dim
    vals = {}
    for p, net in (("x", params.xnet), ("v", params.vnet)):
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
    return tuple(vals[n].to(torch.float32).contiguous() for n in WEIGHT_NAMES)


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


def _heads(hh, W, net, bounded_q):
    """Trunk output -> per-direction (S, T, Q); one merged ``(h, 6d)``
    matmul for both directions."""
    hm = hh @ getattr(W, net + "head")
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
    return torch.relu(hh @ getattr(W, net + "h_w") + getattr(W, net + "h_b"))


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
        pre = feats @ W.vin + _tau_term(tau, W.vt) + W.vb
        return _heads(_trunk(pre, W, "v"), W, "v", bounded_q)

    def xnet(ww0, ww1, trig, m0, m1, tau):
        cy0, cy1, sy0, sy1 = trig
        feats = torch.cat(
            [ww0, ww1, m0 * cy0, m1 * cy1, m0 * sy0, m1 * sy1], dim=1)
        pre = feats @ W.xin + _tau_term(tau, W.xt) + W.xb
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
                           bounded_q, pot0, sinp, chg0, cosp, local_layers=0):
    """One trained-L2HMC transition (merge_v_halves, u1) on flat halves.

    ``dsign (B,)`` in {+1,-1}; ``u (B,)`` accept uniforms; ``W`` a namespace
    of :data:`WEIGHT_NAMES` tensors (MLP) or, with ``local_layers > 0``, of
    :func:`local_weight_names` tensors (stencil conditioner of that depth);
    ``pot0/sinp/chg0/cosp`` the carried fields of the input state.  Returns
    ``(x0', x1', prob, pot, sinp, chg, cosp)`` of the output state.
    """
    d_col = dsign[:, None]
    fwd = d_col > 0
    g0, g1 = _grad_flat(sinp, lx)
    g0, g1 = beta * g0, beta * g1
    y0, y1, w0, w1 = x0, x1, v0, v1
    sumlogdet = torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    pot1, sinp1, cosp1, chg1 = pot0, sinp, cosp, chg0
    if local_layers > 0:
        vnet, xnet = _make_stencil_nets(W, lx, bounded_q, local_layers)
    else:
        vnet, xnet = _make_mlp_nets(W, bounded_q)

    def link_trig(yy0, yy1):
        return torch.cos(yy0), torch.cos(yy1), torch.sin(yy0), torch.sin(yy1)

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
                          local_layers=0):
    """Run ``N`` trained transitions with injected randomness.

    ``links (B, Lt, Lx, 2)``; ``params`` a ``DynamicsParams`` of the MLP/u1
    family or, with ``local_layers > 0``, of the ``make_local_flat_net``
    family of that depth; ``v0s/v1s (N, B, Lt*Lx)``; ``ds/us (N, B)``.
    ``hop_arrays=(nus, uhs)`` appends one exact instanton hop after every
    transition.  Returns ``(links_out, plaq_trace, charge_trace,
    prob_trace)``.
    """
    b, lt, lx, _ = links.shape
    d = lt * lx
    if local_layers > 0:
        names = local_weight_names(local_layers)
        packed = pack_local_weights(params, 2 * d, local_layers)
    else:
        names, packed = WEIGHT_NAMES, pack_weights(params, 2 * d)
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
                local_layers)
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


def l2hmc_chain(links, params, generator, eps, beta, num_leapfrog,
                num_transitions, bounded_q=True, hop=False, rand_arrays=None):
    """Run ``num_transitions`` fused trained L2HMC transitions.

    ``links (B, Lt, Lx, 2)`` float32 angles; ``params`` a trained MLP/u1
    ``DynamicsParams``.  Returns ``(links_out, plaq_trace (N, B),
    charge_trace (N, B), prob_trace (N, B))``; charges rounded.

    A CPU tensor runs :func:`l2hmc_chain_reference`, with randomness drawn
    from ``generator`` unless ``rand_arrays=(v0s, v1s, ds, us[, nus, uhs])``
    is given.  A CUDA tensor launches the kernel of ``csrc/l2hmc_chain.cu``
    — with the injected arrays, or with in-kernel Philox randomness seeded
    from ``generator`` — or raises.  Each block of the kernel runs two
    chains, so that each read of the weights feeds both; a lattice whose
    two chains do not fit in one block's shared memory raises.
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
            bounded_q, hop_arrays=tuple(rand_arrays[4:]) if hop else None)

    if links.dtype != torch.float32:
        raise ValueError(f"links: expected float32, got {links.dtype}")
    dev = links.device
    weights = pack_weights(params, 2 * d)
    h = weights[0].shape[1]
    for name, w in zip(WEIGHT_NAMES, weights):
        check_cuda_input(name, w)
    K = weights[-1].shape[0]
    if K != num_leapfrog:
        raise ValueError(f"masks hold {K} steps, num_leapfrog={num_leapfrog}")

    lib = _cuda.library()
    smem = lib.l2hmc_chain_smem_bytes(lt, lx, h)
    limit = lib.smem_optin_bytes(dev.index or 0)
    if smem > limit:
        raise ValueError(
            f"l2hmc_chain: {lt}x{lx} h={h} needs {smem} B of shared memory "
            f"per block (2 chains), the device allows {limit} B")

    x0, x1 = _split_links(links)
    rand, seed = _kernel_randomness(rand_arrays, generator, n, b, d)
    wptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    plaq = torch.empty((n, b), dtype=torch.float32, device=dev)
    chg = torch.empty_like(plaq)
    prob = torch.empty_like(plaq)
    l2hmc_chain.launches += 1
    _cuda.check(lib.l2hmc_chain_launch(
        x0.data_ptr(), x1.data_ptr(), ctypes.cast(wptrs, ctypes.c_void_p),
        *[_cuda.ptr(r) for r in rand],
        plaq.data_ptr(), chg.data_ptr(), prob.data_ptr(),
        b, lt, lx, num_leapfrog, n, h, float(eps), float(beta),
        int(bounded_q), int(hop), seed, dev.index or 0,
        _cuda.stream_handle(dev)), "l2hmc_chain_launch")
    return _join_links(x0, x1, lt, lx), plaq, torch.round(chg), prob


l2hmc_chain.launches = 0

# what csrc/l2hmc_local_chain.cu takes: 1 or 2 stencil layers of at most
# LOCAL_MAX_CHANNELS channels over the 6 u1 input channels
LOCAL_MAX_CHANNELS = 8
LOCAL_IN_CHANNELS = 6


def l2hmc_local_chain(links, params, generator, eps, beta, num_leapfrog,
                      num_transitions, num_layers, bounded_q=True, hop=False,
                      rand_arrays=None):
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
    or raises.  Each block runs one chain with its fields in shared memory;
    a lattice, depth or width whose chain does not fit raises a
    ``ValueError`` naming the bytes it needs.
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
            local_layers=num_layers)

    if links.dtype != torch.float32:
        raise ValueError(f"links: expected float32, got {links.dtype}")
    if num_layers > 2:
        raise ValueError(f"num_layers={num_layers}: the kernel runs 1 or 2 "
                         "stencil layers")
    dev = links.device
    names = local_weight_names(num_layers)
    weights = pack_local_weights(params, 2 * d, num_layers)
    for name, w in zip(names, weights):
        check_cuda_input(name, w)
    s0w = weights[0]
    c = s0w.shape[2]
    if tuple(s0w.shape[:2]) != (5, LOCAL_IN_CHANNELS):
        raise ValueError(f"xs0w: expected (5, {LOCAL_IN_CHANNELS}, c), got "
                         f"{tuple(s0w.shape)} (u1 position features)")
    if c > LOCAL_MAX_CHANNELS:
        raise ValueError(f"channels={c}: the kernel takes at most "
                         f"{LOCAL_MAX_CHANNELS}")
    mask0, mask1 = weights[-2:]
    K = mask0.shape[0]
    if K != num_leapfrog or num_leapfrog < 1:
        raise ValueError(f"masks hold {K} steps, num_leapfrog={num_leapfrog}")
    masks = torch.stack([mask0, mask1])
    if not bool(((masks == 0.0) | (masks == 1.0)).all()):
        raise ValueError("masks: the kernel takes binary hold masks")

    lib = _cuda.library()
    smem = lib.l2hmc_local_chain_smem_bytes(lt, lx, c, num_layers)
    limit = lib.smem_optin_bytes(dev.index or 0)
    if smem > limit:
        raise ValueError(
            f"l2hmc_local_chain: {lt}x{lx} c={c} L={num_layers} needs {smem} "
            f"B of shared memory per block (1 chain), the device allows "
            f"{limit} B")

    x0, x1 = _split_links(links)
    rand, seed = _kernel_randomness(rand_arrays, generator, n, b, d)
    # net weights of both nets, flattened in local_weight_names order
    flat = torch.cat([w.reshape(-1) for w in weights[:-2]])
    plaq = torch.empty((n, b), dtype=torch.float32, device=dev)
    chg = torch.empty_like(plaq)
    prob = torch.empty_like(plaq)
    l2hmc_local_chain.launches += 1
    _cuda.check(lib.l2hmc_local_chain_launch(
        x0.data_ptr(), x1.data_ptr(), flat.data_ptr(), mask0.data_ptr(),
        mask1.data_ptr(), *[_cuda.ptr(r) for r in rand],
        plaq.data_ptr(), chg.data_ptr(), prob.data_ptr(),
        b, lt, lx, K, n, c, num_layers, float(eps), float(beta),
        int(bounded_q), int(hop), seed, dev.index or 0,
        _cuda.stream_handle(dev)), "l2hmc_local_chain_launch")
    return _join_links(x0, x1, lt, lx), plaq, torch.round(chg), prob


l2hmc_local_chain.launches = 0
