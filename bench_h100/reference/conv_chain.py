"""Plain PyTorch reference of the conv L2HMC sampler's eval call.

It replays a whole call of the program's sampling chunk: ``N`` transitions
of ``B`` chains from the call's input links, with the call's own draws.
Those are redrawn from a generator set to the state the program's
generator had when the call began, in the program's order per transition:
the momenta ``randn (B, 2 d)``, the directions from ``rand (B,)`` (forward
where above 1/2) and the accept uniforms ``rand (B,)``.  It returns the
links out and the ``(N, B)`` plaquette, charge and accept-probability
traces and the uniforms, as ``chains.l2hmc_call`` does.

The conditioner is the periodic CNN of the reference repository's default
net (saforem2/l2hmc-qcd ``network/conv_net.py``, the 2-D form of
``ConvNet3D``; method arXiv:2105.03418) from its unpacked weights: each
input slot through a conv stack (a ``k1 x k1`` conv of ``f`` filters, ReLU,
a ``k2 x k2`` conv of ``2 f`` filters at stride 2, ReLU), flattened, then
``relu(W_v stack(v) + W_x stack(x) + W_t t + b)``, ``relu(W_h h + b_h)`` and
the fused head ``[S | T | Q]`` with ``S = tanh(.) exp(coeff_scale)``,
``Q = tanh(.) exp(coeff_transformation)``.  Each conv is an explicit sum of
rolled inputs, one product per kernel tap, so it shares no convolution
algorithm with the program.

The transition is the split integrator on the flat interleaved state (the
``u1`` group: cos/sin features, the circle map with its exact
log-Jacobian, one direction per chain): per leapfrog step a momentum
half-kick, the two masked position updates and a half-kick, the force
kept from one step to the next (K + 1 forces); the energy change summed
from per-site differences (each Hamiltonian alone is ~1e3 at 16x16).
After each transition the links are wrapped into ``[-pi, pi)``.

Departures from the published description:

- periodic padding of both convs where the published net pads with zeros
  (a lattice is a torus; the program does the same);
- the flattened conv outputs in (channel, t, x) order, the row order of the
  weights as given (the published net flattens (t, x, channel): a
  relabelling of the same rows);
- no local response normalization (``use_lrn`` false in the configuration);
- the weights are drawn from a seed, not trained.

``Precision`` (``chains.py``) sets the products' arithmetic: ``f32`` (the
configuration's, TF32 off) or ``tf32`` (every product's operands rounded
to TF32): the control.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_h100.reference import lattice
from bench_h100.reference.chains import (F32, _circle_scale, _flat_force,
                                        _heads, _prob, _time_enc)

BLOCK = 2048        # chains computed at once


def periodic_conv(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  stride: int, prec) -> torch.Tensor:
    """``out[o, t, s] = b[o] + sum_{c, i, j} w[o, c, i, j]
    y[c, stride t + i - lo, stride s + j - lo]`` with indices modulo the
    lattice and ``lo = (k - 1) // 2``: ``y (B, C, H, W)``, ``w (O, C, k,
    k)``."""
    k = w.shape[-1]
    lo = (k - 1) // 2
    out = b[None, :, None, None]
    for i in range(k):
        for j in range(k):
            tap = torch.roll(y, shifts=(lo - i, lo - j), dims=(2, 3))
            tap = tap[:, :, ::stride, ::stride]
            out = out + prec.einsum("bchw,oc->bohw", tap, w[:, :, i, j])
    return out


class ConvNet:
    """``(v_slot, x_slot, tau) -> (S, T, Q)``, each ``(B, 2 d)``, from the
    leaves ``conv_{x,v}{1,2}.w (O, C, k, k)`` and ``.b``, ``{x,v}_layer.w
    (f2 lt/2 lx/2, h)`` and ``.b``, ``t_layer``, ``h_layer``, ``head_w (h,
    3 2d)``, ``head_b``, ``coeff_scale`` and ``coeff_transformation (1,
    2d)``.  A flat slot of ``2 d`` numbers is the link pair of each site
    (channels: the t link, the x link); one of ``4 d`` is ``[cos | sin]``
    of the links (channels cos t, cos x, sin t, sin x)."""

    def __init__(self, w: Dict[str, torch.Tensor], lt: int, lx: int,
                 bounded_q: bool):
        self.w, self.lt, self.lx, self.bounded_q = w, lt, lx, bounded_q

    def image(self, flat: torch.Tensor) -> torch.Tensor:
        b = flat.shape[0]
        halves = torch.chunk(flat, flat.shape[1] // (2 * self.lt * self.lx),
                             dim=1)
        chans = []
        for half in halves:
            pair = half.reshape(b, self.lt, self.lx, 2)
            chans += [pair[..., 0], pair[..., 1]]
        return torch.stack(chans, dim=1)

    def stack(self, flat, name: str, prec) -> torch.Tensor:
        w = self.w
        y = torch.relu(periodic_conv(self.image(flat), w[f"conv_{name}1.w"],
                                     w[f"conv_{name}1.b"], 1, prec))
        y = torch.relu(periodic_conv(y, w[f"conv_{name}2.w"],
                                     w[f"conv_{name}2.b"], 2, prec))
        return y.reshape(y.shape[0], -1)

    def __call__(self, v_slot, x_slot, tau, prec):
        w = self.w
        h = torch.relu(
            prec.matmul(self.stack(v_slot, "v", prec), w["v_layer.w"])
            + w["v_layer.b"]
            + prec.matmul(self.stack(x_slot, "x", prec), w["x_layer.w"])
            + w["x_layer.b"]
            + prec.matmul(tau, w["t_layer.w"]) + w["t_layer.b"])
        h = torch.relu(prec.matmul(h, w["h_layer.w"]) + w["h_layer.b"])
        heads = prec.matmul(h, w["head_w"]) + w["head_b"]
        s, t, q = torch.chunk(heads, 3, dim=1)
        return _heads(s, t, q, w["coeff_scale"], w["coeff_transformation"],
                      self.bounded_q)


def split_transition(x, v, dsign, u, xnet, vnet, masks, eps, beta, lt, lx,
                     prec=F32):
    """One transition of the split integrator: flat states ``x (B, 2d)``,
    momenta ``v``, directions ``dsign (B,)`` in {+1, -1}, accept uniforms
    ``u``.  Returns ``(x_out, prob)``."""
    K = masks.shape[0]
    b = x.shape[0]
    d_col = dsign[:, None]
    fwd = d_col > 0

    def half_kick(y, w, g, tau):
        s, t, q = vnet(torch.cat([torch.cos(y), torch.sin(y)], 1), g, tau,
                       prec)
        hs = 0.5 * eps * s
        a = 0.5 * eps * (torch.exp(eps * q) * g - t)
        e = torch.exp(d_col * hs)
        w = torch.where(fwd, w * e - a, (w + a) * e)
        return w, dsign * torch.sum(hs, dim=1)

    def update_x(y, w, tau, hold):
        feats = torch.cat([hold * torch.cos(y), hold * torch.sin(y)], 1)
        s, t, q = xnet(w, feats, tau, prec)
        es = eps * s
        bb = eps * (torch.exp(eps * q) * w + t)
        u_in = torch.where(fwd, y, lattice.wrap(y - bb))
        y2, ld = _circle_scale(u_in, d_col * es)
        upd = torch.where(fwd, lattice.wrap(y2 + bb), y2)
        y = hold * y + (1.0 - hold) * upd
        return y, torch.sum((1.0 - hold) * ld, dim=1)

    g = _flat_force(x, lt, lx, beta)
    y, w = x, v
    logdet = torch.zeros(b, dtype=x.dtype, device=x.device)
    for step in range(K):
        idx = torch.where(dsign > 0, float(step), float(K - 1 - step))
        tau = _time_enc(idx, K)
        mask = masks[idx.long()]
        hold1 = torch.where(fwd, mask, 1.0 - mask)
        w, l0 = half_kick(y, w, g, tau)
        y, l1 = update_x(y, w, tau, hold1)
        y, l2 = update_x(y, w, tau, 1.0 - hold1)
        g = _flat_force(y, lt, lx, beta)
        w, l3 = half_kick(y, w, g, tau)
        logdet = logdet + l0 + l1 + l2 + l3
    cos0 = torch.cos(lattice.plaquettes(x.reshape(b, lt, lx, 2)))
    cos1 = torch.cos(lattice.plaquettes(y.reshape(b, lt, lx, 2)))
    dh = (beta * torch.sum((cos1 - cos0).flatten(1), dim=1)
          + 0.5 * torch.sum(v * v - w * w, dim=1) + logdet)
    prob = _prob(dh, y, w)
    return torch.where((u < prob)[:, None], y, x), prob


def draws(generator: torch.Generator, b: int, x_dim: int, num: int):
    """The call's ``num`` transitions' ``(v, dsign, u)``, drawn in the
    program's order from ``generator`` (advanced)."""
    dev = generator.device
    out = []
    for _ in range(num):
        v = torch.randn((b, x_dim), generator=generator, device=dev)
        dsign = torch.where(torch.rand((b,), generator=generator,
                                       device=dev) > 0.5, 1.0, -1.0)
        u = torch.rand((b,), generator=generator, device=dev)
        out.append((v, dsign, u))
    return out


def conv_call(links, xnet, vnet, masks, generator, eps, beta, num,
              prec=F32, block=BLOCK):
    """``num`` transitions of ``links (B, Lt, Lx, 2)`` with the draws of
    ``generator`` (advanced past the call's), ``block`` chains at once:
    ``(links_out, plaq (N, B), charge (N, B), prob (N, B), u (N, B))``."""
    b, lt, lx, _ = links.shape
    drawn = draws(generator, b, 2 * lt * lx, num)
    outs, traces = [], {k: [] for k in ("plaq", "charge", "prob")}
    for lo in range(0, b, block):
        sl = slice(lo, min(lo + block, b))
        x = links[sl].reshape(sl.stop - lo, -1)
        rows = {k: [] for k in traces}
        for v, dsign, u in drawn:
            x, prob = split_transition(x, v[sl], dsign[sl], u[sl], xnet,
                                       vnet, masks, eps, beta, lt, lx, prec)
            x = lattice.wrap(x)
            xl = x.reshape(-1, lt, lx, 2)
            rows["plaq"].append(1.0 - lattice.action(xl) / (lt * lx))
            rows["charge"].append(torch.round(lattice.charge(xl)))
            rows["prob"].append(prob)
        outs.append(x.reshape(-1, lt, lx, 2))
        for k in traces:
            traces[k].append(torch.stack(rows[k]))
    u = torch.stack([d[2] for d in drawn])
    return (torch.cat(outs),) + tuple(torch.cat(traces[k], dim=1)
                                      for k in ("plaq", "charge", "prob")) + (u,)
