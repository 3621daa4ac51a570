"""Plain PyTorch references of the fused U(1) chains: HMC and trained L2HMC.

Both replay a whole call of the program's chain kernels on the kernels'
own random stream (``philox.py``): ``N`` transitions of ``B`` chains from
the call's input links, returning the links out and the ``(N, B)``
plaquette, charge and accept-probability traces, and the accept uniforms.

The L2HMC transition follows the original dataflow on the flat interleaved
state (``merge_v_halves``, the ``u1`` group: cos/sin features and the
circle map with its exact log-Jacobian, one direction per chain drawn per
transition, ``bounded_q``), with its conditioners built from the
UNPACKED weights as the checkpoint stores them: an MLP (``in_w``, ``in_b``,
``h_layer``, ``head``, the coefficients) or a local 5-point stencil net.
The energy change is summed from per-site differences (each Hamiltonian
alone is ~1e3 at 16x16, and their difference in float32 would carry
~1e-4 of rounding).

``Precision`` sets the arithmetic: ``f32`` (the configurations' own,
TF32 off), ``tf32`` (every product's operands rounded to TF32, as one
tensor-core pass takes them) and ``bf16`` (the leapfrog's positions,
momenta and forces rounded to bfloat16 at every update, and the products'
operands too): the two controls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from bench_h100.reference import lattice, philox

STENCIL_OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Nearest TF32 value (10 mantissa bits), ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@dataclass(frozen=True)
class Precision:
    name: str = "f32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return tf32_round(t)
        if self.name == "bf16":
            return t.bfloat16().float()
        return t

    def state(self, t: torch.Tensor) -> torch.Tensor:
        return t.bfloat16().float() if self.name == "bf16" else t

    def matmul(self, a, w):
        return self.operand(a) @ self.operand(w)

    def einsum(self, eq, a, w):
        return torch.einsum(eq, self.operand(a), self.operand(w))


F32 = Precision("f32")


def float32_only():
    """Products in full float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# HMC
# ---------------------------------------------------------------------------


def hmc_transition(links, v, u, eps, beta, num_leapfrog, prec=F32):
    """One HMC transition of ``(B, Lt, Lx, 2)`` links with momenta ``v``
    of the same shape and accept uniforms ``u (B,)``.  Returns
    ``(links_out, prob)``."""
    cos0 = torch.cos(lattice.plaquettes(links))
    w = prec.state(v - 0.5 * eps * lattice.force(links, beta))
    y = links
    for k in range(num_leapfrog):
        y = prec.state(lattice.wrap(y + eps * w))
        c = eps if k < num_leapfrog - 1 else 0.5 * eps
        w = prec.state(w - c * prec.state(lattice.force(y, beta)))
    cos1 = torch.cos(lattice.plaquettes(y))
    dke = 0.5 * torch.sum((v * v - w * w).flatten(1), dim=1)
    dh = beta * torch.sum((cos1 - cos0).flatten(1), dim=1) + dke
    prob = _prob(dh, y, w)
    acc = (u < prob)[:, None, None, None]
    return torch.where(acc, y, links), prob


def _prob(dh, y, w):
    """``exp(min(dh, 0))``, 0 where it or the proposal is not finite."""
    prob = torch.exp(torch.clamp(dh, max=0.0))
    finite = torch.isfinite(y.flatten(1).abs().sum(1)
                            + w.flatten(1).abs().sum(1))
    return torch.where(torch.isfinite(prob) & finite, prob,
                       torch.zeros_like(prob))


def _traces(links):
    d = links.shape[1] * links.shape[2]
    return 1.0 - lattice.action(links) / d, torch.round(lattice.charge(links))


def hmc_call(links, seed, eps, beta, num_leapfrog, num, prec=F32, chain0=0):
    """``num`` HMC transitions on the kernel's stream of ``seed``:
    ``(links_out, plaq (N, B), charge (N, B), prob (N, B), u (N, B))``."""
    b, lt, lx, _ = links.shape
    d = lt * lx
    out = {k: [] for k in ("plaq", "charge", "prob", "u")}
    x = links
    for n in range(num):
        v0, v1 = philox.momenta(seed, b, d, n, num, links.device, chain0)
        u = philox.scalars(seed, b, d, n, num, links.device, chain0)[0]
        v = torch.stack([v0.reshape(b, lt, lx), v1.reshape(b, lt, lx)], -1)
        x, prob = hmc_transition(x, v, u, eps, beta, num_leapfrog, prec)
        plaq, chg = _traces(x)
        for k, t in (("plaq", plaq), ("charge", chg), ("prob", prob),
                     ("u", u)):
            out[k].append(t)
    return (x,) + tuple(torch.stack(out[k]) for k in
                        ("plaq", "charge", "prob", "u"))


# ---------------------------------------------------------------------------
# Trained L2HMC: the conditioners from unpacked weights
# ---------------------------------------------------------------------------


def _heads(s_raw, t, q_raw, cs, ct, bounded_q):
    s = torch.tanh(s_raw) * torch.exp(cs)
    if bounded_q:
        q_raw = torch.tanh(q_raw)
    return s, t, q_raw * torch.exp(ct)


class MLPNet:
    """``(v_slot, x_slot, tau) -> (S, T, Q)``, each ``(B, 2d)``, from the
    checkpoint's leaves ``in_w (dv + dx + 2, h)``, ``in_b``, ``h_layer``
    (``w``, ``b``), ``head_w (h, 3 2d)``, ``head_b``, ``coeff_scale``,
    ``coeff_transformation``."""

    def __init__(self, w: Dict[str, torch.Tensor], bounded_q: bool):
        self.w, self.bounded_q = w, bounded_q

    def __call__(self, v_slot, x_slot, tau, prec):
        w = self.w
        inp = torch.cat([v_slot, x_slot, tau], dim=1)
        h = torch.relu(prec.matmul(inp, w["in_w"]) + w["in_b"])
        h = torch.relu(prec.matmul(h, w["h_layer.w"]) + w["h_layer.b"])
        heads = prec.matmul(h, w["head_w"]) + w["head_b"]
        s, t, q = torch.chunk(heads, 3, dim=1)
        return _heads(s, t, q, w["coeff_scale"], w["coeff_transformation"],
                      self.bounded_q)


class StencilNet:
    """The local 5-point stencil conditioner from its leaves
    ``stencil_0.w (5, cin, c)``, ``stencil_0.wt (2, c)``, ``stencil_i.b``,
    further ``stencil_i.w (5, c, c)``, ``head.w (c, 6)``, ``head.b (6,)``
    with outputs ``[S0 S1 T0 T1 Q0 Q1]``, and per-direction coefficients
    ``(2,)``.  A flat slot of two channels is the link pair of each site, one
    of four the ``[cos | sin]`` features' pairs."""

    def __init__(self, w: Dict[str, torch.Tensor], layers: int, lt: int,
                 lx: int, bounded_q: bool):
        self.w, self.layers, self.lt, self.lx = w, layers, lt, lx
        self.bounded_q = bounded_q

    def _channels(self, flat, n_ch):
        b = flat.shape[0]
        if n_ch == 2:
            pair = flat.reshape(b, self.lt, self.lx, 2)
            return [pair[..., 0], pair[..., 1]]
        cos_p, sin_p = torch.chunk(flat, 2, dim=1)
        return self._channels(cos_p, 2) + self._channels(sin_p, 2)

    def __call__(self, v_slot, x_slot, tau, prec):
        w = self.w
        d = self.lt * self.lx
        y = torch.stack(self._channels(v_slot, v_slot.shape[1] // d)
                        + self._channels(x_slot, x_slot.shape[1] // d), 1)
        for i in range(self.layers):
            sh = torch.stack([torch.roll(y, (dt, ds), dims=(2, 3))
                              for dt, ds in STENCIL_OFFSETS], 1)
            out = (prec.einsum("bocts,ocj->bjts", sh, w[f"stencil_{i}.w"])
                   + w[f"stencil_{i}.b"][None, :, None, None])
            if i == 0:
                out = out + prec.matmul(tau, w["stencil_0.wt"])[:, :, None,
                                                                 None]
            y = torch.relu(out)
        head = (prec.einsum("bcts,ck->bkts", y, w["head.w"])
                + w["head.b"][None, :, None, None])
        b = head.shape[0]

        def join(r0, r1):
            return torch.stack([head[:, r0], head[:, r1]], -1).reshape(b, -1)

        cs = w["coeff_scale"].repeat(d)
        ct = w["coeff_transformation"].repeat(d)
        return _heads(join(0, 1), join(2, 3), join(4, 5), cs, ct,
                      self.bounded_q)


def _time_enc(idx, num_steps):
    ang = 2.0 * math.pi * idx / num_steps
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def _circle_scale(x, a):
    """``2 atan2(e^a sin(x/2), cos(x/2))`` and its log-Jacobian."""
    s2, c2 = torch.sin(0.5 * x), torch.cos(0.5 * x)
    ea = torch.exp(a)
    return (2.0 * torch.atan2(ea * s2, c2),
            a - torch.log(c2 * c2 + ea * ea * s2 * s2))


def _flat_force(x, lt, lx, beta):
    b = x.shape[0]
    return lattice.force(x.reshape(b, lt, lx, 2), beta).reshape(b, -1)


def l2hmc_transition(x, v, dsign, u, xnet, vnet, masks, eps, beta, lt, lx,
                     prec=F32):
    """One trained transition of flat states ``x (B, 2d)`` with momenta
    ``v``, directions ``dsign (B,)`` in {+1, -1} and accept uniforms ``u``.
    Returns ``(x_out, prob)``."""
    K = masks.shape[0]
    b = x.shape[0]
    d_col = dsign[:, None]
    fwd = d_col > 0

    def update_v(y, w, g, tau, factor):
        s, t, q = vnet(torch.cat([torch.cos(y), torch.sin(y)], 1), g, tau,
                       prec)
        hs = factor * eps * s
        a = factor * eps * (torch.exp(eps * q) * g - t)
        e = torch.exp(d_col * hs)
        w = torch.where(fwd, w * e - a, (w + a) * e)
        return prec.state(w), dsign * torch.sum(hs, dim=1)

    def update_x(y, w, tau, hold):
        feats = torch.cat([hold * torch.cos(y), hold * torch.sin(y)], 1)
        s, t, q = xnet(w, feats, tau, prec)
        es = eps * s
        bb = eps * (torch.exp(eps * q) * w + t)
        u_in = torch.where(fwd, y, lattice.wrap(y - bb))
        y2, ld = _circle_scale(u_in, d_col * es)
        upd = torch.where(fwd, lattice.wrap(y2 + bb), y2)
        y = hold * y + (1.0 - hold) * upd
        return prec.state(y), torch.sum((1.0 - hold) * ld, dim=1)

    g = prec.state(_flat_force(x, lt, lx, beta))
    y, w = x, v
    logdet = torch.zeros(b, dtype=x.dtype, device=x.device)
    for step in range(K):
        idx = torch.where(dsign > 0, float(step), float(K - 1 - step))
        tau_x = _time_enc(idx, K)
        mask = masks[idx.long()]
        hold1 = torch.where(fwd, mask, 1.0 - mask)
        factor = 0.5 if step == 0 else 1.0
        t_fwd = 0.0 if step == 0 else step - 0.5
        t_bwd = K - 1.0 if step == 0 else K - 0.5 - step
        tau_v = _time_enc(torch.where(dsign > 0, t_fwd, t_bwd), K)
        w, l0 = update_v(y, w, g, tau_v, factor)
        y, l1 = update_x(y, w, tau_x, hold1)
        y, l2 = update_x(y, w, tau_x, 1.0 - hold1)
        g = prec.state(_flat_force(y, lt, lx, beta))
        logdet = logdet + l0 + l1 + l2
    tau_v = _time_enc(torch.where(dsign > 0, K - 1.0, 0.0), K)
    w, l3 = update_v(y, w, g, tau_v, 0.5)
    logdet = logdet + l3
    cos0 = torch.cos(lattice.plaquettes(x.reshape(b, lt, lx, 2)))
    cos1 = torch.cos(lattice.plaquettes(y.reshape(b, lt, lx, 2)))
    dh = (beta * torch.sum((cos1 - cos0).flatten(1), dim=1)
          + 0.5 * torch.sum(v * v - w * w, dim=1) + logdet)
    prob = _prob(dh, y, w)
    return torch.where((u < prob)[:, None], y, x), prob


def l2hmc_call(links, xnet, vnet, masks, seed, eps, beta, num, prec=F32,
               chain0=0):
    """``num`` trained transitions on the kernel's stream of ``seed``:
    ``(links_out, plaq, charge, prob, u)`` as :func:`hmc_call`."""
    b, lt, lx, _ = links.shape
    d = lt * lx
    out = {k: [] for k in ("plaq", "charge", "prob", "u")}
    x = links.reshape(b, -1)
    for n in range(num):
        v0, v1 = philox.momenta(seed, b, d, n, num, links.device, chain0)
        w = philox.scalars(seed, b, d, n, num, links.device, chain0)
        v = torch.stack([v0, v1], -1).reshape(b, -1)
        x, prob = l2hmc_transition(x, v, philox.sign(w[0]), w[1], xnet, vnet,
                                   masks, eps, beta, lt, lx, prec)
        plaq, chg = _traces(x.reshape(b, lt, lx, 2))
        for k, t in (("plaq", plaq), ("charge", chg), ("prob", prob),
                     ("u", w[1])):
            out[k].append(t)
    return (x.reshape(b, lt, lx, 2),) + tuple(
        torch.stack(out[k]) for k in ("plaq", "charge", "prob", "u"))
