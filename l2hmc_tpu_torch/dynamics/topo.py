"""Exact instanton hops for 2-D U(1) (port of ``l2hmc_tpu/dynamics/topo.py``).

On the torus the constant-field-strength configuration ``w`` has winding
number 1: every plaquette angle is ``delta = 2 pi / V`` mod 2 pi.  The hop
proposes ``x' = x + nu w`` with a sign-symmetric random ``nu``; the proposal
is symmetric and volume-preserving, so ``min(1, exp(-beta dS))`` is an exact
Metropolis test, and the action change has the closed form::

    dS = (1 - cos d) sum_p cos P_p + sin d sum_p sin P_p,   d = 2 pi nu / V

:func:`instanton_hop_with` takes the draws (``nu``, the accept uniform ``u``)
as tensors; :func:`instanton_hop` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from l2hmc_tpu_torch._device import resolve_device
from l2hmc_tpu_torch.lattice import u1

TWO_PI = 2.0 * np.pi


def winding_field(shape: u1.LatticeShape, nu: int = 1,
                  device=None) -> torch.Tensor:
    """Flat link field ``w (num_links,)`` of winding number ``nu``:
    ``w1(t, x) = delta t``, ``w0(Lt-1, x) = -delta Lt x`` (the seam row),
    ``delta = 2 pi nu / (Lt Lx)``.  Built in numpy as the reference builds
    it, on ``device`` (``None``: the first CUDA device)."""
    lt, lx = shape.time_size, shape.space_size
    delta = TWO_PI * nu / (lt * lx)
    w = np.zeros((lt, lx, 2), dtype=np.float32)
    w[:, :, 1] = delta * np.arange(lt, dtype=np.float32)[:, None]
    w[lt - 1, :, 0] = -delta * lt * np.arange(lx, dtype=np.float32)
    return torch.tensor(w.reshape(-1), device=resolve_device(device))


def hop_delta_s(x: torch.Tensor, shape: u1.LatticeShape,
                nu: torch.Tensor) -> torch.Tensor:
    """Exact ``S(x + nu w) - S(x)`` per sample from one plaquette pass;
    ``x (..., num_links)``, ``nu`` broadcasting against the batch."""
    p = u1.plaq_sums(u1.to_links(x, shape))
    sum_cos = torch.sum(torch.cos(p), dim=(-2, -1))
    sum_sin = torch.sum(torch.sin(p), dim=(-2, -1))
    d = TWO_PI * nu.to(x.dtype) / shape.num_plaquettes
    return (1.0 - torch.cos(d)) * sum_cos + torch.sin(d) * sum_sin


class HopOut(NamedTuple):
    x_out: torch.Tensor        # (batch, num_links), wrapped
    accept_prob: torch.Tensor  # (batch,) min(1, exp(-beta dS))
    accept_mask: torch.Tensor  # (batch,) 0/1
    nu: torch.Tensor           # (batch,) winding applied (0 if rejected)


def instanton_hop_with(x: torch.Tensor, beta, nu: torch.Tensor,
                       u: torch.Tensor, shape: u1.LatticeShape) -> HopOut:
    """One Metropolis winding hop with injected draws: ``nu (batch,)``
    signed windings, ``u (batch,)`` accept uniforms."""
    nu = nu.to(x.dtype)
    ds = hop_delta_s(x, shape, nu)
    prob = torch.exp(torch.clamp(-beta * ds, max=0.0))
    prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
    accept = (u < prob).to(x.dtype)
    w1 = winding_field(shape, 1, x.device)
    x_prop = u1.wrap(x + nu[..., None] * w1[None, :])
    x_out = accept[..., None] * x_prop + (1.0 - accept[..., None]) * x
    return HopOut(x_out=x_out, accept_prob=prob, accept_mask=accept,
                  nu=nu * accept)


def draw_hop(generator, batch: int, nu_max: int = 1, device=None):
    """``(nu, u)`` for :func:`instanton_hop_with`: ``nu`` uniform over
    ``{-nu_max..-1, 1..nu_max}``, ``u`` uniform in [0, 1)."""
    mag = torch.randint(1, nu_max + 1, (batch,), generator=generator,
                        device=device)
    sign = torch.randint(0, 2, (batch,), generator=generator,
                         device=device) * 2 - 1
    u = torch.rand((batch,), generator=generator, device=device)
    return (mag * sign).to(torch.float32), u


def instanton_hop(x: torch.Tensor, beta, generator, shape: u1.LatticeShape,
                  nu_max: int = 1) -> HopOut:
    """One Metropolis winding hop for a batch of chains, draws from
    ``generator`` (on ``x``'s device)."""
    nu, u = draw_hop(generator, x.shape[0], nu_max, x.device)
    return instanton_hop_with(x, beta, nu, u, shape)


def make_hop_eval_chunk(cfg, chunk_size: int, n_hops: int = 1,
                        nu_max: int = 1):
    """Sampling chunk interleaving the configured dynamics with ``n_hops``
    instanton hops per step: ``chunk(params, x, beta, generator) -> (x,
    metrics)``, the metrics of ``train.gauge.make_eval_chunk`` plus
    ``hop_accept`` (mean hop probability) and ``hop_dq`` (mean |nu|
    accepted), each ``(chunk_size, B)``."""
    from l2hmc_tpu_torch.train.gauge import build_dynamics

    _, dyn = build_dynamics(cfg)
    shape = cfg.shape

    @torch.no_grad()
    def chunk(params, x, beta, generator):
        keys = ("accept_prob", "actions", "plaqs", "charges", "wloop22",
                "hop_accept", "hop_dq")
        out = {k: [] for k in keys}
        for _ in range(chunk_size):
            tr = dyn["transition"](params, x, beta, generator)
            x = u1.wrap(tr.x_out)
            hp, hdq = [], []
            for _ in range(n_hops):
                h = instanton_hop(x, beta, generator, shape, nu_max)
                x = h.x_out
                hp.append(h.accept_prob)
                hdq.append(torch.abs(h.nu))
            obs = u1.observables(x, shape)
            out["accept_prob"].append(tr.accept_prob)
            for k in ("actions", "plaqs", "charges"):
                out[k].append(obs[k])
            out["wloop22"].append(u1.wilson_loop(u1.to_links(x, shape), 2, 2))
            out["hop_accept"].append(torch.stack(hp).mean(dim=0))
            out["hop_dq"].append(torch.stack(hdq).mean(dim=0))
        return x, {k: torch.stack(v) for k, v in out.items()}

    return chunk
