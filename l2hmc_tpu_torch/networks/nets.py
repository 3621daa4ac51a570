"""Scale/translation/transformation (S, T, Q) conditioners.

Port of ``l2hmc_tpu/networks/nets.py``:

- ``MLPNetSpec``/``make_mlp_net``: the three input embeddings (v, x, t) are
  one matmul over the concatenated input, hidden dense, ReLU, and one fused
  head matmul split into ``scale = tanh(.) * exp(coeff_scale)``,
  ``translation``, ``transformation = [tanh](.) * exp(coeff_transformation)``.
  Parameters keep the reference's names and ``(in, out)`` layouts, so a JAX
  pytree loads with a copy: ``in_w`` rows ``[v | x-features | t]``,
  ``head_w`` columns ``[S | T | Q]``, ``h_layer.w``/``h_layer.b``.
  ``use_bf16`` rounds each matmul's two operands to bfloat16 and takes the
  product in float32 (the reference's bf16 operands with float32
  accumulation).
- ``make_zero_net``: S = T = Q = 0 (``network_arch='zero'``), with which the
  augmented leapfrog is plain leapfrog.
- ``LocalNetSpec``/``make_local_flat_net``: the weight-shared local
  conditioner on the flat link layout — ``num_layers`` periodic 5-point
  stencil layers over per-direction channels, a 1x1 head to per-link S/T/Q.
  Parameters ``stencil_{i}.{w,wt,b}``, ``head.{w,b}``, ``coeff_scale``,
  ``coeff_transformation`` as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from l2hmc_tpu_torch.ops.leapfrog import _nb


def _variance_scaling(generator: Optional[torch.Generator], shape,
                      factor: float, device=None) -> torch.Tensor:
    """Truncated-normal (at 2 sigma) variance scaling, fan-in mode:
    stddev = sqrt(1.3 * 2*factor / fan_in)."""
    fan_in = shape[0]
    stddev = float(np.sqrt(1.3 * 2.0 * factor / fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * stddev


def matmul(x, w, bf16: bool = False):
    """``x @ w``; with ``bf16`` both operands are rounded to bfloat16 and the
    product is taken in float32, where a product of two bfloat16 values is
    exact, so only the order of the sum can differ from the reference's
    bf16-input, float32-accumulating matmul."""
    if bf16:
        return x.bfloat16().float() @ w.bfloat16().float()
    return x @ w


class Dense(nn.Module):
    """``y = x @ w + b`` with ``w`` stored ``(in, out)``."""

    def __init__(self, in_dim: int, out_dim: int, factor: float,
                 generator=None, device=None):
        super().__init__()
        self.w = nn.Parameter(
            _variance_scaling(generator, (in_dim, out_dim), factor, device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x, bf16: bool = False):
        return matmul(x, self.w, bf16) + self.b


@dataclasses.dataclass(frozen=True)
class MLPNetSpec:
    """Static architecture spec (same fields as the reference)."""

    x_dim: int
    num_hidden: int
    factor: float = 1.0  # 2.0 for XNet, 1.0 for VNet
    use_bf16: bool = False
    bounded_q: bool = False
    aux_dim: int = 0
    # input dims when they differ from x_dim (periodic cos/sin position
    # features double the position slot); 0 -> x_dim
    v_in_dim: int = 0
    x_in_dim: int = 0


class MLPNet(nn.Module):
    """The fused GenericNet-parity MLP: ``forward(v, x, t) -> (S, T, Q)``."""

    def __init__(self, spec: MLPNetSpec, generator=None, device=None):
        super().__init__()
        if spec.aux_dim:
            raise NotImplementedError(
                "MLPNetSpec.aux_dim: aux conditioning comes with the VAE "
                "slice (ROADMAP queue A item 14)")
        self.spec = spec
        d, h = spec.x_dim, spec.num_hidden
        dv = spec.v_in_dim or d
        dx = spec.x_in_dim or d
        g = generator
        self.in_w = nn.Parameter(torch.cat([
            _variance_scaling(g, (dv, h), 1.0 / 3.0, device),
            _variance_scaling(g, (dx, h), spec.factor / 3.0, device),
            _variance_scaling(g, (2, h), 1.0 / 3.0, device),
        ], dim=0))
        self.in_b = nn.Parameter(torch.zeros(h, device=device))
        self.h_layer = Dense(h, h, 1.0, g, device)
        self.head_w = nn.Parameter(torch.cat([
            _variance_scaling(g, (h, d), 0.001, device) for _ in range(3)
        ], dim=1))
        self.head_b = nn.Parameter(torch.zeros(3 * d, device=device))
        self.coeff_scale = nn.Parameter(torch.zeros(1, d, device=device))
        self.coeff_transformation = nn.Parameter(
            torch.zeros(1, d, device=device))

    def forward(self, v, x, t):
        bf16 = self.spec.use_bf16
        inp = torch.cat([v, x, t], dim=-1)
        hh = torch.relu(matmul(inp, self.in_w, bf16) + self.in_b)
        hh = torch.relu(self.h_layer(hh, bf16))
        heads = matmul(hh, self.head_w, bf16) + self.head_b
        s_raw, translation, q_raw = torch.chunk(heads, 3, dim=-1)
        scale = torch.tanh(s_raw) * torch.exp(self.coeff_scale)
        if self.spec.bounded_q:
            q_raw = torch.tanh(q_raw)
        transformation = q_raw * torch.exp(self.coeff_transformation)
        return scale, translation, transformation


def make_mlp_net(spec: MLPNetSpec, generator=None, device=None) -> MLPNet:
    """Build the MLP conditioner module (random init from ``generator``)."""
    return MLPNet(spec, generator, device)


class ZeroNet(nn.Module):
    """S = T = Q = 0 of shape ``(B, x_dim)``; no parameters."""

    def __init__(self, x_dim: int):
        super().__init__()
        self.x_dim = x_dim

    def forward(self, v, x, t):
        z = torch.zeros((v.shape[0], self.x_dim), dtype=v.dtype,
                        device=v.device)
        return z, z, z


def make_zero_net(x_dim: int) -> ZeroNet:
    """The HMC-degenerate conditioner: with S = T = Q = 0 the augmented
    leapfrog is plain leapfrog.  The outputs have ``x_dim`` columns whatever
    the width of the inputs (the u1 features double the position slot)."""
    return ZeroNet(x_dim)


# ---------------------------------------------------------------------------
# Local 5-point-stencil conditioner
# ---------------------------------------------------------------------------

# stencil offsets (dt, ds) in the reference's roll convention: the term of
# offset (dt, ds) reads the input at site (t - dt, s - ds)
STENCIL_OFF = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))


def stencil_layer(chans: Sequence[torch.Tensor], w: torch.Tensor,
                  bias: torch.Tensor, lx: int,
                  tau: Optional[torch.Tensor] = None,
                  wt: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """One periodic 5-point stencil layer with ReLU on flat ``(B, d)``
    channels: ``out_j = relu(b_j [+ tau @ wt_j] + sum_{o,c} w[o,c,j]
    in_c(site - off_o))``.  ``w (5, cin, cout)``; ``tau (B, 2)`` is the
    time encoding, entering as a per-chain bias (a convolution over
    constant channels)."""
    sh = torch.stack([torch.stack([_nb(a, lx, -dt, -ds)
                                   for dt, ds in STENCIL_OFF]) for a in chans])
    out = torch.einsum("cobd,ocj->jbd", sh, w) + bias[:, None, None]
    if tau is not None:
        out = out + (tau @ wt).t()[:, :, None]
    return list(torch.relu(out))


def stencil_head(y: Sequence[torch.Tensor], hw: torch.Tensor,
                 hb: torch.Tensor, cs: torch.Tensor, ct: torch.Tensor,
                 bounded_q: bool):
    """1x1 head ``(c, 6)`` with outputs ``[S0 S1 T0 T1 Q0 Q1]`` -> per
    direction ``[(s0, t0, q0), (s1, t1, q1)]`` with the tanh/exp combines
    and the per-direction coefficients ``cs, ct (2,)``."""
    head = torch.einsum("cbd,ck->kbd", torch.stack(list(y)), hw) \
        + hb[:, None, None]
    out = []
    for r in (0, 1):
        s = torch.tanh(head[r]) * torch.exp(cs[r])
        q = head[4 + r]
        if bounded_q:
            q = torch.tanh(q)
        out.append((s, head[2 + r], q * torch.exp(ct[r])))
    return out


@dataclasses.dataclass(frozen=True)
class LocalNetSpec:
    """Static spec of the weight-shared local conditioner (same fields as
    the reference).  ``use_bf16`` is accepted and, as in the reference's
    flat stencil net, has no effect: the stencil computes in float32."""

    time_size: int
    space_size: int
    channels: int = 8
    kernel_size: int = 3
    num_layers: int = 2
    factor: float = 1.0          # x-slot input-channel init scaling
    use_bf16: bool = False
    bounded_q: bool = False
    v_channels: int = 2          # 2 link dirs; 4 with cos/sin features
    x_channels: int = 2

    @property
    def x_dim(self) -> int:
        return self.time_size * self.space_size * 2


class _Layer(nn.Module):
    """Weights ``w``, bias ``b`` and, for stencil layer 0, the time rows
    ``wt``: the reference's per-layer parameter dict."""

    def __init__(self, w, b, wt=None):
        super().__init__()
        self.w = nn.Parameter(w)
        if wt is not None:
            self.wt = nn.Parameter(wt)
        self.b = nn.Parameter(b)


class LocalFlatNet(nn.Module):
    """The flat-layout local conditioner: ``forward(v, x, t) -> (S, T, Q)``,
    each ``(B, x_dim)`` in the interleaved link order.

    Inputs are split into per-direction ``(B, d)`` channels: a 2-channel
    slot is the link pair, a 4-channel slot the ``[cos | sin]`` position
    features.  Layer 0 sees ``v`` channels then ``x`` channels.
    """

    def __init__(self, spec: LocalNetSpec, generator=None, device=None):
        super().__init__()
        if spec.kernel_size != 3:
            # the stencil support is the fixed 5-point cross (the k=3
            # conv's nearest-neighbour subset)
            raise ValueError(
                f"make_local_flat_net supports kernel_size=3 only (5-point "
                f"cross stencil); got {spec.kernel_size}")
        self.spec = spec
        c = spec.channels
        n_off = len(STENCIL_OFF)
        cin = spec.v_channels + spec.x_channels
        fan0 = n_off * cin + 2
        kw = dict(generator=generator, dtype=torch.float32, device=device)
        w0 = torch.randn((n_off, cin, c), **kw) * float(np.sqrt(2.0 / fan0))
        # factor-scaled init on the x-slot input channels
        lo, hi = spec.v_channels, spec.v_channels + spec.x_channels
        w0[:, lo:hi, :] *= float(np.sqrt(spec.factor))
        wt = torch.randn((2, c), **kw) * float(np.sqrt(2.0 / fan0))
        self.stencil_0 = _Layer(w0, torch.zeros(c, device=device), wt)
        for i in range(1, spec.num_layers):
            wi = torch.randn((n_off, c, c), **kw) * float(
                np.sqrt(2.0 / (n_off * c)))
            self.add_module(f"stencil_{i}",
                            _Layer(wi, torch.zeros(c, device=device)))
        # 1x1 head, 0.001 factor so the sampler starts near plain HMC
        std = float(np.sqrt(1.3 * 2.0 * 0.001 / c))
        hw = torch.empty((c, 6), dtype=torch.float32, device=device)
        nn.init.trunc_normal_(hw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        self.head = _Layer(hw * std, torch.zeros(6, device=device))
        self.coeff_scale = nn.Parameter(torch.zeros(2, device=device))
        self.coeff_transformation = nn.Parameter(torch.zeros(2, device=device))

    def stencils(self):
        return [getattr(self, f"stencil_{i}")
                for i in range(self.spec.num_layers)]

    def apply_channels(self, chans, tau):
        """Per-direction ``[(s0, t0, q0), (s1, t1, q1)]`` from the layer-0
        input channels (a list of ``(B, d)``) and ``tau (B, 2)``."""
        lx = self.spec.space_size
        st = self.stencils()
        y = stencil_layer(chans, st[0].w, st[0].b, lx, tau, st[0].wt)
        for s in st[1:]:
            y = stencil_layer(y, s.w, s.b, lx)
        return stencil_head(y, self.head.w, self.head.b, self.coeff_scale,
                            self.coeff_transformation, self.spec.bounded_q)

    def forward(self, v, x, t):
        b = v.shape[0]
        d = self.spec.time_size * self.spec.space_size

        def split_dir(flat, n_ch):
            if n_ch == 2:
                pair = flat.reshape(b, d, 2)
                return [pair[:, :, 0], pair[:, :, 1]]
            cos_p, sin_p = torch.chunk(flat, 2, dim=-1)
            return split_dir(cos_p, 2) + split_dir(sin_p, 2)

        chans = (split_dir(v, self.spec.v_channels)
                 + split_dir(x, self.spec.x_channels))
        (s0, t0, q0), (s1, t1, q1) = self.apply_channels(chans, t)

        def join(c0, c1):
            return torch.stack([c0, c1], dim=-1).reshape(b, 2 * d)

        return join(s0, s1), join(t0, t1), join(q0, q1)


def make_local_flat_net(spec: LocalNetSpec, generator=None,
                        device=None) -> LocalFlatNet:
    """Build the flat local conditioner (random init from ``generator``)."""
    return LocalFlatNet(spec, generator, device)
