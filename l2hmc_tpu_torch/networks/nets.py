"""Scale/translation/transformation (S, T, Q) MLP conditioner.

Port of ``l2hmc_tpu/networks/nets.py`` ``MLPNetSpec``/``make_mlp_net``: the
three input embeddings (v, x, t) are one matmul over the concatenated input,
hidden dense, ReLU, and one fused head matmul split into
``scale = tanh(.) * exp(coeff_scale)``, ``translation``,
``transformation = [tanh](.) * exp(coeff_transformation)``.

Parameters keep the reference's names and ``(in, out)`` layouts, so a JAX
pytree loads with a copy: ``in_w`` rows ``[v | x-features | t]``,
``head_w`` columns ``[S | T | Q]``, ``h_layer.w``/``h_layer.b``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn


def _variance_scaling(generator: Optional[torch.Generator], shape,
                      factor: float, device=None) -> torch.Tensor:
    """Truncated-normal (at 2 sigma) variance scaling, fan-in mode:
    stddev = sqrt(1.3 * 2*factor / fan_in)."""
    fan_in = shape[0]
    stddev = float(np.sqrt(1.3 * 2.0 * factor / fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * stddev


class Dense(nn.Module):
    """``y = x @ w + b`` with ``w`` stored ``(in, out)``."""

    def __init__(self, in_dim: int, out_dim: int, factor: float,
                 generator=None, device=None):
        super().__init__()
        self.w = nn.Parameter(
            _variance_scaling(generator, (in_dim, out_dim), factor, device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x):
        return x @ self.w + self.b


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
        if spec.use_bf16:
            raise NotImplementedError(
                "MLPNetSpec.use_bf16: the bf16 conditioner is not ported "
                "yet (ROADMAP queue A item 6)")
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
        inp = torch.cat([v, x, t], dim=-1)
        hh = torch.relu(inp @ self.in_w + self.in_b)
        hh = torch.relu(self.h_layer(hh))
        heads = hh @ self.head_w + self.head_b
        s_raw, translation, q_raw = torch.chunk(heads, 3, dim=-1)
        scale = torch.tanh(s_raw) * torch.exp(self.coeff_scale)
        if self.spec.bounded_q:
            q_raw = torch.tanh(q_raw)
        transformation = q_raw * torch.exp(self.coeff_transformation)
        return scale, translation, transformation


def make_mlp_net(spec: MLPNetSpec, generator=None, device=None) -> MLPNet:
    """Build the MLP conditioner module (random init from ``generator``)."""
    return MLPNet(spec, generator, device)
