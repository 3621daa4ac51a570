"""Training losses of the learned samplers (port of
``l2hmc_tpu/train/losses.py``).

- the expected-squared-jump loss with its reciprocal and auxiliary z terms,
- the topological-charge loss on the differentiable Fourier surrogate,
- the link-space metric zoo,
- the standalone loss registry (``get_loss``) of the VAE path.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

MetricFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

LOSS_EPS = 1e-3  # additive stabilizer of the per-chain jump terms


def get_metric_fn(metric: str) -> MetricFn:
    """Elementwise distance between configurations."""
    if metric == "l1":
        return lambda x1, x2: torch.abs(x1 - x2)
    if metric == "l2":
        return lambda x1, x2: torch.square(x1 - x2)
    if metric == "cos":
        return lambda x1, x2: torch.abs(torch.cos(x1) - torch.cos(x2))
    if metric == "cos2":
        return lambda x1, x2: torch.square(torch.cos(x1) - torch.cos(x2))
    if metric == "cos_diff":
        return lambda x1, x2: 1.0 - torch.cos(x1 - x2)
    raise ValueError(f"metric={metric!r}; expected l1|l2|cos|cos2|cos_diff")


def esjd_loss(x, x_proposed, accept_prob, z, z_proposed, z_accept_prob,
              metric_fn: MetricFn, loss_scale: float = 0.1,
              aux_weight: float = 1.0, std_weight: float = 1.0,
              space_sum=None):
    """Expected-squared-jump loss with reciprocal term and auxiliary chains::

        dx = sum_i metric(x, x')_i * px + 1e-3              (per chain)
        dz = aux_weight * (sum_i metric(z, z')_i * pz + 1e-3)
        loss = mean(ls * (1/dx + 1/dz) - (dx + dz) / ls) * std_weight

    ``space_sum`` (a lattice sharding's, ``parallel/spatial.py``) adds the
    per-chain sums of this rank's slab over 'space'.
    """
    def jump(a, b):
        s = torch.sum(metric_fn(a, b), dim=-1)
        return s if space_sum is None else space_sum(s)

    dx = jump(x, x_proposed) * accept_prob + LOSS_EPS
    dz = aux_weight * (jump(z, z_proposed) * z_accept_prob + LOSS_EPS)
    ls = loss_scale
    per_chain = ls * (1.0 / dx + 1.0 / dz) - (dx + dz) / ls
    return std_weight * torch.mean(per_chain)


def charge_loss(dq_x, accept_prob, dq_z, z_accept_prob,
                charge_weight: float = 1.0, aux_weight: float = 1.0,
                reward: bool = False):
    """Topological-charge term on ``dq = |Q(x) - Q(x')|`` (surrogate charges):
    ``+charge_weight * mean(px dq + 1e-3 + aux (pz dq_z + 1e-3))``, or its
    negative with ``reward=True`` (rewards accepted charge movement)."""
    xq = accept_prob * dq_x + LOSS_EPS
    zq = aux_weight * (z_accept_prob * dq_z + LOSS_EPS)
    sign = -1.0 if reward else 1.0
    return sign * charge_weight * torch.mean(xq + zq)


# ---------------------------------------------------------------------------
# Standalone loss registry (the VAE path's)
# ---------------------------------------------------------------------------


def loss_vec(x, x_proposed, accept_prob, r=1.0):
    """Per-chain squared jump times acceptance, plus 1e-4."""
    return (torch.sum(torch.square(x - x_proposed), dim=-1) * accept_prob
            + 1e-4)


def loss_std(x, x_proposed, accept_prob, scale=1.0):
    v = loss_vec(x, x_proposed, accept_prob)
    return torch.mean(scale / v - v / scale)


def loss_inverse(x, x_proposed, accept_prob, scale=1.0):
    v = loss_vec(x, x_proposed, accept_prob)
    return torch.mean(scale / v)


def loss_logsumexp(x, x_proposed, accept_prob, scale=1.0):
    v = loss_vec(x, x_proposed, accept_prob)
    return torch.logsumexp((math.log(scale) - torch.log(v)).reshape(-1), 0)


def loss_mixed(x, x_proposed, accept_prob, scale=1.0):
    v = loss_vec(x, x_proposed, accept_prob)
    return torch.mean(scale / v) - torch.mean(v / scale)


LOSS_REGISTRY: Dict[str, Callable] = {
    "standard": loss_std,
    "inverse": loss_inverse,
    "logsumexp": loss_logsumexp,
    "mixed": loss_mixed,
}


def get_loss(name: str) -> Callable:
    """The registry's loss of that name."""
    try:
        return LOSS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"loss={name!r}; expected one of {sorted(LOSS_REGISTRY)}")
