"""Trained weights carried across from the JAX package.

A JAX ``DynamicsParams`` pytree flattens (``jax.tree_util.tree_flatten``)
to ``[xnet leaves..., vnet leaves..., raw_eps, masks]``, each net dict with
its keys in sorted order at every level (:func:`net_leaf_order`;
:data:`NET_LEAF_ORDER` for the MLP family).  The shipped
``benchmarks/champion_16x16.npz`` stores those leaves as ``arr_0..arr_17``
beside a ``config`` JSON string.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from l2hmc_tpu_torch.dynamics.l2hmc import DynamicsParams
from l2hmc_tpu_torch.train.gauge import (
    GaugeConfig,
    build_networks,
    config_from_dict,
)

# sorted-key flatten order of one make_mlp_net parameter dict
NET_LEAF_ORDER = ("coeff_scale", "coeff_transformation", "h_layer.b",
                  "h_layer.w", "head_b", "head_w", "in_b", "in_w")

CHAMPION_PATH = (Path(__file__).resolve().parents[2] / "benchmarks"
                 / "champion_16x16.npz")


def _net_arrays(net) -> dict:
    """``{'in_w': ..., 'h_layer.w': ...}`` from a nested dict of arrays."""
    out = {}
    for k, v in net.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def net_leaf_order(cfg: GaugeConfig) -> tuple:
    """Dotted parameter names of one net of ``cfg.network_arch`` in the JAX
    flatten order (dict keys sorted at every level)."""
    xnet, _ = build_networks(cfg, torch.Generator().manual_seed(0))
    return tuple(sorted(xnet.state_dict(), key=lambda k: k.split(".")))


def _nest(flat: dict) -> dict:
    """``{'a.b': v}`` -> ``{'a': {'b': v}}``."""
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_numpy(tree, cfg: GaugeConfig, device=None) -> DynamicsParams:
    """Port params from a reference ``DynamicsParams`` with numpy leaves
    (fields ``xnet``, ``vnet`` — dicts as in ``make_mlp_net`` or
    ``make_local_flat_net`` —, ``raw_eps`` and ``masks``)."""
    # the modules' initial values are overwritten; a private generator keeps
    # their construction off the global RNG
    xnet, vnet = build_networks(cfg, torch.Generator().manual_seed(0))
    for net, arrays in ((xnet, tree.xnet), (vnet, tree.vnet)):
        state = {k: torch.tensor(np.asarray(v, np.float32))
                 for k, v in _net_arrays(arrays).items()}
        net.load_state_dict(state, strict=True)
    params = DynamicsParams(
        xnet, vnet, torch.tensor(np.asarray(tree.raw_eps, np.float32)),
        torch.tensor(np.asarray(tree.masks, np.float32)))
    return params.to(device) if device is not None else params


def params_from_leaves(leaves, cfg: GaugeConfig, device=None):
    """Port params from the flat leaf list (the npz ``arr_i`` order) of a
    ``cfg.network_arch`` pytree."""
    order = net_leaf_order(cfg)
    n = len(order)
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"expected {2 * n + 2} leaves, got {len(leaves)}")
    tree = SimpleNamespace(xnet=_nest(dict(zip(order, leaves[:n]))),
                           vnet=_nest(dict(zip(order, leaves[n:2 * n]))),
                           raw_eps=leaves[2 * n], masks=leaves[2 * n + 1])
    return params_from_numpy(tree, cfg, device)


def load_champion(path=CHAMPION_PATH, device=None):
    """``(GaugeConfig, DynamicsParams)`` from the shipped champion npz."""
    with np.load(path, allow_pickle=False) as z:
        cfg = config_from_dict(json.loads(str(z["config"])))
        n = 2 * len(net_leaf_order(cfg)) + 2
        leaves = [z[f"arr_{i}"] for i in range(n)]
    return cfg, params_from_leaves(leaves, cfg, device)
