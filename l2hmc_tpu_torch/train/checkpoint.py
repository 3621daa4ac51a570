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

from l2hmc_tpu_torch._device import resolve_device
from l2hmc_tpu_torch.dynamics.l2hmc import DynamicsParams
from l2hmc_tpu_torch.dynamics.nuts import DualAveragingState
from l2hmc_tpu_torch.train.gauge import (
    GaugeConfig,
    OptState,
    TrainState,
    build_networks,
    config_from_dict,
    make_optimizer,
    named_leaves,
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
    ``make_local_flat_net`` —, ``raw_eps`` and ``masks``), on ``device``
    (``None``: the first CUDA device)."""
    device = resolve_device(device)
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
    return params.to(device)


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
    """``(GaugeConfig, DynamicsParams)`` from the shipped champion npz, on
    ``device`` (``None``: the first CUDA device)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        cfg = config_from_dict(json.loads(str(z["config"])))
        n = 2 * len(net_leaf_order(cfg)) + 2
        leaves = [z[f"arr_{i}"] for i in range(n)]
    return cfg, params_from_leaves(leaves, cfg, device)


def _find_adam(opt_state):
    """The ``ScaleByAdamState`` (fields ``count``, ``mu``, ``nu``) inside a
    reference optax state (chains and ``MaskedState`` are tuples)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for item in opt_state:
            found = _find_adam(item)
            if found is not None:
                return found
    return None


def _leaf_at(tree, name: str):
    """The leaf of a reference params-shaped tree at ``xnet/h_layer/w``."""
    head, *rest = name.split("/")
    node = getattr(tree, head)
    for part in rest:
        node = node[part]
    return node


def train_state_from_numpy(tree, cfg: GaugeConfig, device=None) -> TrainState:
    """Port ``TrainState`` from a reference ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``), on ``device`` (``None``: the first
    CUDA device): params, Adam's ``mu``/``nu`` of the optimized tensors and
    optax's count, the chain state, the step and the dual-averaging state.
    """
    device = resolve_device(device)
    params = params_from_numpy(tree.params, cfg, device)
    adam = _find_adam(tree.opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam state (mu, nu)")
    init = make_optimizer(cfg).init(named_leaves(params))

    def moments(field):
        return {k: torch.tensor(np.asarray(_leaf_at(getattr(adam, field), k),
                                           np.float32), device=device)
                for k in init.mu}

    opt_state = OptState(count=int(adam.count), mu=moments("mu"),
                         nu=moments("nu"))
    da = DualAveragingState(*[torch.tensor(np.asarray(a, np.float32),
                                           device=device) for a in tree.da])
    return TrainState(params=params, opt_state=opt_state,
                      x=torch.tensor(np.asarray(tree.x, np.float32),
                                     device=device),
                      step=int(tree.step), da=da)
