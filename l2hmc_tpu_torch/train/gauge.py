"""U(1) gauge L2HMC: config, builders and the sampling chunk.

Port of the sampling side of ``l2hmc_tpu/train/gauge.py``: :class:`GaugeConfig`
(every field, so a reference config JSON loads unchanged), the network and
dynamics builders for ``network_arch`` in ``('mlp', 'local_flat')``,
``group='u1'``, ``action='wilson'``, and :func:`make_eval_chunk`.  The
optimizer, loss and train step are not ported yet (ROADMAP queue A item 4).
"""

from __future__ import annotations

import dataclasses

import torch

from l2hmc_tpu_torch.dynamics.l2hmc import (
    DynamicsConfig,
    DynamicsParams,
    make_dynamics,
    make_masks,
)
from l2hmc_tpu_torch.lattice import u1
from l2hmc_tpu_torch.networks.nets import (
    LocalNetSpec,
    MLPNetSpec,
    make_local_flat_net,
    make_mlp_net,
)


@dataclasses.dataclass(frozen=True)
class GaugeConfig:
    """Static configuration; the same fields and defaults as the reference
    (see ``l2hmc_tpu/train/gauge.py`` for each field's meaning)."""

    time_size: int = 8
    space_size: int = 8
    num_chains: int = 128
    num_steps: int = 3
    eps_init: float = 0.35
    eps_cap: float = 0.0
    eps_trainable: bool = True
    hmc: bool = False
    network_arch: str = "conv"
    num_hidden: int = 0
    num_filters: int = 8
    local_kernel: int = 3
    local_layers: int = 2
    use_bf16: bool = False
    bounded_q: bool = True
    group: str = "u1"
    metric: str = "cos_diff"
    loss_scale: float = 0.1
    std_weight: float = 1.0
    aux_weight: float = 1.0
    charge_weight: float = 1.0
    charge_reward: bool = False
    ref_z_term: bool = False
    lr_init: float = 1e-3
    lr_decay_steps: int = 1000
    lr_decay_rate: float = 0.96
    lr_warmup_steps: int = 200
    lr_width_ref: int = 512
    clip_value: float = 1.0
    train_steps: int = 5000
    beta_init: float = 2.0
    beta_final: float = 4.0
    both_directions: bool = False
    merge_v_halves: bool = False
    action: str = "wilson"
    rect_c1: float = -1.0 / 12.0
    eps_warmup_steps: int = 0
    eps_target_accept: float = 0.7
    train_hops: bool = False
    grad_summaries: bool = False

    @property
    def shape(self) -> u1.LatticeShape:
        return u1.LatticeShape(self.time_size, self.space_size)

    @property
    def x_dim(self) -> int:
        return self.shape.x_dim

    @property
    def hidden(self) -> int:
        return self.num_hidden if self.num_hidden > 0 else 2 * self.x_dim


def config_from_dict(d: dict) -> GaugeConfig:
    """GaugeConfig from a reference config dict (unknown keys ignored)."""
    known = {f.name for f in dataclasses.fields(GaugeConfig)}
    return GaugeConfig(**{k: v for k, v in d.items() if k in known})


def build_networks(cfg: GaugeConfig, generator=None, device=None):
    """XNet (position, factor=2) and VNet (momentum, factor=1) modules."""
    if cfg.network_arch not in ("mlp", "local_flat"):
        raise NotImplementedError(
            f"network_arch={cfg.network_arch!r} is not ported yet (ROADMAP "
            "queue A item 6: conv, local, zero)")
    if cfg.group != "u1":
        raise NotImplementedError(
            f"group={cfg.group!r} is not ported yet (ROADMAP queue A item 3)")
    if cfg.network_arch == "local_flat":
        # periodic (cos, sin) position features: 4 channels in the
        # position slot (XNet x slot, VNet v slot)
        spec = dict(channels=cfg.num_filters, kernel_size=cfg.local_kernel,
                    num_layers=cfg.local_layers, use_bf16=cfg.use_bf16,
                    bounded_q=cfg.bounded_q)
        xnet = make_local_flat_net(LocalNetSpec(
            cfg.time_size, cfg.space_size, factor=2.0, x_channels=4, **spec),
            generator, device)
        vnet = make_local_flat_net(LocalNetSpec(
            cfg.time_size, cfg.space_size, factor=1.0, v_channels=4, **spec),
            generator, device)
        return xnet, vnet
    pos_dim = 2 * cfg.x_dim
    xnet = make_mlp_net(MLPNetSpec(cfg.x_dim, cfg.hidden, factor=2.0,
                                   use_bf16=cfg.use_bf16,
                                   bounded_q=cfg.bounded_q,
                                   x_in_dim=pos_dim), generator, device)
    vnet = make_mlp_net(MLPNetSpec(cfg.x_dim, cfg.hidden, factor=1.0,
                                   use_bf16=cfg.use_bf16,
                                   bounded_q=cfg.bounded_q,
                                   v_in_dim=pos_dim), generator, device)
    return xnet, vnet


def build_dynamics(cfg: GaugeConfig):
    """``(DynamicsConfig, dynamics dict)`` for the Wilson-action target."""
    if cfg.action != "wilson":
        raise NotImplementedError(
            f"action={cfg.action!r} is not ported yet (ROADMAP queue A "
            "item 7, rect_sums/improved_action)")
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn

    dyn_cfg = DynamicsConfig(
        x_dim=cfg.x_dim, num_steps=cfg.num_steps,
        eps_trainable=cfg.eps_trainable, hmc=cfg.hmc,
        both_directions=cfg.both_directions, group=cfg.group,
        eps_cap=cfg.eps_cap, merge_v_halves=cfg.merge_v_halves)
    return dyn_cfg, make_dynamics(dyn_cfg, make_potential_fn(cfg.shape))


def init_params(cfg: GaugeConfig, generator=None,
                device=None) -> DynamicsParams:
    """Freshly initialised ``DynamicsParams`` (nets, eps_init, masks)."""
    xnet, vnet = build_networks(cfg, generator, device)
    masks = make_masks(generator, cfg.num_steps, cfg.x_dim).to(device)
    return DynamicsParams(xnet, vnet,
                          torch.tensor(cfg.eps_init, device=device), masks)


def make_eval_chunk(cfg: GaugeConfig, chunk_size: int):
    """Sampling-only chunk: ``chunk(params, x, beta, generator) -> (x,
    metrics)`` with ``metrics`` a dict of ``(chunk_size, B)`` tensors:
    accept_prob, actions, plaqs, charges and the 2x2 Wilson loop."""
    _, dyn = build_dynamics(cfg)
    shape = cfg.shape

    @torch.no_grad()
    def chunk(params: DynamicsParams, x: torch.Tensor, beta, generator):
        keys = ("accept_prob", "actions", "plaqs", "charges", "wloop22")
        out = {k: [] for k in keys}
        for _ in range(chunk_size):
            tr = dyn["transition"](params, x, beta, generator)
            x = u1.wrap(tr.x_out)
            obs = u1.observables(x, shape)
            out["accept_prob"].append(tr.accept_prob)
            for k in ("actions", "plaqs", "charges"):
                out[k].append(obs[k])
            out["wloop22"].append(u1.wilson_loop(u1.to_links(x, shape), 2, 2))
        return x, {k: torch.stack(v) for k, v in out.items()}

    return chunk
