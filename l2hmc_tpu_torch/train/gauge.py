"""U(1) gauge L2HMC trainer (port of ``l2hmc_tpu/train/gauge.py``).

:class:`GaugeConfig` (every field, so a reference config JSON loads
unchanged), the network and dynamics builders for ``network_arch`` in
``('mlp', 'local_flat')``, ``group='u1'``, ``action='wilson'``; the trainer:
:class:`TrainState`, the optimizer (optax's ``zero_nans`` ->
``clip_by_global_norm`` -> ``adam`` written out), the ESJD + charge loss, the
train step with the eps dual-averaging warmup and the in-chain instanton hop,
:func:`make_train_chunk`, :func:`train_to_convergence`; and the sampling
chunk :func:`make_eval_chunk`.

PyTorch runs eagerly, so a chunk is a Python loop over steps; metrics stay
on the device until the chunk ends.  The train step updates
``state.params`` in place (the returned state holds the same module).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from l2hmc_tpu_torch._device import resolve_device
from l2hmc_tpu_torch.dynamics.l2hmc import (
    DynamicsConfig,
    DynamicsParams,
    get_eps,
    make_dynamics,
    make_masks,
)
from l2hmc_tpu_torch.dynamics.nuts import (
    DualAveragingState,
    dual_averaging_init,
    dual_averaging_update,
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


def build_dynamics(cfg: GaugeConfig, potential_fn=None):
    """``(DynamicsConfig, dynamics dict)`` for the Wilson-action target.

    ``potential_fn`` replaces the default ``ops.wilson.make_potential_fn``
    (kernels on CUDA states, plain version on CPU ones), e.g. by the plain
    version on the card to hold the kernels against it."""
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
    if potential_fn is None:
        potential_fn = make_potential_fn(cfg.shape)
    return dyn_cfg, make_dynamics(dyn_cfg, potential_fn)


def init_params(cfg: GaugeConfig, generator=None,
                device=None) -> DynamicsParams:
    """Freshly initialised ``DynamicsParams`` (nets, eps_init, masks) on
    ``device`` (``None``: the first CUDA device).  The draws are made on
    the generator's device and moved."""
    device = resolve_device(device)
    where = generator.device if generator is not None else device
    xnet, vnet = build_networks(cfg, generator, where)
    masks = make_masks(generator, cfg.num_steps, cfg.x_dim, where)
    return DynamicsParams(xnet, vnet, torch.tensor(cfg.eps_init),
                          masks).to(device)


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def named_leaves(params: DynamicsParams) -> Dict[str, torch.Tensor]:
    """Every tensor of ``params`` by its reference pytree path, in the
    reference's flatten order: ``xnet/...``, ``vnet/...`` (dict keys sorted
    at every level), ``raw_eps``, ``masks``.  The tensors are the module's
    own (an in-place update changes the module)."""
    out = {}
    for net_name in ("xnet", "vnet"):
        named = dict(getattr(params, net_name).named_parameters())
        for k in sorted(named, key=lambda k: k.split(".")):
            out[f"{net_name}/{k.replace('.', '/')}"] = named[k]
    out["raw_eps"] = params.raw_eps
    out["masks"] = params.masks
    return out


class OptState(NamedTuple):
    """Adam's moments of the trainable tensors (by name) and optax's count:
    the number of updates so far, at which the lr schedule is read."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Optimizer:
    """``optax.chain(zero_nans(), clip_by_global_norm(clip), adam(lr))`` on
    the named tensors that ``select(name)`` keeps (the reference's
    ``optax.masked`` leaves the rest out, global norm included), with ``lr``
    a schedule of the count and optax's Adam constants.

    ``init(params) -> state``; ``update(grads, state) -> (updates, state)``
    over the names in ``state``; the caller adds the updates to the
    parameters.  With a warmup, lr(0) = 0, so the first update is exactly
    zero.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr_schedule, clip_value: float, select):
        self.lr = lr_schedule
        self.clip_value = clip_value
        self.select = select

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        mu = {k: torch.zeros_like(v).detach() for k, v in params.items()
              if self.select(k)}
        return OptState(count=0, mu=mu,
                        nu={k: v.clone() for k, v in mu.items()})

    def update(self, grads: Dict[str, torch.Tensor], state: OptState):
        g = {k: torch.where(torch.isnan(grads[k]),
                            torch.zeros_like(grads[k]), grads[k])
             for k in state.mu}
        if self.clip_value > 0:
            norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
            keep = norm < self.clip_value
            g = {k: torch.where(keep, v, (v / norm) * self.clip_value)
                 for k, v in g.items()}
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        step_size = -self.lr(state.count)
        mu = {k: (1 - b1) * v + b1 * state.mu[k] for k, v in g.items()}
        nu = {k: (1 - b2) * v ** 2 + b2 * state.nu[k] for k, v in g.items()}
        updates = {k: step_size * ((mu[k] / bc1)
                                   / (torch.sqrt(nu[k] / bc2) + self.eps))
                   for k in g}
        return updates, OptState(count=count, mu=mu, nu=nu)


class TrainState(NamedTuple):
    """Everything that evolves during training."""

    params: DynamicsParams
    opt_state: OptState
    x: torch.Tensor              # (num_chains, x_dim) chain state
    step: int
    da: DualAveragingState       # eps warmup (used while step < warmup)


def _effective_lr(cfg: GaugeConfig) -> float:
    if cfg.network_arch in ("local", "local_flat"):
        # weight-shared heads: fan-in is volume-independent, no width scaling
        return cfg.lr_init
    return cfg.lr_init * min(1.0, cfg.lr_width_ref / max(cfg.hidden, 1))


def _lr_schedule(cfg: GaugeConfig):
    from l2hmc_tpu_torch.train.schedules import make_lr_schedule

    return make_lr_schedule(_effective_lr(cfg), cfg.lr_decay_steps,
                            cfg.lr_decay_rate, cfg.lr_warmup_steps)


def make_optimizer(cfg: GaugeConfig) -> Optimizer:
    """The optimizer of both nets, and of ``raw_eps`` when eps is trainable.
    The masks are fixed buffers (their gradient is nulled, so leaving them
    out changes neither the global norm nor any update)."""

    def select(name):
        return (name.startswith(("xnet/", "vnet/"))
                or (name == "raw_eps" and cfg.eps_trainable))

    return Optimizer(_lr_schedule(cfg), cfg.clip_value, select)


def init_train_state(cfg: GaugeConfig, generator=None,
                     device=None) -> TrainState:
    """Fresh params, optimizer state and hot-start chains on ``device``
    (``None``: the first CUDA device), drawn from ``generator``."""
    device = resolve_device(device)
    params = init_params(cfg, generator, device)
    opt_state = make_optimizer(cfg).init(named_leaves(params))
    x = u1.random_links(generator, cfg.num_chains, cfg.shape, device=device)
    return TrainState(params=params, opt_state=opt_state, x=x, step=0,
                      da=dual_averaging_init(cfg.eps_init, device))


class TrainDraws(NamedTuple):
    """The randomness of one train step: momenta ``v (B, x_dim)``,
    directions ``d (B,)`` in {+1, -1} and accept uniforms ``u (B,)`` of the
    x and z chains, the auxiliary start ``z ~ N(0, 1)``, and the instanton
    hop's ``nu (B,)`` and ``u_hop (B,)`` (``None`` without ``train_hops``)."""

    v_x: torch.Tensor
    d_x: torch.Tensor
    u_x: torch.Tensor
    z: torch.Tensor
    v_z: torch.Tensor
    d_z: torch.Tensor
    u_z: torch.Tensor
    nu: Optional[torch.Tensor] = None
    u_hop: Optional[torch.Tensor] = None


def draw_train_randomness(generator, b: int, x_dim: int, hop: bool,
                          device=None) -> TrainDraws:
    """:class:`TrainDraws` from ``generator`` (on ``device``)."""
    from l2hmc_tpu_torch.dynamics.topo import draw_hop

    kw = dict(generator=generator, device=device)

    def chain():
        v = torch.randn((b, x_dim), **kw)
        d = torch.where(torch.rand((b,), **kw) > 0.5, 1.0, -1.0)
        return v, d, torch.rand((b,), **kw)

    v_x, d_x, u_x = chain()
    z = torch.randn((b, x_dim), **kw)
    v_z, d_z, u_z = chain()
    nu, u_hop = draw_hop(generator, b, 1, device) if hop else (None, None)
    return TrainDraws(v_x, d_x, u_x, z, v_z, d_z, u_z, nu, u_hop)


def _metric_fn(cfg: GaugeConfig):
    from l2hmc_tpu_torch.train import losses

    if cfg.metric not in ("plaq_cos", "plaq_cos2"):
        return losses.get_metric_fn(cfg.metric)
    # observable-space ESJD: the jump in the plaquette field cos P
    shape, sq = cfg.shape, cfg.metric == "plaq_cos2"

    def metric_fn(x1, x2):
        d = (torch.cos(u1.plaq_sums(u1.to_links(x1, shape)))
             - torch.cos(u1.plaq_sums(u1.to_links(x2, shape))))
        d = torch.square(d) if sq else torch.abs(d)
        return d.reshape(*d.shape[:-2], -1)

    return metric_fn


def make_loss_fn(cfg: GaugeConfig, dyn):
    """``(loss_fn, loss_fn_with)``: ``loss_fn(params, x, beta, generator)``
    draws the step's randomness, ``loss_fn_with(params, x, beta, draws)``
    takes it as :class:`TrainDraws`.  Both return ``(loss, aux)`` with
    ``aux`` = ``x_out``, mean ``accept_prob`` and mean exact ``dq``.

    ``cfg.ref_z_term`` computes the z terms against the x chain's proposal
    (the reference model's literal dataflow); by default against z's own.
    """
    from l2hmc_tpu_torch.train import losses

    shape = cfg.shape
    metric_fn = _metric_fn(cfg)

    def loss_fn_with(params, x, beta, draws: TrainDraws):
        out_x = dyn["transition_with"](params, x, beta, draws.v_x, draws.d_x,
                                       draws.u_x)
        z = draws.z
        out_z = dyn["transition_with"](params, z, beta, draws.v_z, draws.d_z,
                                       draws.u_z)
        z_prop = out_x.x_proposed if cfg.ref_z_term else out_z.x_proposed
        loss = losses.esjd_loss(
            x, out_x.x_proposed, out_x.accept_prob,
            z, z_prop, out_z.accept_prob,
            metric_fn=metric_fn, loss_scale=cfg.loss_scale,
            aux_weight=cfg.aux_weight, std_weight=cfg.std_weight)
        if cfg.charge_weight > 0:
            dq_x = u1.charge_diff_approx(x, out_x.x_proposed, shape)
            dq_z = u1.charge_diff_approx(z, z_prop, shape)
            loss = loss + losses.charge_loss(
                dq_x, out_x.accept_prob, dq_z, out_z.accept_prob,
                charge_weight=cfg.charge_weight, aux_weight=cfg.aux_weight,
                reward=cfg.charge_reward)
        x_out = out_x.x_out.detach()
        aux = {"x_out": x_out,
               "accept_prob": torch.mean(out_x.accept_prob.detach()),
               "dq": torch.mean(u1.charge_diff(x, x_out, shape))}
        return loss, aux

    def loss_fn(params, x, beta, generator):
        draws = draw_train_randomness(generator, x.shape[0], x.shape[1],
                                      False, x.device)
        return loss_fn_with(params, x, beta, draws)

    return loss_fn, loss_fn_with


def tree_summaries(tree: Dict[str, torch.Tensor], prefix: str):
    """Per-tensor mean/stddev/min/max/l2 under ``{prefix}/{name}/...`` (the
    reference's keys), as 0-d device tensors."""
    out = {}
    for name, leaf in tree.items():
        leaf = leaf.detach()
        key = f"{prefix}/{name}"
        out[f"{key}/mean"] = torch.mean(leaf)
        out[f"{key}/stddev"] = torch.std(leaf, correction=0)
        out[f"{key}/min"] = torch.min(leaf)
        out[f"{key}/max"] = torch.max(leaf)
        out[f"{key}/l2"] = torch.sqrt(torch.sum(torch.square(leaf)))
    return out


def make_train_step(cfg: GaugeConfig, potential_fn=None):
    """``(train_step, train_step_with)``:
    ``train_step(state, generator) -> (state, metrics)`` draws the step's
    randomness on the state's device; ``train_step_with(state, draws)``
    takes it as :class:`TrainDraws`.

    One step: beta from the schedule, loss and gradients through both
    chains' trajectories (the force is differentiated, so the Wilson
    action's double backward runs), the masks' gradient nulled (and
    ``raw_eps``'s when eps is fixed, or during the eps warmup), the
    optimizer update applied in place, the eps dual-averaging warmup and its
    handoff, the chain's wrap and, with ``train_hops``, one instanton hop.
    """
    from l2hmc_tpu_torch.dynamics.topo import instanton_hop_with
    from l2hmc_tpu_torch.train.schedules import beta_schedule

    dyn_cfg, dyn = build_dynamics(cfg, potential_fn)
    _, loss_fn_with = make_loss_fn(cfg, dyn)
    opt = make_optimizer(cfg)
    lr_sched = _lr_schedule(cfg)
    shape = cfg.shape
    warmup = cfg.eps_warmup_steps

    def train_step_with(state: TrainState, draws: TrainDraws):
        step = state.step
        beta = beta_schedule(step, cfg.train_steps, cfg.beta_init,
                             cfg.beta_final)
        params = state.params
        leaves = named_leaves(params)
        loss, aux = loss_fn_with(params, state.x, beta, draws)
        wrt = [k for k, v in leaves.items() if v.requires_grad]
        got = torch.autograd.grad(loss, [leaves[k] for k in wrt],
                                  allow_unused=True)
        grads = {k: torch.zeros_like(v).detach() for k, v in leaves.items()}
        grads.update({k: g for k, g in zip(wrt, got) if g is not None})
        in_warmup = step < warmup
        if not cfg.eps_trainable or in_warmup:
            # fixed eps, or dual averaging drives it: keep the ESJD eps
            # gradient out of Adam's moments
            grads["raw_eps"] = torch.zeros_like(grads["raw_eps"])
        updates, opt_state = opt.update(grads, state.opt_state)
        da = state.da
        with torch.no_grad():
            for k, u in updates.items():
                leaves[k].add_(u)
            if in_warmup:
                da = dual_averaging_update(state.da, aux["accept_prob"],
                                           target=cfg.eps_target_accept)
                # exploration value while adapting; the smoothed average
                # from the last warmup step on (the handoff value)
                log_eps = (da.log_eps_avg if step == warmup - 1
                           else da.log_eps)
                params.raw_eps.copy_(torch.exp(log_eps))

            x_new = u1.wrap(aux["x_out"])
            if cfg.train_hops:
                x_new = instanton_hop_with(x_new, beta, draws.nu,
                                           draws.u_hop, shape).x_out
            obs = u1.observables(x_new, shape)
            metrics = {
                "loss": loss.detach(),
                "accept_prob": aux["accept_prob"],
                "dq": aux["dq"],
                "eps": get_eps(params, dyn_cfg).detach().clone(),
                "beta": beta,
                "lr": lr_sched(step),
                "actions": torch.mean(obs["actions"]),
                "plaqs": torch.mean(obs["plaqs"]),
                "charges2": torch.mean(torch.square(obs["charges"])),
            }
            if cfg.grad_summaries:
                metrics.update(tree_summaries(grads, "grads"))
                metrics.update(tree_summaries(leaves, "params"))
                metrics["grads/global_norm"] = torch.sqrt(
                    sum(torch.sum(g * g) for g in grads.values()))
        return TrainState(params=params, opt_state=opt_state, x=x_new,
                          step=step + 1, da=da), metrics

    def train_step(state: TrainState, generator):
        x = state.x
        draws = draw_train_randomness(generator, x.shape[0], x.shape[1],
                                      cfg.train_hops, x.device)
        return train_step_with(state, draws)

    return train_step, train_step_with


def _stack_metrics(per_step, device) -> Dict[str, torch.Tensor]:
    """``{key: (steps,) tensor on device}`` from a list of step metrics
    (0-d device tensors, or Python floats copied over once per key)."""
    out = {}
    for k, first in per_step[0].items():
        vals = [m[k] for m in per_step]
        out[k] = (torch.tensor(vals, dtype=torch.float32, device=device)
                  if isinstance(first, float) else torch.stack(vals))
    return out


def make_train_chunk(cfg: GaugeConfig, chunk_size: int, potential_fn=None):
    """``chunk(state, generator) -> (state, metrics)``: ``chunk_size`` train
    steps, metrics stacked to ``(chunk_size,)`` tensors on the state's
    device."""
    train_step, _ = make_train_step(cfg, potential_fn)

    def chunk(state: TrainState, generator):
        per_step = []
        for _ in range(chunk_size):
            state, m = train_step(state, generator)
            per_step.append(m)
        return state, _stack_metrics(per_step, state.x.device)

    return chunk


def train_to_convergence(cfg: GaugeConfig, seed: int = 0, *,
                         chunk_size: int = 250, retrain_acc: float = 0.0,
                         max_retrains: int = 3, trace=None, device=None):
    """Train the sampler; detect-and-retrain on the beta >= 5 bimodality.

    ``retrain_acc`` > 0 arms the detector: when the mean acceptance over
    the tail (50 steps) of the final chunk falls below it, training restarts
    from a fresh seed, up to ``max_retrains`` extra attempts.  Attempt ``a``
    draws from a generator on ``device`` (``None``: the first CUDA device)
    seeded with ``seed`` (``a = 0``) or ``seed + 7700 + a``.

    Returns ``(state, last_metrics, attempts)``; ``trace`` is an optional
    ``fn(msg)`` progress callback.
    """
    device = resolve_device(device)
    chunk_size = min(chunk_size, max(cfg.train_steps, 1))
    chunk = make_train_chunk(cfg, chunk_size)
    attempts = []
    state = m = None
    for attempt in range(max_retrains + 1):
        gen = torch.Generator(device=device).manual_seed(
            seed if attempt == 0 else seed + 7700 + attempt)
        state = init_train_state(cfg, gen, device)
        for _ in range(max(cfg.train_steps // chunk_size, 1)):
            state, m = chunk(state, gen)
        end_acc = float(m["accept_prob"][-min(50, chunk_size):].mean())
        attempts.append({"attempt": attempt,
                         "end_accept": round(end_acc, 4)})
        converged = retrain_acc <= 0 or end_acc >= retrain_acc
        if trace is not None:
            trace(f"training attempt {attempt}: end acc {end_acc:.3f}"
                  + ("" if converged else
                     f" < {retrain_acc} — retraining"))
        if converged:
            break
    return state, m, attempts
