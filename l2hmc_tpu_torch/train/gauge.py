"""U(1) gauge L2HMC trainer (port of ``l2hmc_tpu/train/gauge.py``).

:class:`GaugeConfig` (every field, so a reference config JSON loads
unchanged), the network and dynamics builders (every ``network_arch``,
``group`` and ``action``); the trainer:
:class:`TrainState`, the optimizer (optax's ``zero_nans`` ->
``clip_by_global_norm`` -> ``adam`` written out), the ESJD + charge loss, the
train step with the eps dual-averaging warmup and the in-chain instanton hop,
:func:`make_train_chunk`, :func:`train_to_convergence`; and the sampling
chunk :func:`make_eval_chunk`.

PyTorch runs eagerly, so a chunk is a Python loop over steps; metrics stay
on the device until the chunk ends.  The train step updates
``state.params`` in place (the returned state holds the same module).

Data parallelism (the reference's ``parallel.mesh`` shardings): every
builder takes a ``mesh`` (``parallel/mesh.py``).  With one, the state's
chains are this rank's slice of the batch (``shard_train_state``), every
rank draws the GLOBAL randomness from one identically seeded generator and
keeps its rows, the gradients are all-reduced as a mean over 'data' before
the optimizer clips them, and every reported mean is the global one; an
n-rank step then reproduces the one-process step to all-reduce rounding.

dp x sp (the reference's ``lattice_sharding``): the builders also take a
``sharding`` (``parallel.mesh.lattice_sharding(mesh, shape)``).  The state's
chains are then this rank's columns too (the slab of time rows), the
draws' per-link tensors are sliced to them, the dynamics, potential, loss,
hop and observables compute on the slab and add their per-chain sums over
'space' (``parallel/spatial.py``), and every parameter's gradient comes
out whole on every 'space' rank, so the optimizer (its global-norm clip
included) sees what the one-process step sees.
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
    ConvNetSpec,
    LocalNetSpec,
    MLPNetSpec,
    make_conv_net,
    make_local_flat_net,
    make_local_net,
    make_mlp_net,
    make_zero_net,
)
from l2hmc_tpu_torch.utils import trace


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


def quickstart_config(**overrides) -> GaugeConfig:
    """The README quick-start training recipe (README.md, "The topological
    sampler"): 16x16, 128 chains, K=4, fixed eps 0.079, MLP h64,
    merge_v_halves, charge_reward, train_hops, beta 2 -> 5 over 12000
    steps; the rest at the defaults, ``overrides`` on top."""
    kw = dict(time_size=16, space_size=16, num_chains=128, num_steps=4,
              eps_init=0.079, eps_trainable=False, network_arch="mlp",
              num_hidden=64, merge_v_halves=True, charge_reward=True,
              train_hops=True, beta_init=2.0, beta_final=5.0,
              train_steps=12000)
    kw.update(overrides)
    return GaugeConfig(**kw)


def build_networks(cfg: GaugeConfig, generator=None, device=None):
    """XNet (position, factor=2) and VNet (momentum, factor=1) modules for
    ``cfg.network_arch``; the position slot holds periodic (cos, sin)
    features (4 channels, ``2 x_dim`` columns) for ``group='u1'``, the raw
    position (2 channels, ``x_dim``) for ``'r1'``."""
    periodic = cfg.group == "u1"
    pos_dim = 2 * cfg.x_dim if periodic else 0
    pos_ch = 4 if periodic else 2
    g, dev = generator, device
    arch = cfg.network_arch
    if arch == "zero":
        return make_zero_net(cfg.x_dim), make_zero_net(cfg.x_dim)
    if arch == "mlp":
        kw = dict(use_bf16=cfg.use_bf16, bounded_q=cfg.bounded_q)
        return (make_mlp_net(MLPNetSpec(cfg.x_dim, cfg.hidden, factor=2.0,
                                        x_in_dim=pos_dim, **kw), g, dev),
                make_mlp_net(MLPNetSpec(cfg.x_dim, cfg.hidden, factor=1.0,
                                        v_in_dim=pos_dim, **kw), g, dev))
    if arch == "conv":
        kw = dict(num_filters=cfg.num_filters, num_hidden=cfg.hidden,
                  use_bf16=cfg.use_bf16, bounded_q=cfg.bounded_q)
        return (make_conv_net(ConvNetSpec(
                    cfg.time_size, cfg.space_size, factor=2.0,
                    x_channels=pos_ch, **kw), g, dev),
                make_conv_net(ConvNetSpec(
                    cfg.time_size, cfg.space_size, factor=1.0,
                    v_channels=pos_ch, **kw), g, dev))
    if arch in ("local", "local_flat"):
        make = make_local_net if arch == "local" else make_local_flat_net
        kw = dict(channels=cfg.num_filters, kernel_size=cfg.local_kernel,
                  num_layers=cfg.local_layers, use_bf16=cfg.use_bf16,
                  bounded_q=cfg.bounded_q)
        return (make(LocalNetSpec(cfg.time_size, cfg.space_size, factor=2.0,
                                  x_channels=pos_ch, **kw), g, dev),
                make(LocalNetSpec(cfg.time_size, cfg.space_size, factor=1.0,
                                  v_channels=pos_ch, **kw), g, dev))
    raise ValueError(f"network_arch={arch!r}")


def build_dynamics(cfg: GaugeConfig, potential_fn=None, remat: bool = True,
                   sharding=None):
    """``(DynamicsConfig, dynamics dict)`` for the gauge action.

    ``action='wilson'``: ``ops.wilson.make_potential_fn`` (kernels on CUDA
    states, plain version on CPU ones); ``'improved'``: the Symanzik
    potential of ``lattice/u1.py``, differentiated by autograd.
    ``potential_fn`` replaces either, e.g. by the plain Wilson version on
    the card to hold the kernels against it.  ``remat`` (the reference's
    default, which its trainer never turns off) checkpoints each leapfrog
    step while autograd records.

    ``sharding`` (of ``cfg.shape``, else ``ValueError``): the slab dynamics on the
    slab route of the Wilson kernels (``make_slab_potential_fn``) or the
    improved action's slab form; a given ``potential_fn`` must then be a
    slab potential.  The conv nets need slabs of an even number of rows
    (``ValueError``)."""
    from l2hmc_tpu_torch.ops.wilson import (make_potential_fn,
                                            make_slab_potential_fn)

    if sharding is not None:
        sharding.check_shape(cfg.shape)
        if cfg.network_arch == "conv" and not cfg.hmc:
            sharding.check_stride(2)

    dyn_cfg = DynamicsConfig(
        x_dim=cfg.x_dim, num_steps=cfg.num_steps,
        eps_trainable=cfg.eps_trainable, hmc=cfg.hmc,
        both_directions=cfg.both_directions, group=cfg.group,
        eps_cap=cfg.eps_cap, merge_v_halves=cfg.merge_v_halves,
        remat=remat)
    if potential_fn is None:
        if cfg.action == "improved":
            potential_fn = u1.make_improved_potential_fn(
                cfg.shape, cfg.rect_c1, sharding)
        elif cfg.action == "wilson":
            potential_fn = (make_potential_fn(cfg.shape) if sharding is None
                            else make_slab_potential_fn(cfg.shape, sharding))
        else:
            raise ValueError(f"action={cfg.action!r}")
    return dyn_cfg, make_dynamics(dyn_cfg, potential_fn, sharding)


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


def draw_transition(generator, x: torch.Tensor, mesh=None, sharding=None):
    """One transition's ``(v, direction, u)`` for the chains ``x``, in the
    order of ``dyn["transition"]``'s draws; with a ``mesh``, drawn for the
    global batch and sliced to this rank's chains (with a ``sharding``, the
    momenta to this rank's columns too)."""
    from l2hmc_tpu_torch.parallel.mesh import mesh_of, shard_chains

    mesh = mesh_of(mesh, sharding)
    b = x.shape[0] * (mesh.size("data") if mesh is not None else 1)
    kw = dict(generator=generator, device=x.device)
    dims = x.shape[1:] if sharding is None else (sharding.shape.x_dim,)
    v = torch.randn((b, *dims), dtype=x.dtype, **kw)
    direction = torch.where(torch.rand((b,), **kw) > 0.5, 1.0,
                            -1.0).to(x.dtype)
    u = torch.rand((b,), **kw)
    v = shard_chains(v, mesh) if sharding is None else sharding.shard(v)
    return v, shard_chains(direction, mesh), shard_chains(u, mesh)


def gather_trace(trace: torch.Tensor, mesh=None) -> torch.Tensor:
    """A ``(T, B_local)`` trace gathered to ``(T, B)`` over 'data'."""
    if mesh is None:
        return trace
    from l2hmc_tpu_torch.parallel.mesh import gather_chains

    return gather_chains(trace.T.contiguous(), mesh).T.contiguous()


def make_eval_chunk(cfg: GaugeConfig, chunk_size: int, mesh=None,
                    sharding=None):
    """Sampling-only chunk: ``chunk(params, x, beta, generator) -> (x,
    metrics)`` with ``metrics`` a dict of ``(chunk_size, B)`` tensors:
    accept_prob, actions, plaqs, charges and the 2x2 Wilson loop.  With a
    ``mesh``, ``x`` is this rank's chains, the draws are the global ones
    sliced, and the metrics are gathered to the global batch; with a
    ``sharding``, ``x`` is this rank's slab too and every metric is the
    whole lattice's.

    Spans (``utils/trace.py``): ``eval.chunk`` around the call, one
    ``eval.transition`` per transition (draws, transition, wrap) and inside
    it ``eval.observables``; the transition's own spans are
    ``make_dynamics``'."""
    from l2hmc_tpu_torch.parallel.mesh import mesh_of

    mesh = mesh_of(mesh, sharding)
    _, dyn = build_dynamics(cfg, sharding=sharding)
    shape = cfg.shape

    @torch.no_grad()
    def chunk(params: DynamicsParams, x: torch.Tensor, beta, generator):
        keys = ("accept_prob", "actions", "plaqs", "charges", "wloop22")
        out = {k: [] for k in keys}
        with trace.span("eval.chunk"):
            for _ in range(chunk_size):
                with trace.span("eval.transition"):
                    tr = dyn["transition_with"](
                        params, x, beta,
                        *draw_transition(generator, x, mesh, sharding))
                    x = u1.wrap(tr.x_out)
                    with trace.span("eval.observables"):
                        obs = u1.observables(x, shape, sharding=sharding)
                        out["accept_prob"].append(tr.accept_prob)
                        for k in ("actions", "plaqs", "charges"):
                            out[k].append(obs[k])
                        out["wloop22"].append(u1.wilson_loop(
                            u1.state_links(x, shape, sharding), 2, 2,
                            sharding))
            return x, {k: gather_trace(torch.stack(v), mesh)
                       for k, v in out.items()}

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


def clone_train_state(state: TrainState) -> TrainState:
    """An independent copy of ``state`` (params, moments, chains, dual
    averaging), e.g. to run one state through two step functions."""
    import copy

    opt = state.opt_state
    return state._replace(
        params=copy.deepcopy(state.params),
        opt_state=opt._replace(mu={k: v.clone() for k, v in opt.mu.items()},
                               nu={k: v.clone() for k, v in opt.nu.items()}),
        x=state.x.clone(),
        da=DualAveragingState(*[t.clone() for t in state.da]))


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
                          device=None, mesh=None,
                          sharding=None) -> TrainDraws:
    """:class:`TrainDraws` from ``generator`` (on ``device``); with a
    ``mesh``, ``b`` is this rank's chains: the draws are made for the
    global batch and sliced to this rank's rows.  With a ``sharding``,
    ``x_dim`` is ignored: the momenta and ``z`` are drawn over the whole
    lattice and sliced to this rank's columns too."""
    if sharding is not None:
        from l2hmc_tpu_torch.parallel.mesh import shard_chains

        full = draw_train_randomness(
            generator, b * sharding.mesh.size("data"),
            sharding.shape.x_dim, hop, device)
        return TrainDraws(*(
            None if t is None else sharding.shard(t) if t.dim() == 2
            else shard_chains(t, sharding.mesh) for t in full))
    if mesh is not None:
        from l2hmc_tpu_torch.parallel.mesh import shard_chains

        full = draw_train_randomness(generator, b * mesh.size("data"),
                                     x_dim, hop, device)
        return TrainDraws(*(None if t is None else shard_chains(t, mesh)
                            for t in full))
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


def _metric_fn(cfg: GaugeConfig, sharding=None):
    from l2hmc_tpu_torch.train import losses

    if cfg.metric not in ("plaq_cos", "plaq_cos2"):
        return losses.get_metric_fn(cfg.metric)
    # observable-space ESJD: the jump in the plaquette field cos P (the
    # slab's plaquettes when sharded)
    shape, sq = cfg.shape, cfg.metric == "plaq_cos2"

    def metric_fn(x1, x2):
        d = (torch.cos(u1.state_plaqs(x1, shape, sharding))
             - torch.cos(u1.state_plaqs(x2, shape, sharding)))
        d = torch.square(d) if sq else torch.abs(d)
        return d.reshape(*d.shape[:-2], -1)

    return metric_fn


def make_loss_fn(cfg: GaugeConfig, dyn, sharding=None):
    """``(loss_fn, loss_fn_with)``: ``loss_fn(params, x, beta, generator)``
    draws the step's randomness, ``loss_fn_with(params, x, beta, draws)``
    takes it as :class:`TrainDraws`.  Both return ``(loss, aux)`` with
    ``aux`` = ``x_out``, mean ``accept_prob`` and mean exact ``dq``.

    ``cfg.ref_z_term`` computes the z terms against the x chain's proposal
    (the reference model's literal dataflow); by default against z's own.
    With a ``sharding`` (``dyn`` built with it), the states are this
    rank's slabs and every per-chain sum is the whole lattice's.
    """
    from l2hmc_tpu_torch.train import losses

    shape = cfg.shape
    metric_fn = _metric_fn(cfg, sharding)
    space_sum = None if sharding is None else sharding.space_sum

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
            aux_weight=cfg.aux_weight, std_weight=cfg.std_weight,
            space_sum=space_sum)
        if cfg.charge_weight > 0:
            dq_x = u1.charge_diff_approx(x, out_x.x_proposed, shape,
                                         sharding=sharding)
            dq_z = u1.charge_diff_approx(z, z_prop, shape,
                                         sharding=sharding)
            loss = loss + losses.charge_loss(
                dq_x, out_x.accept_prob, dq_z, out_z.accept_prob,
                charge_weight=cfg.charge_weight, aux_weight=cfg.aux_weight,
                reward=cfg.charge_reward)
        x_out = out_x.x_out.detach()
        aux = {"x_out": x_out,
               "accept_prob": torch.mean(out_x.accept_prob.detach()),
               "dq": torch.mean(u1.charge_diff(x, x_out, shape, sharding))}
        return loss, aux

    def loss_fn(params, x, beta, generator):
        draws = draw_train_randomness(generator, x.shape[0], x.shape[1],
                                      False, x.device, sharding=sharding)
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


def make_grad_fn(cfg: GaugeConfig, dyn, mesh=None, sharding=None):
    """``grad_fn(params, x, beta, draws) -> (loss, aux, grads)``: the loss
    of :func:`make_loss_fn` (``dyn`` built with the same ``sharding``) and
    the gradient of every leaf of ``params`` by name (zeros where a leaf
    takes none), the mean over the mesh's 'data' axis in one collective.
    Under a ``sharding`` every gradient is whole on each 'space' rank
    (``parallel/spatial.py``)."""
    from l2hmc_tpu_torch.parallel.mesh import mesh_of

    mesh = mesh_of(mesh, sharding)
    _, loss_fn_with = make_loss_fn(cfg, dyn, sharding)

    def grad_fn(params, x, beta, draws: TrainDraws):
        leaves = named_leaves(params)
        loss, aux = loss_fn_with(params, x, beta, draws)
        wrt = [k for k, v in leaves.items() if v.requires_grad]
        got = torch.autograd.grad(loss, [leaves[k] for k in wrt],
                                  allow_unused=True)
        grads = {k: torch.zeros_like(v).detach() for k, v in leaves.items()}
        grads.update({k: g for k, g in zip(wrt, got) if g is not None})
        if mesh is None:
            return loss, aux, grads
        names = list(grads)
        flat = mesh.all_reduce(torch.cat([grads[k].reshape(-1)
                                          for k in names]), "data", "mean")
        out, at = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[at:at + n].reshape(grads[k].shape)
            at += n
        return loss, aux, out

    return grad_fn


def make_train_step(cfg: GaugeConfig, potential_fn=None, remat: bool = True,
                    mesh=None, sharding=None):
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
    ``remat=False`` keeps every leapfrog step's activations for the
    backward pass instead of recomputing them (``build_dynamics``).

    With a ``mesh`` (``parallel/mesh.py``), ``state.x`` is this rank's
    slice of the chains, ``train_step`` draws the global randomness and
    keeps its rows, and ``train_step_with`` takes this rank's rows; the
    loss is each rank's mean over its chains, the gradients are
    all-reduced as a mean over 'data' before ``zero_nans`` and the clip
    (JAX clips the global gradient), the eps warmup reads the global mean
    acceptance, and every metric is the global mean.

    With a ``sharding`` (``parallel.mesh.lattice_sharding(mesh, shape)``;
    its mesh is the step's), ``state.x`` and the draws' per-link tensors are also
    this rank's columns (``shard_train_state(state, mesh, sharding)``,
    ``draw_train_randomness(..., sharding=)``); every parameter's gradient
    is whole on every 'space' rank before the 'data' mean.
    """
    from l2hmc_tpu_torch.dynamics.topo import instanton_hop_with
    from l2hmc_tpu_torch.train.schedules import beta_schedule

    from l2hmc_tpu_torch.parallel.mesh import mesh_of

    mesh = mesh_of(mesh, sharding)
    dyn_cfg, dyn = build_dynamics(cfg, potential_fn, remat, sharding)
    grad_fn = make_grad_fn(cfg, dyn, mesh, sharding)
    opt = make_optimizer(cfg)
    lr_sched = _lr_schedule(cfg)
    shape = cfg.shape
    warmup = cfg.eps_warmup_steps

    def data_mean(t):
        return t if mesh is None else mesh.all_reduce(t, "data", "mean")

    def train_step_with(state: TrainState, draws: TrainDraws):
        step = state.step
        beta = beta_schedule(step, cfg.train_steps, cfg.beta_init,
                             cfg.beta_final)
        params = state.params
        leaves = named_leaves(params)
        loss, aux, grads = grad_fn(params, state.x, beta, draws)
        aux["accept_prob"] = data_mean(aux["accept_prob"])
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
                                           draws.u_hop, shape,
                                           sharding).x_out
            obs = u1.observables(x_new, shape, sharding=sharding)
            means = data_mean(torch.stack([
                loss.detach(), aux["dq"], torch.mean(obs["actions"]),
                torch.mean(obs["plaqs"]),
                torch.mean(torch.square(obs["charges"]))]))
            metrics = {
                "loss": means[0],
                "accept_prob": aux["accept_prob"],
                "dq": means[1],
                "eps": get_eps(params, dyn_cfg).detach().clone(),
                "beta": beta,
                "lr": lr_sched(step),
                "actions": means[2],
                "plaqs": means[3],
                "charges2": means[4],
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
                                      cfg.train_hops, x.device, mesh,
                                      sharding)
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


def make_train_chunk(cfg: GaugeConfig, chunk_size: int, potential_fn=None,
                     remat: bool = True, mesh=None, sharding=None):
    """``chunk(state, generator) -> (state, metrics)``: ``chunk_size`` train
    steps, metrics stacked to ``(chunk_size,)`` tensors on the state's
    device (with a ``mesh``: data-parallel steps, global metrics; with a
    ``sharding``: dp x sp steps)."""
    train_step, _ = make_train_step(cfg, potential_fn, remat, mesh,
                                    sharding)

    def chunk(state: TrainState, generator):
        per_step = []
        for _ in range(chunk_size):
            state, m = train_step(state, generator)
            per_step.append(m)
        return state, _stack_metrics(per_step, state.x.device)

    return chunk


def train_to_convergence(cfg: GaugeConfig, seed: int = 0, *,
                         chunk_size: int = 250, retrain_acc: float = 0.0,
                         max_retrains: int = 3, trace=None, device=None,
                         mesh=None):
    """Train the sampler; detect-and-retrain on the beta >= 5 bimodality.

    ``retrain_acc`` > 0 arms the detector: when the mean acceptance over
    the tail (50 steps) of the final chunk falls below it, training restarts
    from a fresh seed, up to ``max_retrains`` extra attempts.  Attempt ``a``
    draws from a generator on ``device`` (``None``: the first CUDA device)
    seeded with ``seed`` (``a = 0``) or ``seed + 7700 + a``.

    Returns ``(state, last_metrics, attempts)``; ``trace`` is an optional
    ``fn(msg)`` progress callback.  With a ``mesh`` every rank seeds the
    same generator, trains its slice of the chains data-parallel and judges
    the attempt on the global acceptance; the returned ``state.x`` is this
    rank's slice.
    """
    from l2hmc_tpu_torch.parallel.mesh import shard_train_state

    device = resolve_device(device)
    chunk_size = min(chunk_size, max(cfg.train_steps, 1))
    chunk = make_train_chunk(cfg, chunk_size, mesh=mesh)
    attempts = []
    state = m = None
    for attempt in range(max_retrains + 1):
        gen = torch.Generator(device=device).manual_seed(
            seed if attempt == 0 else seed + 7700 + attempt)
        state = shard_train_state(init_train_state(cfg, gen, device), mesh)
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
