"""L2HMC sampler trainer for analytic targets (port of
``l2hmc_tpu/train/sampler.py``).

The mixture and correlated-Gaussian experiment path: MLP S/T/Q networks,
``eps = exp(alpha)`` as a trainable log-step, the squared-jump loss with
auxiliary chains, and temperature annealing ``T -> T * factor`` with the
schedule adapted from measured tunneling rates (``schedules``).  The
temperature enters as ``U / T``: the dynamics run at ``beta = 1 / T``.

PyTorch runs eagerly, so a chunk is a Python loop over steps; the train
step updates ``state.params`` in place.  The draws of a step are those of
``train.gauge.draw_train_randomness`` (the x chain's momenta, directions
and accept uniforms, the auxiliary start ``z``, the z chain's), so a step
replays JAX's draws when they are given as :class:`TrainDraws`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

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
from l2hmc_tpu_torch.networks.nets import MLPNetSpec, make_mlp_net
from l2hmc_tpu_torch.train import losses, schedules
from l2hmc_tpu_torch.train.gauge import (
    OptState,
    Optimizer,
    TrainDraws,
    _stack_metrics,
    draw_train_randomness,
    named_leaves,
)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static config (the reference experiment's defaults)."""

    x_dim: int
    num_chains: int = 200
    num_steps: int = 10
    eps_init: float = 0.1
    num_hidden: int = 10
    hmc: bool = False
    metric: str = "l2"
    loss_scale: float = 0.1
    aux_weight: float = 1.0
    lr_init: float = 1e-3
    lr_decay_steps: int = 1000
    lr_decay_rate: float = 0.96
    clip_value: float = 1.0
    train_steps: int = 5000
    # temperature annealing
    use_annealing: bool = False
    temp_init: float = 10.0
    annealing_steps: int = 100
    annealing_factor: float = 0.98


class SamplerTrainState(NamedTuple):
    params: DynamicsParams
    opt_state: OptState
    x: torch.Tensor
    step: int
    temp: schedules.TemperatureSchedule


def build_sampler_dynamics(cfg: SamplerConfig, energy_fn):
    """``(DynamicsConfig, dynamics dict, make_nets)``: flat ('r1') dynamics
    with ``eps = exp(raw_eps)`` on ``energy_fn``, and
    ``make_nets(generator, device) -> (xnet, vnet)``, MLP conditioners with
    bounded Q heads (tanh), factors 2 and 1.

    Activations are kept for the backward instead of recomputed
    (``remat=False``): the two give the same numbers, and at these widths
    the memory is nothing while a recompute doubles the eager launches."""
    dyn_cfg = DynamicsConfig(x_dim=cfg.x_dim, num_steps=cfg.num_steps,
                             hmc=cfg.hmc, use_log_eps=True, remat=False)

    def make_nets(generator, device):
        return tuple(make_mlp_net(MLPNetSpec(cfg.x_dim, cfg.num_hidden,
                                             factor=f, bounded_q=True),
                                  generator, device)
                     for f in (2.0, 1.0))

    return dyn_cfg, make_dynamics(dyn_cfg, energy_fn), make_nets


def make_sampler_optimizer(cfg: SamplerConfig) -> Optimizer:
    """NaN gradients zeroed, the global norm clipped at ``clip_value`` (when
    positive), Adam on the exponential-decay schedule; the masks take no
    update."""
    return Optimizer(schedules.make_lr_schedule(
        cfg.lr_init, cfg.lr_decay_steps, cfg.lr_decay_rate),
        cfg.clip_value, lambda name: name != "masks")


def init_sampler_state(cfg: SamplerConfig, energy_fn, generator=None,
                       x_init=None, device=None) -> SamplerTrainState:
    """Fresh nets, ``log(eps_init)``, masks, optimizer state and
    ``x ~ N(0, 1)`` chains (or ``x_init``) on ``device`` (``None``: the
    first CUDA device), drawn from ``generator``."""
    device = resolve_device(device)
    where = generator.device if generator is not None else device
    _, _, make_nets = build_sampler_dynamics(cfg, energy_fn)
    xnet, vnet = make_nets(generator, where)
    masks = make_masks(generator, cfg.num_steps, cfg.x_dim, where)
    params = DynamicsParams(xnet, vnet, torch.tensor(np.log(cfg.eps_init)),
                            masks).to(device)
    x = (x_init if x_init is not None else torch.randn(
        (cfg.num_chains, cfg.x_dim), generator=generator, dtype=torch.float32,
        device=where).to(device))
    t0 = cfg.temp_init if cfg.use_annealing else 1.0
    return SamplerTrainState(
        params=params,
        opt_state=make_sampler_optimizer(cfg).init(named_leaves(params)),
        x=x, step=0,
        temp=schedules.init_temperature(t0, cfg.annealing_factor))


def make_sampler_train_step(cfg: SamplerConfig, energy_fn):
    """``(train_step, train_step_with)``: ``train_step(state, generator)``
    draws the step's randomness on the chains' device,
    ``train_step_with(state, draws)`` takes it as :class:`TrainDraws`.
    Both return ``(state, metrics)``: loss, mean acceptance, eps after the
    update and the step's temperature."""
    dyn_cfg, dyn, _ = build_sampler_dynamics(cfg, energy_fn)
    opt = make_sampler_optimizer(cfg)
    metric_fn = losses.get_metric_fn(cfg.metric)

    def train_step_with(state: SamplerTrainState, draws: TrainDraws):
        temperature = np.float32(state.temp.temperature)
        beta = float(np.float32(1) / temperature)
        params, x = state.params, state.x
        out_x = dyn["transition_with"](params, x, beta, draws.v_x, draws.d_x,
                                       draws.u_x)
        out_z = dyn["transition_with"](params, draws.z, beta, draws.v_z,
                                       draws.d_z, draws.u_z)
        loss = losses.esjd_loss(
            x, out_x.x_proposed, out_x.accept_prob,
            draws.z, out_z.x_proposed, out_z.accept_prob,
            metric_fn=metric_fn, loss_scale=cfg.loss_scale,
            aux_weight=cfg.aux_weight)
        leaves = named_leaves(params)
        wrt = [k for k in state.opt_state.mu]
        got = torch.autograd.grad(loss, [leaves[k] for k in wrt],
                                  allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(wrt, got)}
        updates, opt_state = opt.update(grads, state.opt_state)
        with torch.no_grad():
            for k, u in updates.items():
                leaves[k].add_(u)
        temp = (schedules.temperature_step(state.temp, cfg.annealing_steps)
                if cfg.use_annealing else state.temp)
        metrics = {
            "loss": loss.detach(),
            "accept_prob": torch.mean(out_x.accept_prob.detach()),
            "eps": get_eps(params, dyn_cfg).detach().clone(),
            "temperature": float(temperature),
        }
        return SamplerTrainState(params, opt_state, out_x.x_out.detach(),
                                 state.step + 1, temp), metrics

    def train_step(state: SamplerTrainState, generator):
        x = state.x
        return train_step_with(state, draw_train_randomness(
            generator, x.shape[0], x.shape[1], False, x.device))

    return train_step, train_step_with


def make_sampler_train_chunk(cfg: SamplerConfig, energy_fn, chunk_size: int):
    """``chunk(state, generator) -> (state, metrics)``: ``chunk_size`` train
    steps, metrics stacked to ``(chunk_size,)`` tensors on the chains'
    device."""
    train_step, _ = make_sampler_train_step(cfg, energy_fn)

    def chunk(state: SamplerTrainState, generator):
        per_step = []
        for _ in range(chunk_size):
            state, m = train_step(state, generator)
            per_step.append(m)
        return state, _stack_metrics(per_step, state.x.device)

    return chunk


def make_sample_chain(cfg: SamplerConfig, energy_fn):
    """Sampling after training: ``sample(params, x0, generator,
    num_samples, beta=1.0) -> (xs (T, chains, d), accept_probs (T,
    chains))``, each sample the state after its transition."""
    _, dyn, _ = build_sampler_dynamics(cfg, energy_fn)

    @torch.no_grad()
    def sample(params, x0, generator, num_samples: int, beta=1.0):
        x, xs, probs = x0, [], []
        for _ in range(num_samples):
            out = dyn["transition"](params, x, beta, generator)
            x = out.x_out
            xs.append(x)
            probs.append(out.accept_prob)
        return torch.stack(xs), torch.stack(probs)

    return sample
