"""VAE with an L2HMC posterior sampler (port of ``l2hmc_tpu/train/vae.py``).

- encoder/decoder MLPs (ReLU between layers, the last layer linear);
- posterior energy ``E(z|x) = BCE(decoder(z), x) + 0.5 |z|^2``;
- an L2HMC sampler over the latents, both nets conditioned on the data
  batch through their ``aux`` input, started at the encoder's sample;
- ``mh_steps`` sequential transitions (or ``chain_operator`` compositions)
  building the squared-jump sampler loss;
- three Adam groups at their own rates: the encoder (ELBO), the decoder
  (ELBO and the likelihood at the sampled latents) and the dynamics nets
  (the sampler loss; NaN gradients zeroed on this group only);
- the AIS log-likelihood (``dynamics/ais.py``) and the sampler's
  autocovariance diagnostics.

The sampler loss sees the encoder and decoder as constants, as the
reference's ``stop_gradient`` does; its forces are still differentiated
with ``create_graph``, so the dynamics nets get the gradient through each
leapfrog's ``dE/dz``.  The dynamics run with ``remat=False``: the
activations are kept for the backward instead of recomputed (the same
numbers, half the eager launches).

Randomness: the step's draws are :class:`VAEDraws` (the ELBO's and the
sampler start's normals, and per MH step the transition's momenta,
directions and accept uniforms, with the composition counts under
``random_lf_composition``), drawn from a ``torch.Generator`` unless given.

Dataset: ``data/digits_binarized.npz``, the 8x8 digits of the UCI Optical
Recognition of Handwritten Digits set as bundled with scikit-learn, scaled
to [0, 1] and binarized at 0.5 (``load_digits_binarized``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from l2hmc_tpu_torch._device import resolve_device
from l2hmc_tpu_torch.dynamics.l2hmc import (
    DynamicsConfig,
    DynamicsParams,
    make_dynamics,
    make_masks,
)
from l2hmc_tpu_torch.networks.nets import Dense, MLPNetSpec, make_mlp_net

DIGITS_PATH = Path(__file__).resolve().parents[1] / "data" / \
    "digits_binarized.npz"


def load_digits_binarized(path=DIGITS_PATH) -> np.ndarray:
    """The bundled 8x8 digits ``(1797, 64)`` float32 of {0, 1}: pixels
    scaled to [0, 1] and thresholded at 0.5, stored bit-packed."""
    d = np.load(path)
    n, width = (int(v) for v in d["shape"])
    bits = np.unpackbits(d["bits"], axis=1, count=width)
    assert bits.shape == (n, width)
    return bits.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    data_dim: int = 64
    latent_dim: int = 8
    enc_hidden: int = 256
    dec_hidden: int = 256
    # sampler
    num_steps: int = 5          # leapfrog steps per transition
    mh_steps: int = 2           # sequential transitions
    eps_init: float = 0.1
    sampler_hidden: int = 64
    # > 0: each MH step composes a random number (1..N) of full leapfrog
    # integrations before its single accept (chain_operator); 0 = plain
    # sequential transitions
    random_lf_composition: int = 0
    # optimization
    lr_elbo: float = 1e-3
    lr_sampler: float = 1e-3
    lr_decoder: float = 1e-3


class VAEParams(nn.Module):
    """The encoder and decoder (lists of :class:`Dense`, ``w (in, out)``)
    and the sampler's ``DynamicsParams``."""

    def __init__(self, encoder: Sequence[Dense], decoder: Sequence[Dense],
                 dynamics: DynamicsParams):
        super().__init__()
        self.encoder = nn.ModuleList(encoder)
        self.decoder = nn.ModuleList(decoder)
        self.dynamics = dynamics


class VAEDraws(NamedTuple):
    """One train step's randomness: ``elbo``, ``z0`` ``(B, latent)``
    normals; ``mh`` one tuple per MH step, ``(v, direction, u)`` or, under
    ``random_lf_composition``, ``(n_comp, v, direction, u)``."""

    elbo: torch.Tensor
    z0: torch.Tensor
    mh: Tuple[tuple, ...]


class VAEState(NamedTuple):
    params: VAEParams
    optimizer: torch.optim.Optimizer
    step: int


def _mlp_init(generator, dims, device):
    return [Dense(din, dout, 1.0, generator, device)
            for din, dout in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x):
    """Dense layers, ReLU between them, the last layer linear."""
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class _Frozen:
    """A layer's ``w``/``b`` detached: the sampler loss's constant view."""

    def __init__(self, layer):
        self.w, self.b = layer.w.detach(), layer.b.detach()

    def __call__(self, x):
        return x @ self.w + self.b


def _frozen(layers):
    return [_Frozen(layer) for layer in layers]


def draw_posterior_randomness(generator, b: int, latent: int, mh_steps: int,
                              max_compositions: int, device=None):
    """``(z0, mh)`` of :class:`VAEDraws` for one ``sample_posterior``."""
    kw = dict(generator=generator, device=device)

    def transition():
        v = torch.randn((b, latent), **kw)
        d = torch.where(torch.rand((b,), **kw) > 0.5, 1.0, -1.0)
        u = torch.rand((b,), **kw)
        if max_compositions > 0:
            n = torch.randint(1, max_compositions + 1, (b,), **kw)
            return n, v, d, u
        return v, d, u

    z0 = torch.randn((b, latent), **kw)
    return z0, tuple(transition() for _ in range(mh_steps))


def draw_vae_randomness(cfg: VAEConfig, generator, b: int,
                        device=None) -> VAEDraws:
    elbo = torch.randn((b, cfg.latent_dim), generator=generator,
                       device=device)
    z0, mh = draw_posterior_randomness(generator, b, cfg.latent_dim,
                                       cfg.mh_steps,
                                       cfg.random_lf_composition, device)
    return VAEDraws(elbo, z0, mh)


def build_vae(cfg: VAEConfig):
    """``(init, fns)``: ``init(generator, device=None) -> VAEParams`` and
    the dict of the encoder, decoder, ``bce``, ``posterior_energy``,
    ``sample_posterior`` and ``dyn_cfg``."""
    dyn_cfg = DynamicsConfig(x_dim=cfg.latent_dim, num_steps=cfg.num_steps,
                             use_log_eps=True, remat=False)
    specs = [MLPNetSpec(cfg.latent_dim, cfg.sampler_hidden, factor=f,
                        bounded_q=True, aux_dim=cfg.data_dim)
             for f in (2.0, 1.0)]

    def encoder_apply(layers, x):
        h = _mlp_apply(layers, x)
        mu, logvar = torch.chunk(h, 2, dim=-1)
        return mu, logvar

    def decoder_apply(layers, z):
        return _mlp_apply(layers, z)  # logits

    def bce(logits, x):
        """Per-sample Bernoulli negative log-likelihood."""
        return torch.sum(torch.clamp(logits, min=0) - logits * x
                         + torch.log1p(torch.exp(-torch.abs(logits))),
                         dim=-1)

    def make_posterior_energy(dec_layers, x_batch):
        """E(z | x) = -log p(x|z) - log p(z)."""

        def energy(z):
            return (bce(decoder_apply(dec_layers, z), x_batch)
                    + 0.5 * torch.sum(z * z, dim=-1))

        return energy

    def init(generator=None, device=None) -> VAEParams:
        device = resolve_device(device)
        where = generator.device if generator is not None else device
        enc = _mlp_init(generator, [cfg.data_dim, cfg.enc_hidden,
                                    2 * cfg.latent_dim], where)
        dec = _mlp_init(generator, [cfg.latent_dim, cfg.dec_hidden,
                                    cfg.data_dim], where)
        xnet, vnet = (make_mlp_net(s, generator, where) for s in specs)
        masks = make_masks(generator, cfg.num_steps, cfg.latent_dim, where)
        dyn = DynamicsParams(xnet, vnet, torch.tensor(np.log(cfg.eps_init)),
                             masks)
        return VAEParams(enc, dec, dyn).to(device)

    def sample_posterior(params: VAEParams, x_batch, generator=None,
                         dec_layers=None, enc_layers=None, draws=None):
        """The encoder's sample refined by ``mh_steps`` L2HMC transitions.
        ``draws``: ``(z0, mh)`` of :func:`draw_posterior_randomness`.
        Returns ``(z, accept_probs (mh, B), jump_dists (mh, B))``."""
        dec = params.decoder if dec_layers is None else dec_layers
        enc = params.encoder if enc_layers is None else enc_layers
        dyn = make_dynamics(dyn_cfg, make_posterior_energy(dec, x_batch))
        if draws is None:
            draws = draw_posterior_randomness(
                generator, x_batch.shape[0], cfg.latent_dim, cfg.mh_steps,
                cfg.random_lf_composition, x_batch.device)
        z0, mh = draws
        mu, logvar = encoder_apply(enc, x_batch)
        z = mu + torch.exp(0.5 * logvar) * z0
        probs, jumps = [], []
        for d in mh:
            if cfg.random_lf_composition > 0:
                out = dyn["chain_operator_with"](
                    params.dynamics, z, 1.0, cfg.random_lf_composition, *d,
                    aux=x_batch)
            else:
                out = dyn["transition_with"](params.dynamics, z, 1.0, *d,
                                             aux=x_batch)
            probs.append(out.accept_prob)
            jumps.append(torch.sum((out.x_proposed - z) ** 2, dim=-1))
            z = out.x_out
        return z, torch.stack(probs), torch.stack(jumps)

    fns = {
        "encoder": encoder_apply,
        "decoder": decoder_apply,
        "bce": bce,
        "posterior_energy": make_posterior_energy,
        "sample_posterior": sample_posterior,
        "dyn_cfg": dyn_cfg,
    }
    return init, fns


def _zero_nans(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(t), torch.zeros_like(t), t)


def make_vae_train_step(cfg: VAEConfig):
    """``(init_state, train_step, fns)``.

    ``init_state(generator, device=None, params=None) -> VAEState`` (fresh
    Adam state for ``params``, or for a fresh init);
    ``train_step(state, batch, generator=None, draws=None) -> (state,
    aux)``, ``aux`` the loss, ``elbo``, ``sampler_loss``, ``decoder_nll``
    and ``accept_prob`` as 0-d tensors.  The parameters update in place.
    """
    init, fns = build_vae(cfg)

    def make_optimizer(params: VAEParams) -> torch.optim.Optimizer:
        # the masks are a buffer: never trained
        return torch.optim.Adam([
            {"params": list(params.encoder.parameters()), "lr": cfg.lr_elbo},
            {"params": list(params.decoder.parameters()),
             "lr": cfg.lr_decoder},
            {"params": list(params.dynamics.parameters()),
             "lr": cfg.lr_sampler},
        ], eps=1e-8)

    def init_state(generator=None, device=None,
                   params: Optional[VAEParams] = None) -> VAEState:
        if params is None:
            params = init(generator, device)
        return VAEState(params, make_optimizer(params), 0)

    def loss_fn(params: VAEParams, x, draws: VAEDraws):
        # (1) ELBO loss -> encoder + decoder
        mu, logvar = fns["encoder"](params.encoder, x)
        z = mu + torch.exp(0.5 * logvar) * draws.elbo
        rec = fns["bce"](fns["decoder"](params.decoder, z), x)
        kl = 0.5 * torch.sum(torch.exp(logvar) + mu * mu - 1.0 - logvar,
                             dim=-1)
        elbo_loss = torch.mean(rec + kl)
        # (2) sampler loss on the dynamics nets, the encoder and decoder
        # held constant
        z_s, probs, jumps = fns["sample_posterior"](
            params, x, dec_layers=_frozen(params.decoder),
            enc_layers=_frozen(params.encoder), draws=(draws.z0, draws.mh))
        v = torch.mean(jumps * probs, dim=0) + 1e-4
        sampler_loss = torch.mean(1.0 / v - v)
        # (3) decoder likelihood at the refined latents
        dec_ll = torch.mean(fns["bce"](
            fns["decoder"](params.decoder, z_s.detach()), x))
        total = elbo_loss + sampler_loss + dec_ll
        aux = {
            "elbo": -elbo_loss.detach(),
            "sampler_loss": sampler_loss.detach(),
            "decoder_nll": dec_ll.detach(),
            "accept_prob": torch.mean(probs.detach()),
        }
        return total, aux

    def train_step(state: VAEState, batch, generator=None,
                   draws: Optional[VAEDraws] = None):
        params, opt = state.params, state.optimizer
        x = torch.as_tensor(batch, dtype=torch.float32,
                            device=params.dynamics.raw_eps.device)
        if draws is None:
            draws = draw_vae_randomness(cfg, generator, x.shape[0], x.device)
        opt.zero_grad(set_to_none=False)
        loss, aux = loss_fn(params, x, draws)
        loss.backward()
        with torch.no_grad():
            for p in params.dynamics.parameters():
                if p.grad is not None:
                    p.grad.copy_(_zero_nans(p.grad))
        opt.step()
        aux["loss"] = loss.detach()
        return VAEState(params, opt, state.step + 1), aux

    return init_state, train_step, fns


def ais_log_likelihood(cfg: VAEConfig, fns, params: VAEParams, x_batch,
                       generator=None, num_betas: int = 100,
                       eps: float = 0.2, z0=None, draws=None):
    """Per-datum log p(x) estimates ``(B,)`` by AIS from the prior to the
    posterior energy (one chain per datum, HMC with 5 leapfrog steps).

    Z0 = (2 pi)^(d/2) and Z1 = (2 pi)^(d/2) p(x), so the log-weight
    estimates log p(x) with no additive normalization.  ``z0 (B, latent)``
    and ``draws`` (``ais_log_weights``') replace the generator's."""
    from l2hmc_tpu_torch.dynamics.ais import ais_log_weights

    e1 = fns["posterior_energy"](params.decoder, x_batch)

    def e0(z):
        return 0.5 * torch.sum(z * z, dim=-1)

    if z0 is None:
        z0 = torch.randn((x_batch.shape[0], cfg.latent_dim),
                         generator=generator, device=x_batch.device)
    return ais_log_weights(generator, z0, e0, e1, num_betas=num_betas,
                           eps=eps, num_leapfrog=5, draws=draws)


def normal_kl(q_means, q_stddevs, p_means, p_stddevs):
    """KL(q || p) between diagonal normals, summed over the last axis."""
    q_entropy = 0.5 + torch.log(q_stddevs)
    cross = (0.5 * (q_stddevs / p_stddevs) ** 2
             + 0.5 * ((q_means - p_means) / p_stddevs) ** 2
             + torch.log(p_stddevs))
    return torch.sum(cross - q_entropy, dim=-1)


@torch.no_grad()
def posterior_sampler_autocovariance(cfg: VAEConfig, fns, params: VAEParams,
                                     x_batch, generator=None,
                                     num_transitions: int = 200):
    """Mixing diagnostics of the trained posterior sampler: a chain of
    ``num_transitions`` transitions on a fixed data batch from the
    encoder's sample; the autocorrelation of latent 0 of chain 0, the mean
    ESS per step over the first 4 chains x 4 latents, and the mean
    acceptance."""
    from l2hmc_tpu_torch.analysis import stats

    dyn = make_dynamics(fns["dyn_cfg"],
                        fns["posterior_energy"](params.decoder, x_batch))
    mu, logvar = fns["encoder"](params.encoder, x_batch)
    z = mu + torch.exp(0.5 * logvar) * torch.randn(
        mu.shape, generator=generator, device=mu.device)
    zs, probs = [], []
    for _ in range(num_transitions):
        out = dyn["transition"](params.dynamics, z, 1.0, generator,
                                aux=x_batch)
        z = out.x_out
        zs.append(z)
        probs.append(out.accept_prob)
    zs = torch.stack(zs).cpu().numpy()          # (T, batch, latent_dim)
    ess = float(np.mean([
        stats.calc_ess(zs[:, b, d])
        for b in range(min(4, zs.shape[1]))
        for d in range(min(4, zs.shape[2]))
    ]))
    return {
        "autocorrelation": stats.autocorr_fft(zs[:, 0, 0]),
        "ess_per_step": ess,
        "accept_prob": float(torch.stack(probs).mean()),
    }


def vae_params_from_numpy(tree, cfg: VAEConfig, device=None) -> VAEParams:
    """Port params from the reference's ``VAEParams`` with numpy leaves:
    ``encoder``/``decoder`` lists of ``{"w", "b"}`` and ``dynamics`` a
    ``DynamicsParams`` (``xnet``/``vnet`` dicts of the aux MLP, ``raw_eps``,
    ``masks``), on ``device`` (``None``: the card)."""
    from l2hmc_tpu_torch.train.checkpoint import _net_arrays

    device = resolve_device(device)
    init, _ = build_vae(cfg)
    params = init(torch.Generator().manual_seed(0), device="cpu")
    for layers, arrays in ((params.encoder, tree.encoder),
                           (params.decoder, tree.decoder)):
        if len(layers) != len(arrays):
            raise ValueError(f"expected {len(layers)} layers, got "
                             f"{len(arrays)}")
        for layer, a in zip(layers, arrays):
            layer.load_state_dict({k: torch.tensor(np.asarray(a[k],
                                                              np.float32))
                                   for k in ("w", "b")})
    dyn = tree.dynamics
    for net, arrays in ((params.dynamics.xnet, dyn.xnet),
                        (params.dynamics.vnet, dyn.vnet)):
        net.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                             for k, v in _net_arrays(arrays).items()},
                            strict=True)
    with torch.no_grad():
        params.dynamics.raw_eps.copy_(torch.tensor(
            np.asarray(dyn.raw_eps, np.float32)))
        params.dynamics.masks.copy_(torch.tensor(
            np.asarray(dyn.masks, np.float32)))
    return params.to(device)
