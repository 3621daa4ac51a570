"""2-D Ising model with checkerboard Metropolis MCMC (port of
``l2hmc_tpu/lattice/ising.py``).

A full checkerboard half-sweep updates every same-colour site at once
(exact, since the interaction is nearest-neighbour).  Also exposes the
continuous-relaxation energy on {-1, +1}-valued tensors so the L2HMC
dynamics can target it like any other energy function.  Draws come from a
``torch.Generator`` on the spins' device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from l2hmc_tpu_torch._device import resolve_device


def ising_energy(spins: torch.Tensor, j: float = 1.0) -> torch.Tensor:
    """Total energy ``-J sum_<ij> s_i s_j`` on a periodic square lattice.

    ``spins (..., L, L)``; returns ``(...,)``.
    """
    right = torch.roll(spins, -1, dims=-1)
    down = torch.roll(spins, -1, dims=-2)
    return -j * torch.sum(spins * (right + down), dim=(-2, -1))


def magnetization(spins: torch.Tensor) -> torch.Tensor:
    return torch.mean(spins, dim=(-2, -1))


def make_energy_fn(l: int, j: float = 1.0):
    """Flat-state energy for the dynamics: ``x (batch, L*L) -> (batch,)``.
    Accepts continuous x, interpreting it as soft spins."""

    def energy(x: torch.Tensor) -> torch.Tensor:
        return ising_energy(x.reshape(*x.shape[:-1], l, l), j)

    return energy


def metropolis_half_sweep(spins: torch.Tensor, beta, generator,
                          color: int) -> torch.Tensor:
    """Update all sites of one checkerboard colour simultaneously."""
    l1, l2 = spins.shape[-2], spins.shape[-1]
    ii = torch.arange(l1, device=spins.device)[:, None]
    jj = torch.arange(l2, device=spins.device)[None, :]
    mask = (ii + jj) % 2 == color
    # local field = sum of the 4 neighbours
    nb = (torch.roll(spins, 1, dims=-1) + torch.roll(spins, -1, dims=-1)
          + torch.roll(spins, 1, dims=-2) + torch.roll(spins, -1, dims=-2))
    delta_e = 2.0 * spins * nb  # energy change of flipping s -> -s (J=1)
    u = torch.rand(spins.shape, generator=generator, device=spins.device,
                   dtype=spins.dtype)
    accept = (u < torch.exp(torch.clamp(-beta * delta_e, max=0.0))) & mask
    return torch.where(accept, -spins, spins)


def metropolis_sweep(spins: torch.Tensor, beta, generator) -> torch.Tensor:
    spins = metropolis_half_sweep(spins, beta, generator, 0)
    return metropolis_half_sweep(spins, beta, generator, 1)


@torch.no_grad()
def ising_chain(generator, l: int, beta, num_sweeps: int, batch: int = 1,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A hot-started chain of ``num_sweeps`` sweeps on ``device`` (``None``:
    the first CUDA device; the generator must live there); returns the
    ``(num_sweeps, batch)`` energy and |magnetization| traces."""
    device = resolve_device(device)
    spins = torch.where(
        torch.rand((batch, l, l), generator=generator, device=device) > 0.5,
        1.0, -1.0)
    energies, mags = [], []
    for _ in range(num_sweeps):
        spins = metropolis_sweep(spins, beta, generator)
        energies.append(ising_energy(spins))
        mags.append(torch.abs(magnetization(spins)))
    return torch.stack(energies), torch.stack(mags)
