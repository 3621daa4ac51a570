"""SU(2)/SU(3) group scaffolding (port of ``l2hmc_tpu/lattice/sun.py``).

Generator constants (Pauli / 2, Gell-Mann / 2), random near-identity group
elements ``expm(i alpha . T)``, SU(N) plaquettes as link-matrix products and
the Wilson action ``beta sum (1 - Re tr P / N)``.  Links are ``complex64``
tensors ``(..., Lt, Lx, 2, N, N)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from l2hmc_tpu_torch._device import resolve_device

PAULI = np.array(
    [
        [[0, 1], [1, 0]],
        [[0, -1j], [1j, 0]],
        [[1, 0], [0, -1]],
    ],
    dtype=np.complex64,
)

GELL_MANN = np.array(
    [
        [[0, 1, 0], [1, 0, 0], [0, 0, 0]],
        [[0, -1j, 0], [1j, 0, 0], [0, 0, 0]],
        [[1, 0, 0], [0, -1, 0], [0, 0, 0]],
        [[0, 0, 1], [0, 0, 0], [1, 0, 0]],
        [[0, 0, -1j], [0, 0, 0], [1j, 0, 0]],
        [[0, 0, 0], [0, 0, 1], [0, 1, 0]],
        [[0, 0, 0], [0, 0, -1j], [0, 1j, 0]],
        [
            [1 / np.sqrt(3), 0, 0],
            [0, 1 / np.sqrt(3), 0],
            [0, 0, -2 / np.sqrt(3)],
        ],
    ],
    dtype=np.complex64,
)


def generators_np(n: int) -> np.ndarray:
    """The generators ``T_k`` of su(N) as numpy complex64 ``(k, N, N)``."""
    if n == 2:
        return PAULI / 2.0
    if n == 3:
        return GELL_MANN / 2.0
    raise ValueError(f"SU({n}) not supported (N in {{2,3}})")


def generators(n: int, device=None) -> torch.Tensor:
    return torch.from_numpy(generators_np(n)).to(device)


def algebra_to_matrix(theta: torch.Tensor, gens: torch.Tensor) -> torch.Tensor:
    """Algebra coordinates ``theta (..., k)`` -> hermitian ``(..., N, N)``."""
    return torch.einsum("...k,kij->...ij", theta.to(torch.complex64), gens)


def dagger(m: torch.Tensor) -> torch.Tensor:
    return torch.conj(torch.swapaxes(m, -1, -2))


def random_sun(generator: Optional[torch.Generator], n: int, shape=(),
               scale: float = 0.1, device=None,
               normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random near-identity SU(N) elements ``expm(i sum a_k T_k)`` with
    ``a = scale * normals``, ``normals (*shape, k)`` drawn from
    ``generator`` unless given.  Returns ``(*shape, n, n)`` complex64 on
    the normals' device (drawn: ``device``, ``None`` the card)."""
    k = n * n - 1
    if normals is None:
        device = resolve_device(device)
        normals = torch.randn((*shape, k), generator=generator,
                              device=generator.device if generator is not None
                              else device).to(device)
    h = algebra_to_matrix(scale * normals, generators(n, normals.device))
    return torch.linalg.matrix_exp(1j * h)


def sun_plaquette(links: torch.Tensor) -> torch.Tensor:
    """SU(N) plaquette field from links ``(..., Lt, Lx, 2, N, N)``:
    ``P(n) = U0(n) U1(n+0) U0(n+1)^+ U1(n)^+``, direction 0 = time (axis
    -4), 1 = space (axis -3).  Returns ``(..., Lt, Lx, N, N)``."""
    u0 = links[..., 0, :, :]
    u1 = links[..., 1, :, :]
    u1_tp = torch.roll(u1, -1, dims=-4)
    u0_xp = torch.roll(u0, -1, dims=-3)
    return u0 @ u1_tp @ dagger(u0_xp) @ dagger(u1)


def retrace_over_n(p: torch.Tensor) -> torch.Tensor:
    """``Re tr P / N`` of ``(..., N, N)``."""
    return torch.diagonal(p, dim1=-2, dim2=-1).sum(-1).real / p.shape[-1]


def sun_action(links: torch.Tensor, beta) -> torch.Tensor:
    """Wilson action ``beta sum (1 - Re tr P / N)`` per sample."""
    return beta * torch.sum(1.0 - retrace_over_n(sun_plaquette(links)),
                            dim=(-2, -1))


def is_unitary(u: torch.Tensor, atol: float = 1e-5) -> bool:
    n = u.shape[-1]
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    return bool(torch.max(torch.abs(u @ dagger(u) - eye)) < atol)
