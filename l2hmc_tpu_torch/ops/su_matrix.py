"""Small-matrix group operations for SU(N) link fields (port of
``l2hmc_tpu/ops/su_matrix.py``): batched ``N x N`` matmuls and elementwise
ops only, the same closed form, Taylor scaling-squaring and Newton-Schulz
iteration as the reference, so the 4-D path matches it to rounding.

- ``expm_ih``: ``exp(i H)`` for hermitian traceless H: the closed form for
  N=2 (eigenvalues +-omega), Taylor + scaling-squaring for N>=3
  (truncation ~1e-7 for ||H|| <~ 1; the MH accept evaluates the action
  exactly, so it does not bias sampling).
- ``polar_reunitarize``: Newton-Schulz iteration to the unitary polar
  factor, then the determinant phase divided out (closed-form det for
  N<=3).
"""

from __future__ import annotations

import torch


def _dag(m: torch.Tensor) -> torch.Tensor:
    return torch.conj(torch.swapaxes(m, -1, -2))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def expm_su2(h: torch.Tensor) -> torch.Tensor:
    """``exp(i H)`` for traceless hermitian 2x2 ``H``, exactly:
    ``cos(omega) I + i sinc(omega) H`` with ``omega^2 = |H_00|^2 +
    |H_01|^2``.  cos and sinc are taken as series below ``omega^2 =
    1e-12``, so the gradient at H = 0 stays finite."""
    om2 = h[..., 0, 0].real ** 2 + torch.abs(h[..., 0, 1]) ** 2
    safe = om2 > 1e-12
    om = torch.sqrt(torch.where(safe, om2, torch.ones_like(om2)))
    cos = torch.where(safe, torch.cos(om), 1.0 - om2 / 2.0)
    sinc = torch.where(safe, torch.sin(om) / om, 1.0 - om2 / 6.0)
    return (cos[..., None, None] * _eye(2, h)
            + 1j * sinc[..., None, None] * h)


def expm_taylor(h: torch.Tensor, order: int = 8,
                squarings: int = 2) -> torch.Tensor:
    """``exp(i H)`` by a Horner-form Taylor series of ``order`` on
    ``iH / 2^squarings``, then ``squarings`` squarings."""
    a = (1j * h) / (2.0 ** squarings)
    eye = _eye(h.shape[-1], h).expand(h.shape)
    p = eye + a / order
    for k in range(order - 1, 0, -1):
        p = eye + (a @ p) / k
    for _ in range(squarings):
        p = p @ p
    return p


def expm_ih(h: torch.Tensor) -> torch.Tensor:
    """``exp(i H)`` for batched traceless hermitian ``(..., N, N)``."""
    if h.shape[-1] == 2:
        return expm_su2(h)
    return expm_taylor(h)


def _det_small(u: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant for N<=3."""
    n = u.shape[-1]
    if n == 1:
        return u[..., 0, 0]
    if n == 2:
        return u[..., 0, 0] * u[..., 1, 1] - u[..., 0, 1] * u[..., 1, 0]
    if n == 3:
        return (
            u[..., 0, 0] * (u[..., 1, 1] * u[..., 2, 2]
                            - u[..., 1, 2] * u[..., 2, 1])
            - u[..., 0, 1] * (u[..., 1, 0] * u[..., 2, 2]
                              - u[..., 1, 2] * u[..., 2, 0])
            + u[..., 0, 2] * (u[..., 1, 0] * u[..., 2, 1]
                              - u[..., 1, 1] * u[..., 2, 0])
        )
    return torch.linalg.det(u)


def polar_reunitarize(u: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Project near-unitary ``u`` to SU(N): ``iters`` Newton-Schulz steps
    ``X <- X (3I - X^+ X) / 2`` to the unitary polar factor, then the
    principal n-th root of the determinant's phase divided out."""
    n = u.shape[-1]
    eye = _eye(n, u)
    x = u
    for _ in range(iters):
        x = x @ (1.5 * eye - 0.5 * (_dag(x) @ x))
    det = _det_small(x)
    phase = det / torch.abs(det)
    root = torch.exp(-1j * torch.angle(phase) / n)
    return x * root[..., None, None]
