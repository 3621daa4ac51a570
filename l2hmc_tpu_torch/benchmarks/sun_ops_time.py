"""The group operations of the 2-D SU(N) transition, timed one by one on
the card.

At ``train_sun``'s default shape (32 chains of 8x8 links, ``(32, 8, 8, 2,
N, N)`` complex64) for N = 2 and 3: ``torch.linalg.matrix_exp`` of the
left translation, the reference's reunitarization route
(``torch.linalg.qr`` with the diagonal phase fix and ``torch.linalg.det``)
against the port's (``dynamics/sun_hmc.py _reunitarize``: Gram-Schmidt and
the closed-form determinant, the same unique factor), one autograd force,
and one HMC transition (K=3).  Milliseconds per call, the least of a few
timings by CUDA events after a warm-up call; prints one JSON line with the
card's name and power limit.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.sun_ops_time [--reps 5]
"""

from __future__ import annotations

import argparse
import json

import torch


def qr_reunitarize(u: torch.Tensor) -> torch.Tensor:
    """The reference's route: QR, the diagonal phase fix, the determinant's
    phase divided out."""
    q, r = torch.linalg.qr(u)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    q = q * (d / torch.abs(d))[..., None, :]
    det = torch.linalg.det(q)
    return q * (det ** (-1.0 / u.shape[-1]))[..., None, None]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--chains", type=int, default=32)
    p.add_argument("--size", type=int, default=8)
    args = p.parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.benchmarks import best_ms, device_info
    from l2hmc_tpu_torch.dynamics.sun_hmc import (
        _left_translate, _reunitarize, algebra_force, sun_hmc_transition,
    )
    from l2hmc_tpu_torch.lattice.sun import generators, random_sun, sun_action
    from l2hmc_tpu_torch.ops.su_matrix import _det_small

    float32_matmuls()
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {"shape": [args.chains, args.size, args.size, 2],
           "ms": {}, "max_abs_diff_qr_vs_gram_schmidt": {}}
    for n in (2, 3):
        gens = generators(n, device)
        u = random_sun(gen, n, (args.chains, args.size, args.size, 2),
                       scale=0.5, device=device)
        theta = 0.1 * torch.randn(u.shape[:-2] + (n * n - 1,),
                                  generator=gen, device=device)
        moved = _left_translate(u, theta, gens)

        def action(v):
            return sun_action(v, 2.0)

        ops = {
            "matrix_exp_left_translate": lambda: _left_translate(
                u, theta, gens),
            "reunitarize_qr": lambda: qr_reunitarize(moved),
            "reunitarize_gram_schmidt": lambda: _reunitarize(moved),
            "det_linalg": lambda: torch.linalg.det(moved),
            "det_closed_form": lambda: _det_small(moved),
            "force": lambda: algebra_force(action, u, gens),
            "hmc_transition_k3": lambda: sun_hmc_transition(
                u, 2.0, gen, 0.15, 3, n),
        }
        out["ms"][f"su{n}"] = {k: best_ms(fn, args.reps)
                               for k, fn in ops.items()}
        out["max_abs_diff_qr_vs_gram_schmidt"][f"su{n}"] = float(
            (qr_reunitarize(moved) - _reunitarize(moved)).abs().max())
    out["device"] = device_info()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
