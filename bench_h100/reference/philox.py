"""The chain kernels' in-kernel random stream, replayed in plain PyTorch.

The fused chain kernels draw, when no arrays are injected, from cuRAND's
Philox4x32-10 with ``curand_init(seed, subsequence=chain * N + n,
offset)``: chain ``chain`` of a call of ``N`` transitions, transition
``n``.  Site ``i`` takes its two momenta from ``curand_normal2`` at offset
``8 i`` (Box-Muller of the first two words), and the chain's scalars are
the four words at offset ``8 d`` read by ``curand_uniform``.  Here the same
counters and keys go through the same ten rounds in int64 arithmetic (every
product split so that none overflows), so the words are exact; the
Box-Muller transform uses torch's ``log``/``sin``/``cos``, which may differ
from the device's by an ulp or two.

Nothing here imports the program: this is the yardstick's own copy.
"""

from __future__ import annotations

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
ROUNDS = 10
POW32_INV = np.float32(2.3283064e-10)
POW32_INV_2PI = np.float32(np.float32(2.3283064e-10) * np.float32(6.2831855))


def _mulhilo(m: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * b`` for ``b`` in ``[0, 2^32)``:
    ``b`` split in 16-bit halves so every int64 product stays below 2^49."""
    p_lo = (b & 0xFFFF) * m
    t = (p_lo >> 16) + (b >> 16) * m
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 of counter words ``c0..c3`` (int64 tensors of 32-bit
    values, broadcastable) under the key of ``seed`` (64 bits).  Returns
    the four output words."""
    k0, k1 = seed & MASK, (seed >> 32) & MASK
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _subsequence(chains: torch.Tensor, n: int, num: int):
    sub = chains * num + n
    return sub & MASK, sub >> 32


def uniform(word: torch.Tensor) -> torch.Tensor:
    """``curand_uniform`` of a 32-bit word: in (0, 1]."""
    return word.to(torch.float32) * POW32_INV + POW32_INV / 2


def momenta(seed: int, b: int, d: int, n: int, num: int, device,
            chain0: int = 0):
    """``(v0, v1)``, each ``(b, d)``: the momenta of transition ``n`` of a
    call of ``num`` transitions for chains ``chain0 .. chain0 + b - 1``."""
    chains = torch.arange(chain0, chain0 + b, dtype=torch.int64,
                          device=device)[:, None]
    sites = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    s_lo, s_hi = _subsequence(chains, n, num)
    x, y, _, _ = philox4x32(2 * sites, torch.zeros_like(sites), s_lo, s_hi,
                            seed)
    u = uniform(x)
    v = y.to(torch.float32) * POW32_INV_2PI + POW32_INV_2PI / 2
    s = torch.sqrt(-2.0 * torch.log(u))
    return torch.sin(v) * s, torch.cos(v) * s


def scalars(seed: int, b: int, d: int, n: int, num: int, device,
            chain0: int = 0):
    """The four per-chain words at offset ``8 d`` of transition ``n``, as
    ``curand_uniform`` values, each ``(b,)``."""
    chains = torch.arange(chain0, chain0 + b, dtype=torch.int64,
                          device=device)
    s_lo, s_hi = _subsequence(chains, n, num)
    lo = torch.full_like(chains, (2 * d) & MASK)
    words = philox4x32(lo, torch.full_like(chains, (2 * d) >> 32), s_lo,
                       s_hi, seed)
    return tuple(uniform(w) for w in words)


def sign(u: torch.Tensor) -> torch.Tensor:
    """The kernels' ``sign_from_uniform``: +1 above one half, else -1."""
    return torch.where(u > 0.5, 1.0, -1.0).to(torch.float32)


def hmc_draws(seed: int, b: int, d: int, num: int, device, chain0: int = 0):
    """``(v0s, v1s, us)`` of a whole ``hmc_chain`` call, the injected
    arrays' layout: ``(num, b, d)``, ``(num, b, d)``, ``(num, b)``."""
    v0s, v1s, us = [], [], []
    for n in range(num):
        v0, v1 = momenta(seed, b, d, n, num, device, chain0)
        v0s.append(v0)
        v1s.append(v1)
        us.append(scalars(seed, b, d, n, num, device, chain0)[0])
    return torch.stack(v0s), torch.stack(v1s), torch.stack(us)


def l2hmc_draws(seed: int, b: int, d: int, num: int, device,
                chain0: int = 0):
    """``(v0s, v1s, ds, us)`` of a whole trained-chain call (directions
    from the first scalar word, accept uniforms from the second)."""
    v0s, v1s, ds, us = [], [], [], []
    for n in range(num):
        v0, v1 = momenta(seed, b, d, n, num, device, chain0)
        w = scalars(seed, b, d, n, num, device, chain0)
        v0s.append(v0)
        v1s.append(v1)
        ds.append(sign(w[0]))
        us.append(w[1])
    return torch.stack(v0s), torch.stack(v1s), torch.stack(ds), torch.stack(us)


def draw_seed(generator: torch.Generator) -> int:
    """The kernel seed a chain wrapper draws from ``generator`` for one
    call: one ``randint(0, 2^62)``."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
