"""Fused U(1) HMC chain: shared math, plain version and the CUDA wrapper.

Port of ``l2hmc_tpu/ops/leapfrog.py``.  One call runs ``N`` complete HMC
transitions — each K leapfrog steps of the analytic Wilson force, the mod-2pi
wrap, the Hamiltonian bookkeeping and the MH accept, optionally followed by
one exact instanton hop — and returns the final links plus ``(N, B)`` traces
of plaquette, rounded charge and accept probability.

Link state is kept as two flat ``(B, Lt*Lx)`` halves (one per direction),
site index ``i = t*Lx + s``.  Neighbour reads use ``torch.roll`` on the
``(B, Lt, Lx)`` view.

:func:`hmc_chain_reference` is the plain PyTorch version; :func:`hmc_chain`
runs it for CPU tensors and launches ``csrc/hmc_chain.cu`` for CUDA tensors.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.utils import trace

# the spans of a chain wrapper's call on the card (utils/trace.py): the
# whole call, its kernel seed or injected draws, its launch
CALL_SPAN = "chain.call"
SEED_SPAN = "chain.seed"
LAUNCH_SPAN = "chain.launch"

_TWO_PI = 2.0 * np.pi


# ---------------------------------------------------------------------------
# Shared math on flat (B, Lt*Lx) link halves.
# ---------------------------------------------------------------------------


def _nb(a: torch.Tensor, lx: int, dt: int, ds: int) -> torch.Tensor:
    """Field at the neighbour ``((t+dt) mod Lt, (s+ds) mod Lx)`` of each site."""
    b = a.shape[0]
    v = a.reshape(b, -1, lx)
    return torch.roll(v, shifts=(-dt, -ds), dims=(1, 2)).reshape(b, -1)


def _plaq_flat(u0, u1, lx):
    """P = u0 - u1 - u0(t, s+1) + u1(t+1, s)."""
    return u0 - u1 - _nb(u0, lx, 0, 1) + _nb(u1, lx, 1, 0)


def _grad_flat(sinp, lx):
    """dS/du0 = sinP - sinP(t, s-1); dS/du1 = -sinP + sinP(t-1, s)."""
    g0 = sinp - _nb(sinp, lx, 0, -1)
    g1 = -sinp + _nb(sinp, lx, -1, 0)
    return g0, g1


def _wrap(x):
    return x - _TWO_PI * torch.floor((x + np.pi) / _TWO_PI)


def _potential_fields(y0, y1, lx):
    """Potential, sine and cosine plaquette fields and the unrounded charge
    ``Q = sum(wrap(P)) / 2pi`` in one pass."""
    p = _plaq_flat(y0, y1, lx)
    chg = torch.sum(_wrap(p), dim=1) * (1.0 / _TWO_PI)
    cosp = torch.cos(p)
    return torch.sum(1.0 - cosp, dim=1), torch.sin(p), cosp, chg


def _winding_flat(rows, d, lt, lx, device=None):
    """Flat winding-1 field halves ``(rows, d)``: ``w1 = delta * t``; ``w0``
    is ``-delta * lt * s`` on the seam row ``t = lt-1`` and zero elsewhere."""
    delta0 = _TWO_PI / d
    i = torch.arange(d, device=device)
    s_f = (i % lx).to(torch.float32)
    t_f = (i // lx).to(torch.float32)
    w1 = delta0 * t_f
    w0 = torch.where(t_f == float(lt - 1), -delta0 * lt * s_f,
                     torch.zeros_like(s_f))
    return w0.expand(rows, d), w1.expand(rows, d)


def _hop_math(x0, x1, pot, sinp, cosp, chg, nu, u_h, beta, w0f, w1f):
    """One exact instanton hop on the carried plaquette fields.

    With the uniform shift ``delta = 2 pi nu / d``,
    ``dS = (1 - cos d0)(d - pot) + nu sin d0 sum(sinp)``.  On accept the
    links shift by ``nu w``, the carried fields rotate in closed form and the
    charge moves by ``nu`` minus the plaquettes pushed across the branch cut.
    """
    d = x0.shape[1]
    cd = float(np.cos(_TWO_PI / d))
    sd = float(np.sin(_TWO_PI / d))
    ds = (1.0 - cd) * (d - pot) + nu * sd * torch.sum(sinp, dim=1)
    prob = torch.exp(torch.clamp(-beta * ds, max=0.0))
    prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
    acc = (u_h < prob).to(x0.dtype)
    an = acc * nu                                # signed accepted winding
    an_col = an[:, None]
    x0 = _wrap(x0 + an_col * w0f)
    x1 = _wrap(x1 + an_col * w1f)
    cda = 1.0 + acc * (cd - 1.0)                 # cos(delta*|an|)
    sda = an * sd                                # sin(delta*an)
    sinp_new = sinp * cda[:, None] + cosp * sda[:, None]
    cosp_new = cosp * cda[:, None] - sinp * sda[:, None]
    pot_new = pot + acc * ds
    n_b = torch.sum(
        ((cosp < -cd) & (nu[:, None] * sinp >= 0.0)).to(x0.dtype), dim=1)
    chg_new = chg + an * (1.0 - n_b)
    return x0, x1, prob, pot_new, sinp_new, cosp_new, chg_new


def _energy_change(v0, v1, w0, w1, cosp0, cosp1, beta):
    """``H0 - H1 = beta (pot0 - pot1) + (ke0 - ke1)`` summed from per-site
    differences.  Same function as the reference's difference of the two
    Hamiltonians, but without its float32 cancellation (each H is ~1e3 at
    16x16, so that form carries ~1e-4 of rounding); the kernels use the same
    form, which keeps them within ~1e-6 of this version."""
    dke = 0.5 * torch.sum((v0 * v0 + v1 * v1) - (w0 * w0 + w1 * w1), dim=1)
    return beta * torch.sum(cosp1 - cosp0, dim=1) + dke


def _select(acc, new, old):
    """Per-chain accept select (``acc (B,)`` bool) for scalars or fields."""
    if new.dim() == 2:
        acc = acc[:, None]
    return torch.where(acc, new, old)


def _transition_math(x0, x1, v0, v1, u, eps, beta, num_leapfrog, lx,
                     pot0, sinp, chg0, cosp):
    """One HMC transition on flat link halves with the carried potential,
    sine/cosine fields and charge of the input state.

    Returns ``(x0', x1', prob, pot, sinp, chg, cosp)`` of the output state.
    """
    g0, g1 = _grad_flat(sinp, lx)
    w0 = v0 - 0.5 * eps * beta * g0
    w1 = v1 - 0.5 * eps * beta * g1
    y0, y1 = x0, x1
    pot1, sinp1, cosp1, chg1 = pot0, sinp, cosp, chg0
    for k in range(num_leapfrog):
        y0 = _wrap(y0 + eps * w0)
        y1 = _wrap(y1 + eps * w1)
        pot1, sinp1, cosp1, chg1 = _potential_fields(y0, y1, lx)
        g0, g1 = _grad_flat(sinp1, lx)
        c = eps if k < num_leapfrog - 1 else 0.5 * eps
        w0 = w0 - c * beta * g0
        w1 = w1 - c * beta * g1

    dh = _energy_change(v0, v1, w0, w1, cosp, cosp1, beta)
    prob = torch.exp(torch.clamp(dh, max=0.0))
    prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
    acc = u < prob
    return (_select(acc, y0, x0), _select(acc, y1, x1), prob,
            _select(acc, pot1, pot0), _select(acc, sinp1, sinp),
            _select(acc, chg1, chg0), _select(acc, cosp1, cosp))


def _split_links(links):
    b, lt, lx, _ = links.shape
    d = lt * lx
    return (links[..., 0].reshape(b, d).contiguous(),
            links[..., 1].reshape(b, d).contiguous())


def _join_links(x0, x1, lt, lx):
    b = x0.shape[0]
    return torch.stack([x0.reshape(b, lt, lx), x1.reshape(b, lt, lx)], dim=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch version: same math, explicit randomness.
# ---------------------------------------------------------------------------


def hmc_chain_reference(links, v0s, v1s, us, eps, beta, num_leapfrog,
                        hop_arrays=None):
    """Run ``N = v0s.shape[0]`` transitions with injected randomness.

    ``links (B, Lt, Lx, 2)``; ``v0s/v1s (N, B, Lt*Lx)``; ``us (N, B)``.
    ``hop_arrays=(nus, uhs)`` (each ``(N, B)``, nus in {+1,-1}) appends one
    exact instanton hop after every transition.  Returns ``(links_out,
    plaq_trace (N, B), charge_trace (N, B), prob_trace (N, B))``; charges
    are rounded to integer sectors.
    """
    b, lt, lx, _ = links.shape
    d = lt * lx
    x0, x1 = _split_links(links)
    pot, sinp, cosp, chg = _potential_fields(x0, x1, lx)
    if hop_arrays is not None:
        nus, uhs = hop_arrays
        w0f, w1f = _winding_flat(b, d, lt, lx, links.device)
    plaqs, chgs, probs = [], [], []
    for n in range(v0s.shape[0]):
        x0, x1, prob, pot, sinp, chg, cosp = _transition_math(
            x0, x1, v0s[n], v1s[n], us[n], eps, beta, num_leapfrog, lx,
            pot, sinp, chg, cosp)
        if hop_arrays is not None:
            x0, x1, _, pot, sinp, cosp, chg = _hop_math(
                x0, x1, pot, sinp, cosp, chg, nus[n], uhs[n], beta, w0f, w1f)
        plaqs.append(1.0 - pot / d)
        chgs.append(chg)
        probs.append(prob)
    return (_join_links(x0, x1, lt, lx), torch.stack(plaqs),
            torch.round(torch.stack(chgs)), torch.stack(probs))


# ---------------------------------------------------------------------------
# Public wrapper: plain version on CPU, the CUDA kernel on the card.
# ---------------------------------------------------------------------------


def draw_hmc_randomness(generator, n, b, d, hop, device=None):
    """``(v0s, v1s, us[, nus, uhs])`` for :func:`hmc_chain_reference`."""
    kw = dict(generator=generator, dtype=torch.float32, device=device)
    out = [torch.randn((n, b, d), **kw), torch.randn((n, b, d), **kw),
           torch.rand((n, b), **kw)]
    if hop:
        nus = torch.randint(0, 2, (n, b), generator=generator,
                            device=device).to(torch.float32) * 2.0 - 1.0
        out += [nus, torch.rand((n, b), **kw)]
    return tuple(out)


def draw_seed(generator) -> int:
    """A 63-bit kernel seed drawn from ``generator`` (from a card's
    generator the host waits for the card: a ``sync`` span)."""
    draw = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device)
    if not draw.is_cuda:
        return int(draw.item())
    with trace.waiting():
        return int(draw.item())


def check_links(links):
    """Raise unless ``links`` is a ``(B, Lt, Lx, 2)`` batch of link angles."""
    if links.dim() != 4 or links.shape[-1] != 2:
        raise ValueError("links: expected shape (B, Lt, Lx, 2), got "
                         f"{tuple(links.shape)}")


def check_cuda_input(name, t, shape=None, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous ``dtype`` CUDA tensor of
    ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


H100_SMEM_OPTIN = 232448        # bytes of shared memory a block may opt in to
HMC_ROUTES = ("warp", "block", "global")
HMC_WARP_CHAINS = 4             # warp route: chains per block
HMC_CHAIN_WARPS = 2             # warp route: warps per chain
HMC_WARP_SITES = 4              # warp route: sites per lane
HMC_BLOCK_THREADS = 512         # block and global routes: most threads
HMC_BLOCK_SITES = (8, 16)       # block route: sites per thread
HMC_RED_BYTES = 2 * 32 * 4 * 4  # block reductions: 2 buffers x 32 warps x 4
# the JAX kernel's on-chip budget (l2hmc_tpu/ops/leapfrog.py
# hmc_chain_pallas): lattices it refuses, the port's wrapper refuses too
REFERENCE_VMEM_LIMIT = 14 << 20


def hmc_chain_plan(lt: int, lx: int,
                   smem_limit: int = H100_SMEM_OPTIN) -> SimpleNamespace:
    """How ``csrc/hmc_chain.cu`` runs a ``lt x lx`` lattice (its host-side
    plan; the kernel takes the same numbers and checks them).

    ``route``: ``'warp'`` (d <= 256: one chain per pair of warps, 4 chains
    per block, everything but the neighbour-read fields in registers),
    ``'block'`` (d <= 8192: one chain per block of up to 512 threads, 8 or
    16 sites each, the accepted state in device memory) or ``'global'`` (one
    chain per block of 512 threads, every owned field in device memory, the
    neighbour-read fields Y0, Y1, SP1 in shared memory while they fit).
    Also ``chains`` per block, ``threads`` per block, ``cluster`` (1: no
    route uses a thread-block cluster), ``spt`` sites per thread, ``smem``
    bytes per block, ``nb_dev`` (Y0, Y1, SP1 in device memory) and
    ``scratch_fields``: floats per site and chain of the device scratch."""
    d = lt * lx
    if lx < 2 or lt < 1 or d * lx >= 2 ** 32:
        raise ValueError(f"hmc_chain: a {lt}x{lx} lattice is outside the "
                         "kernel's site indexing (lx >= 2, lt * lx^2 < 2^32)")
    nb = 3 * d * 4                       # Y0, Y1, SP1 of one chain
    lanes = 32 * HMC_CHAIN_WARPS
    if d <= lanes * HMC_WARP_SITES:
        # per chain: its fields and 2 x warps x 4 reduction slots
        return SimpleNamespace(
            route="warp", chains=HMC_WARP_CHAINS,
            threads=lanes * HMC_WARP_CHAINS, cluster=1, spt=HMC_WARP_SITES,
            smem=HMC_WARP_CHAINS * (nb + 32 * HMC_CHAIN_WARPS),
            nb_dev=False, scratch_fields=0)
    for spt in HMC_BLOCK_SITES:
        if d <= HMC_BLOCK_THREADS * spt:
            return SimpleNamespace(
                route="block", chains=1, threads=32 * -(-d // (32 * spt)),
                cluster=1, spt=spt, smem=HMC_RED_BYTES + nb, nb_dev=False,
                scratch_fields=2)
    nb_dev = HMC_RED_BYTES + nb > smem_limit
    return SimpleNamespace(
        route="global", chains=1, threads=HMC_BLOCK_THREADS, cluster=1,
        spt=-(-d // HMC_BLOCK_THREADS),
        smem=HMC_RED_BYTES + (0 if nb_dev else nb), nb_dev=nb_dev,
        scratch_fields=9 if nb_dev else 6)


def reference_vmem_bytes(b: int, d: int, n: int, hop: bool) -> int:
    """The JAX kernel's estimate of its on-chip memory for ``b`` chains of
    ``d`` sites and ``n`` transitions per call, with the chain tile it picks
    (``hmc_chain_pallas``'s arithmetic, unchanged)."""
    rows = 20 if hop else 17
    per_row = 4 * (rows * d + (8 if hop else 6) * n)
    tile_b = max(8, min(b, (8 << 20) // per_row))
    if tile_b < b:
        tile_b = (tile_b // 128) * 128 if tile_b >= 128 else (tile_b // 8) * 8
    while b % tile_b != 0 and tile_b > 1:
        tile_b -= 1
    return tile_b * per_row


def hmc_chain(links, generator, eps, beta, num_leapfrog, num_transitions,
              hop=False, rand_arrays=None):
    """Run ``num_transitions`` fused U(1) HMC transitions.

    ``links (B, Lt, Lx, 2)`` float32 angles.  Returns ``(links_out,
    plaq_trace (N, B), charge_trace (N, B), prob_trace (N, B))``; charges
    are rounded to integer sectors.

    A CPU tensor runs :func:`hmc_chain_reference`, with randomness drawn from
    ``generator`` unless ``rand_arrays=(v0s, v1s, us[, nus, uhs])`` is given.
    A CUDA tensor launches the kernel of ``csrc/hmc_chain.cu`` on the route
    of :func:`hmc_chain_plan` — with the injected arrays, or with in-kernel
    Philox randomness seeded from ``generator`` — or raises; it never falls
    back.  It raises a ``ValueError`` naming the bytes where the JAX
    kernel's own estimate (:func:`reference_vmem_bytes`) refuses the call.
    """
    check_links(links)
    b, lt, lx, _ = links.shape
    d = lt * lx
    n = num_transitions
    if rand_arrays is not None and len(rand_arrays) != (5 if hop else 3):
        raise ValueError("rand_arrays must be (v0s, v1s, us"
                         + (", nus, uhs)" if hop else ")"))
    if not links.is_cuda:
        if rand_arrays is None:
            rand_arrays = draw_hmc_randomness(generator, n, b, d, hop,
                                              links.device)
        return hmc_chain_reference(
            links, *rand_arrays[:3], eps, beta, num_leapfrog,
            hop_arrays=tuple(rand_arrays[3:]) if hop else None)

    if links.dtype != torch.float32:
        raise ValueError(f"links: expected float32, got {links.dtype}")
    if num_leapfrog < 1:
        raise ValueError(f"num_leapfrog={num_leapfrog}: the kernel needs >= 1")
    est = reference_vmem_bytes(b, d, n, hop)
    if est > REFERENCE_VMEM_LIMIT:
        raise ValueError(
            f"hmc_chain: {b} chains of {lt}x{lx}, {n} transitions per call: "
            f"the reference kernel's estimate is {est} B of on-chip memory, "
            f"over its {REFERENCE_VMEM_LIMIT} B; make fewer transitions per "
            "call")
    with trace.span(CALL_SPAN):
        return _hmc_chain_cuda(links, generator, eps, beta, num_leapfrog, n,
                               hop, rand_arrays)


def _hmc_chain_cuda(links, generator, eps, beta, num_leapfrog, n, hop,
                    rand_arrays):
    b, lt, lx, _ = links.shape
    d = lt * lx
    lib = _cuda.library()
    dev = links.device
    plan = hmc_chain_plan(lt, lx, lib.smem_optin_bytes(dev.index or 0))
    x0, x1 = _split_links(links)
    scratch = None
    if plan.scratch_fields:
        scratch = torch.empty((b, plan.scratch_fields, d),
                              dtype=torch.float32, device=dev)
    rand = [None] * 5
    seed = 0
    with trace.span(SEED_SPAN):
        if rand_arrays is not None:
            shapes = [(n, b, d), (n, b, d), (n, b), (n, b), (n, b)]
            for i, (name, arr) in enumerate(zip(
                    ("v0s", "v1s", "us", "nus", "uhs"), rand_arrays)):
                check_cuda_input(name, arr, shapes[i])
                rand[i] = arr
        else:
            seed = draw_seed(generator)
    plaq = torch.empty((n, b), dtype=torch.float32, device=dev)
    chg = torch.empty_like(plaq)
    prob = torch.empty_like(plaq)
    hmc_chain.launches += 1
    with trace.span(LAUNCH_SPAN):
        _cuda.check(lib.hmc_chain_launch(
            x0.data_ptr(), x1.data_ptr(), _cuda.ptr(scratch),
            *[_cuda.ptr(r) for r in rand],
            plaq.data_ptr(), chg.data_ptr(), prob.data_ptr(),
            b, lt, lx, num_leapfrog, n, float(eps), float(beta), int(hop),
            seed, HMC_ROUTES.index(plan.route), plan.spt, plan.threads,
            int(plan.nb_dev), dev.index or 0, _cuda.stream_handle(dev)),
            "hmc_chain_launch")
    return _join_links(x0, x1, lt, lx), plaq, torch.round(chg), prob


hmc_chain.launches = 0
