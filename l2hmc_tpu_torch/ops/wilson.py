"""Wilson action with its analytic gradient (port of ``l2hmc_tpu/ops/wilson.py``).

The gradient of the Wilson action shares the plaquette computation with the
forward pass::

    P(t,x)        = u0 - u1 - roll(u0,-1,x) + roll(u1,-1,t)
    S             = sum(1 - cos P)
    dS/du0(t,x)   =  sin P(t,x) - sin P(t,x-1)
    dS/du1(t,x)   = -sin P(t,x) + sin P(t-1,x)

Training differentiates through the force (the leapfrog uses it), so the
force needs a backward too: for a cotangent ``w`` on ``g * dS/dlinks``::

    r      = w0 - roll(w0,-1,x) - w1 + roll(w1,-1,t)
    h      = g cos P r
    dlinks = (h - roll(h,1,x), -h + roll(h,1,t)),   dg = sum(r sin P)

Two forms of one function:

- :class:`WilsonAction`, the plain version: torch ops, ``sin P`` saved, the
  backward built from differentiable ops so that autograd forms the second
  derivative itself; :func:`wilson_force_reference`, the force from the
  links in differentiable torch ops.
- The kernels of ``csrc/wilson.cu`` (the port of the reference's
  ``wilson_action_pallas``): the forward (:func:`wilson_forward`, or
  :func:`wilson_action_only` when no backward will read ``sin P``), the
  backward (:func:`wilson_backward`), the fused force
  (:func:`wilson_force`: plaquette, ``sin P`` and force in one launch) and
  the force's backward (:func:`wilson_double_backward`), wired into autograd
  by :class:`WilsonActionKernel` and :class:`WilsonForceFn`.  Each wrapper
  launches its kernel for CUDA tensors, on the route of :func:`wilson_plan`,
  or raises, and runs its plain version (``*_reference``) for CPU tensors.

:func:`make_potential_fn` sends CUDA states through the kernels and CPU
states through the plain version; its ``force`` attribute gives the
leapfrog's ``d/dx [beta U(x)]`` in one fused launch (the eager counterpart
of what XLA makes of ``jax.grad`` of the action under ``jit``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
from torch.autograd.function import once_differentiable

from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.leapfrog import H100_SMEM_OPTIN, check_cuda_input


def _plaq_sums(u0: torch.Tensor, u1: torch.Tensor) -> torch.Tensor:
    return u0 - u1 - torch.roll(u0, -1, dims=-1) + torch.roll(u1, -1, dims=-2)


def _grad_from_sinp(sinp: torch.Tensor) -> torch.Tensor:
    """Analytic dS/dlinks ``(..., Lt, Lx, 2)`` from the sin-plaquette field."""
    g0 = sinp - torch.roll(sinp, 1, dims=-1)    # sin P(t,x) - sin P(t,x-1)
    g1 = -sinp + torch.roll(sinp, 1, dims=-2)   # -sin P(t,x) + sin P(t-1,x)
    return torch.stack([g0, g1], dim=-1)


def wilson_forward_reference(links):
    """``links (..., Lt, Lx, 2) -> (S (...,), sin P (..., Lt, Lx))``: the
    forward kernel's plain version."""
    p = _plaq_sums(links[..., 0], links[..., 1])
    return torch.sum(1.0 - torch.cos(p), dim=(-2, -1)), torch.sin(p)


def wilson_backward_reference(sinp, g):
    """The force ``g dS/dlinks (..., Lt, Lx, 2)`` from ``sin P`` and
    ``g (...,)``: the backward kernel's plain version."""
    return g[..., None, None, None] * _grad_from_sinp(sinp)


def wilson_double_backward_reference(links, g, w):
    """``(dlinks, dg)``: the backward of the force for its cotangent
    ``w (B, Lt, Lx, 2)``; the double-backward kernel's plain version."""
    p = _plaq_sums(links[..., 0], links[..., 1])
    w0, w1 = w[..., 0], w[..., 1]
    r = w0 - torch.roll(w0, -1, dims=-1) - w1 + torch.roll(w1, -1, dims=-2)
    h = g[:, None, None] * torch.cos(p) * r
    dlinks = torch.stack([h - torch.roll(h, 1, dims=-1),
                          -h + torch.roll(h, 1, dims=-2)], dim=-1)
    return dlinks, torch.sum(r * torch.sin(p), dim=(-2, -1))


def wilson_force_reference(links, g):
    """``g dS/dlinks (B, Lt, Lx, 2)`` from ``links (B, Lt, Lx, 2)`` and ``g
    (B,)`` in differentiable torch ops: the fused force kernel's plain
    version (autograd forms its backward)."""
    return wilson_backward_reference(
        torch.sin(_plaq_sums(links[..., 0], links[..., 1])), g)


class WilsonAction(torch.autograd.Function):
    """``links (..., Lt, Lx, 2) -> (...,)`` total Wilson action per sample."""

    @staticmethod
    def forward(ctx, links):
        action, sinp = wilson_forward_reference(links)
        ctx.save_for_backward(links, sinp)
        return action

    @staticmethod
    def backward(ctx, g):
        links, sinp = ctx.saved_tensors
        if torch.is_grad_enabled():
            # create_graph=True: the saved sin P carries no graph, so
            # recompute it from the links with differentiable ops and the
            # backward itself has a backward (double differentiation)
            sinp = torch.sin(_plaq_sums(links[..., 0], links[..., 1]))
        return wilson_backward_reference(sinp, g)


def wilson_action(links: torch.Tensor) -> torch.Tensor:
    """Total Wilson action per sample with the analytic backward (plain)."""
    return WilsonAction.apply(links)


# ---------------------------------------------------------------------------
# The kernels of csrc/wilson.cu: routes and wrappers (plain versions above)
# ---------------------------------------------------------------------------

WILSON_ROUTES = ("block", "global")
# the kernels in the order of their kind codes in csrc/wilson.cu
WILSON_KINDS = ("forward", "action_only", "force", "backward",
                "double_backward")
WILSON_BLOCK_THREADS = 512
WILSON_STATIC_SMEM = 1024       # bytes kept for the static shared memory
# the plan stages the backward's sin P from this many sites up: measured on
# the H100 with inputs read from device memory (benchmarks/wilson_variants.py)
# the copy is slower at 16x16 and faster at 64x64
WILSON_BWD_STAGE_SITES = 4096


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _block_smem(kind: str, d: int) -> int:
    """Dynamic shared memory of ``kind`` on the block route: the links (2 d
    floats) of the force and the double backward, and one field of d
    floats (sin P, h, or the backward's input)."""
    links = kind in ("force", "double_backward")
    field = links or kind == "backward"
    return 4 * ((_round4(2 * d) if links else 0)
                + (_round4(d) if field else 0))


@functools.lru_cache(maxsize=256)
def wilson_plan(b: int, lt: int, lx: int,
                route: str | None = None) -> SimpleNamespace:
    """How the kernels of ``csrc/wilson.cu`` run ``b`` chains of a ``lt x
    lx`` lattice (the host's plan; the launcher checks it).

    One block per chain, ``threads`` per block (a thread per site up to
    512).  ``route`` concerns the fused force, the double backward and the
    backward: ``'block'`` (the chain's links and one field of ``d`` floats
    in shared memory, the links brought in by a TMA bulk copy) while they
    fit the card's 227 KB, else ``'global'`` (device memory, sin P and h
    recomputed at the neighbours).  ``routes`` gives each kernel's: the
    planned backward takes the block route only from
    ``WILSON_BWD_STAGE_SITES`` sites up, and the forward kinds read device
    memory on either.  A given ``route`` is checked and given to every
    kernel (for measuring one route against another).  ``smem``: dynamic
    shared-memory bytes per block of each kernel (keys of
    ``WILSON_KINDS``)."""
    d = lt * lx
    fits_block = (_block_smem("force", d) + WILSON_STATIC_SMEM
                  <= H100_SMEM_OPTIN)
    routes = dict.fromkeys(WILSON_KINDS, route)
    if route is None:
        route = "block" if fits_block else "global"
        routes = dict.fromkeys(WILSON_KINDS, route)
        if d < WILSON_BWD_STAGE_SITES:
            routes["backward"] = "global"
    elif (route not in WILSON_ROUTES
          or (route == "block" and not fits_block)):
        raise ValueError(f"wilson_plan: route {route!r} cannot run a "
                         f"{lt}x{lx} lattice")
    smem = {kind: _block_smem(kind, d) if r == "block" else 0
            for kind, r in routes.items()}
    return SimpleNamespace(
        route=route, routes=routes, smem=smem,
        threads=min(WILSON_BLOCK_THREADS, 32 * -(-d // 32)))


def _links_dims(links):
    if links.dim() != 4 or links.shape[-1] != 2 or min(links.shape[1:3]) < 2:
        raise ValueError("links: expected shape (B, Lt, Lx, 2) with Lt, Lx "
                         f">= 2, got {tuple(links.shape)}")
    return links.shape[:3]


def _aligned(t):
    """``t`` itself where it starts on 16 bytes (the block route's bulk copy
    needs it), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(entry, kind, b, lt, lx, device, *ptrs):
    route = wilson_plan(b, lt, lx).routes[kind]
    _cuda.check(getattr(_cuda.library(), entry)(
        *ptrs, b, lt, lx, WILSON_ROUTES.index(route), device.index or 0,
        _cuda.stream_handle(device)), entry)


def wilson_forward(links):
    """``(S (B,), sin P (B, Lt, Lx))`` of ``links (B, Lt, Lx, 2)``: the
    forward kernel for a CUDA tensor, the plain version for a CPU one."""
    b, lt, lx = _links_dims(links)
    if not links.is_cuda:
        return wilson_forward_reference(links)
    check_cuda_input("links", links, (b, lt, lx, 2))
    links = _aligned(links)
    action = torch.empty((b,), dtype=torch.float32, device=links.device)
    sinp = torch.empty((b, lt, lx), dtype=torch.float32, device=links.device)
    wilson_forward.launches += 1
    _launch("wilson_fwd_launch", "forward", b, lt, lx, links.device,
            links.data_ptr(), action.data_ptr(), sinp.data_ptr())
    return action, sinp


def wilson_action_only(links):
    """``S (B,)`` of ``links (B, Lt, Lx, 2)`` without ``sin P``: the
    forward kernel's action-only variant for a CUDA tensor, the plain
    version for a CPU one."""
    b, lt, lx = _links_dims(links)
    if not links.is_cuda:
        return wilson_forward_reference(links)[0]
    check_cuda_input("links", links, (b, lt, lx, 2))
    links = _aligned(links)
    action = torch.empty((b,), dtype=torch.float32, device=links.device)
    wilson_action_only.launches += 1
    _launch("wilson_fwd_launch", "action_only", b, lt, lx, links.device,
            links.data_ptr(), action.data_ptr(), None)
    return action


def wilson_backward(sinp, g):
    """The force ``g dS/dlinks (B, Lt, Lx, 2)`` from ``sin P (B, Lt, Lx)``
    and ``g (B,)``: the backward kernel for CUDA tensors."""
    if not sinp.is_cuda:
        return wilson_backward_reference(sinp, g)
    if sinp.dim() != 3:
        raise ValueError("sinp: expected shape (B, Lt, Lx), got "
                         f"{tuple(sinp.shape)}")
    b, lt, lx = sinp.shape
    check_cuda_input("sinp", sinp, (b, lt, lx))
    check_cuda_input("g", g, (b,))
    sinp = _aligned(sinp)
    force = torch.empty((b, lt, lx, 2), dtype=torch.float32,
                        device=sinp.device)
    wilson_backward.launches += 1
    _launch("wilson_bwd_launch", "backward", b, lt, lx, sinp.device,
            sinp.data_ptr(), g.data_ptr(), force.data_ptr())
    return force


def wilson_force(links, g):
    """The force ``g dS/dlinks (B, Lt, Lx, 2)`` from ``links (B, Lt, Lx,
    2)`` and ``g (B,)`` in one launch (``sin P`` stays on chip): the fused
    force kernel for CUDA tensors, :func:`wilson_force_reference` for CPU
    ones."""
    b, lt, lx = _links_dims(links)
    if not links.is_cuda:
        return wilson_force_reference(links, g)
    check_cuda_input("links", links, (b, lt, lx, 2))
    check_cuda_input("g", g, (b,))
    links = _aligned(links)
    force = torch.empty_like(links)
    wilson_force.launches += 1
    _launch("wilson_force_launch", "force", b, lt, lx, links.device,
            links.data_ptr(), g.data_ptr(), force.data_ptr())
    return force


def wilson_double_backward(links, g, w):
    """``(dlinks (B, Lt, Lx, 2), dg (B,))`` for the cotangent ``w`` on the
    force: the double-backward kernel for CUDA tensors."""
    b, lt, lx = _links_dims(links)
    if not links.is_cuda:
        return wilson_double_backward_reference(links, g, w)
    check_cuda_input("links", links, (b, lt, lx, 2))
    check_cuda_input("g", g, (b,))
    check_cuda_input("w", w, (b, lt, lx, 2))
    links, w = _aligned(links), _aligned(w)
    dlinks = torch.empty_like(links)
    dg = torch.empty((b,), dtype=torch.float32, device=links.device)
    wilson_double_backward.launches += 1
    _launch("wilson_bwd_bwd_launch", "double_backward", b, lt, lx,
            links.device, links.data_ptr(), g.data_ptr(), w.data_ptr(),
            dlinks.data_ptr(), dg.data_ptr())
    return dlinks, dg


wilson_forward.launches = 0
wilson_action_only.launches = 0
wilson_backward.launches = 0
wilson_force.launches = 0
wilson_double_backward.launches = 0


class WilsonForceKernel(torch.autograd.Function):
    """``(links, sinp, g) -> g dS/dlinks``; differentiable in ``links`` and
    ``g`` through :func:`wilson_double_backward` (``sinp`` is the forward's
    residual, a function of ``links`` that the double backward accounts
    for)."""

    @staticmethod
    def forward(ctx, links, sinp, g):
        ctx.save_for_backward(links, g)
        return wilson_backward(sinp, g)

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        links, g = ctx.saved_tensors
        dlinks, dg = wilson_double_backward(links, g, w.contiguous())
        return dlinks, None, dg


class WilsonForceFn(torch.autograd.Function):
    """``(links, g) -> g dS/dlinks`` on the fused force kernel; its backward
    is :func:`wilson_double_backward`, the backward of the force in
    ``links`` and ``g``."""

    @staticmethod
    def forward(ctx, links, g):
        ctx.save_for_backward(links, g)
        return wilson_force(links, g)

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        links, g = ctx.saved_tensors
        return wilson_double_backward(links, g, w.contiguous())


class WilsonActionKernel(torch.autograd.Function):
    """``links (B, Lt, Lx, 2) -> (B,)`` on the kernels of ``csrc/wilson.cu``;
    its backward is :class:`WilsonForceKernel`, so a ``create_graph=True``
    gradient records the force and a later backward reaches the
    Hessian-vector product.  Where no gradient can reach the links, the
    action-only kernel runs (no ``sin P`` written)."""

    @staticmethod
    def forward(ctx, links):
        if not ctx.needs_input_grad[0]:
            return wilson_action_only(links)
        action, sinp = wilson_forward(links)
        ctx.save_for_backward(links, sinp)
        return action

    @staticmethod
    def backward(ctx, g):
        links, sinp = ctx.saved_tensors
        return WilsonForceKernel.apply(links, sinp, g.contiguous())


def wilson_action_kernel(links: torch.Tensor) -> torch.Tensor:
    """Total Wilson action per sample on the kernel path; ``links (...,
    Lt, Lx, 2)`` with any leading dims."""
    lead = links.shape[:-3]
    flat = links.reshape(-1, *links.shape[-3:]).contiguous()
    return WilsonActionKernel.apply(flat).reshape(lead)


def _per_chain(beta, n, like):
    """``beta`` (a number, or a tensor that broadcasts to the ``n`` chains)
    as an ``(n,)`` tensor of ``like``'s type and device; differentiable in a
    tensor ``beta``."""
    if not isinstance(beta, torch.Tensor):
        return torch.full((n,), float(beta), dtype=like.dtype,
                          device=like.device)
    return torch.broadcast_to(beta.to(like.dtype), (n,)).contiguous()


def make_potential_fn(shape):
    """Flat-state potential ``U(x) -> per-sample S``: CUDA states go through
    the kernels of ``csrc/wilson.cu``, CPU states through the plain
    :class:`WilsonAction`.

    Its ``force(x, beta)`` is ``d/dx [beta U(x)] (B, x_dim)`` for ``x (B,
    x_dim)``: the fused force kernel (:class:`WilsonForceFn`) for CUDA
    states, :func:`wilson_force_reference` for CPU ones; differentiable in
    ``x`` and in a tensor ``beta``."""

    def potential(x: torch.Tensor) -> torch.Tensor:
        links = x.reshape(*x.shape[:-1], *shape.links_shape)
        if links.is_cuda:
            return wilson_action_kernel(links)
        return wilson_action(links)

    def force(x: torch.Tensor, beta) -> torch.Tensor:
        links = x.reshape(-1, *shape.links_shape)
        g = _per_chain(beta, links.shape[0], x)
        if links.is_cuda:
            f = WilsonForceFn.apply(links.contiguous(), g)
        else:
            f = wilson_force_reference(links, g)
        return f.reshape(x.shape)

    potential.force = force
    return potential


# ---------------------------------------------------------------------------
# The slab route: one 'space' rank's time rows (parallel/spatial.py)
# ---------------------------------------------------------------------------
#
# A slab of ``n`` owned time rows comes extended by one halo row on each
# side, ``ext (B, E, Lx, 2)`` with ``E = n + 2``: row 0 is the previous
# slab's last row, row ``E-1`` the next slab's first (only its u1 is read).
# The time axis is open.  The slab's action sums the owned plaquette rows
# ``1..E-2``; its force is complete on the owned links (the plaquette row 0,
# P(t0-1), is in the extended slab); its backward and double backward give
# gradients on every row of the extended slab, which the halo exchange's
# backward adds into their owners' rows.


def _slab_plaq(ext):
    """``P (B, E-1, Lx)`` of the plaquette rows ``0..E-2`` of an extended
    slab, in :func:`_plaq_sums`'s order."""
    u0, u1 = ext[..., 0], ext[..., 1]
    a0 = u0[:, :-1]
    return a0 - u1[:, :-1] - torch.roll(a0, -1, dims=-1) + u1[:, 1:]


def _open_t_grad(field):
    """``(f - f(t, s-1), -f + f(t-1, s))`` of ``field (B, E, Lx)`` with
    ``f(-1, .) = 0``: the open-t form of :func:`_grad_from_sinp`."""
    up = torch.cat([torch.zeros_like(field[:, :1]), field[:, :-1]], dim=1)
    return torch.stack([field - torch.roll(field, 1, dims=-1), -field + up],
                       dim=-1)


def wilson_slab_forward_reference(ext):
    """``(S (B,), sin P (B, E, Lx))`` of an extended slab: the owned
    plaquette rows' action and their sines, zero on rows 0 and E-1."""
    p = _slab_plaq(ext)[:, 1:]
    sinp = torch.nn.functional.pad(torch.sin(p), (0, 0, 1, 1))
    return torch.sum(1.0 - torch.cos(p), dim=(-2, -1)), sinp


def wilson_slab_backward_reference(sinp, g):
    """``g`` times the open-t backward of ``sin P (B, E, Lx)``: the slab
    action's gradient on every row of the extended slab."""
    return g[:, None, None, None] * _open_t_grad(sinp)


def wilson_slab_force_reference(ext, g):
    """The force ``g dS/dlinks`` on the owned links ``(B, E-2, Lx, 2)`` of
    an extended slab, complete (the plaquette row 0 included), in
    differentiable torch ops."""
    s = torch.sin(_slab_plaq(ext))
    own, below = s[:, 1:], s[:, :-1]
    f = torch.stack([own - torch.roll(own, 1, dims=-1), -own + below],
                    dim=-1)
    return g[:, None, None, None] * f


def wilson_slab_double_backward_reference(ext, g, w, p_lo: int, w_off: int):
    """``(dext (B, E, Lx, 2), dg (B,))`` for the cotangent ``w`` on rows
    ``[w_off, w_off + len(w))`` of the extended slab (zero elsewhere),
    with the plaquette rows ``p_lo..E-2``: the force's backward is
    ``(p_lo, w_off) = (0, 1)``, the action backward's ``(1, 0)``."""
    e = ext.shape[1]
    w = torch.nn.functional.pad(
        w, (0, 0, 0, 0, w_off, e - w_off - w.shape[1]))
    w0, w1 = w[..., 0], w[..., 1]
    a0 = w0[:, :-1]
    r = (a0 - torch.roll(a0, -1, dims=-1) - w1[:, :-1] + w1[:, 1:])[:, p_lo:]
    p = _slab_plaq(ext)[:, p_lo:]
    h = g[:, None, None] * torch.cos(p) * r
    dext = _open_t_grad(torch.nn.functional.pad(h, (0, 0, p_lo, 1)))
    return dext, torch.sum(r * torch.sin(p), dim=(-2, -1))


def _slab_dims(ext):
    if ext.dim() != 4 or ext.shape[-1] != 2 or ext.shape[1] < 3 \
            or ext.shape[2] < 2:
        raise ValueError("ext: expected an extended slab (B, E, Lx, 2) with "
                         f"E >= 3, Lx >= 2, got {tuple(ext.shape)}")
    return ext.shape[:3]


def _slab_launch(entry, device, *args):
    _cuda.check(getattr(_cuda.library(), entry)(
        *args, device.index or 0, _cuda.stream_handle(device)), entry)


def wilson_slab_forward(ext):
    """``(S (B,), sin P (B, E, Lx))`` of an extended slab: the slab route's
    forward kernel for a CUDA tensor, the plain version for a CPU one."""
    b, e, lx = _slab_dims(ext)
    if not ext.is_cuda:
        return wilson_slab_forward_reference(ext)
    check_cuda_input("ext", ext, (b, e, lx, 2))
    action = torch.empty((b,), dtype=torch.float32, device=ext.device)
    sinp = torch.empty((b, e, lx), dtype=torch.float32, device=ext.device)
    wilson_slab_forward.launches += 1
    _slab_launch("wilson_slab_fwd_launch", ext.device, ext.data_ptr(),
                 action.data_ptr(), sinp.data_ptr(), b, e, lx)
    return action, sinp


def wilson_slab_action_only(ext):
    """``S (B,)`` of an extended slab without ``sin P``: the slab route's
    action-only kernel for a CUDA tensor, the plain version for a CPU
    one."""
    b, e, lx = _slab_dims(ext)
    if not ext.is_cuda:
        return wilson_slab_forward_reference(ext)[0]
    check_cuda_input("ext", ext, (b, e, lx, 2))
    action = torch.empty((b,), dtype=torch.float32, device=ext.device)
    wilson_slab_action_only.launches += 1
    _slab_launch("wilson_slab_fwd_launch", ext.device, ext.data_ptr(),
                 action.data_ptr(), None, b, e, lx)
    return action


def wilson_slab_backward(sinp, g):
    """The slab action's gradient ``(B, E, Lx, 2)`` from ``sin P (B, E,
    Lx)`` and ``g (B,)``: the slab route's backward kernel for CUDA
    tensors."""
    if not sinp.is_cuda:
        return wilson_slab_backward_reference(sinp, g)
    if sinp.dim() != 3:
        raise ValueError("sinp: expected shape (B, E, Lx), got "
                         f"{tuple(sinp.shape)}")
    b, e, lx = sinp.shape
    check_cuda_input("sinp", sinp, (b, e, lx))
    check_cuda_input("g", g, (b,))
    out = torch.empty((b, e, lx, 2), dtype=torch.float32, device=sinp.device)
    wilson_slab_backward.launches += 1
    _slab_launch("wilson_slab_bwd_launch", sinp.device, sinp.data_ptr(),
                 g.data_ptr(), out.data_ptr(), b, e, lx)
    return out


def wilson_slab_force(ext, g):
    """The complete force on the owned links ``(B, E-2, Lx, 2)`` of an
    extended slab: the slab route's force kernel for CUDA tensors,
    :func:`wilson_slab_force_reference` for CPU ones."""
    b, e, lx = _slab_dims(ext)
    if not ext.is_cuda:
        return wilson_slab_force_reference(ext, g)
    check_cuda_input("ext", ext, (b, e, lx, 2))
    check_cuda_input("g", g, (b,))
    force = torch.empty((b, e - 2, lx, 2), dtype=torch.float32,
                        device=ext.device)
    wilson_slab_force.launches += 1
    _slab_launch("wilson_slab_force_launch", ext.device, ext.data_ptr(),
                 g.data_ptr(), force.data_ptr(), b, e, lx)
    return force


def wilson_slab_double_backward(ext, g, w, p_lo: int, w_off: int):
    """``(dext (B, E, Lx, 2), dg (B,))`` for the cotangent ``w`` (see
    :func:`wilson_slab_double_backward_reference`): the slab route's
    double-backward kernel for CUDA tensors."""
    b, e, lx = _slab_dims(ext)
    if not ext.is_cuda:
        return wilson_slab_double_backward_reference(ext, g, w, p_lo, w_off)
    check_cuda_input("ext", ext, (b, e, lx, 2))
    check_cuda_input("g", g, (b,))
    check_cuda_input("w", w, (b, w.shape[1], lx, 2))
    dext = torch.empty_like(ext)
    dg = torch.empty((b,), dtype=torch.float32, device=ext.device)
    wilson_slab_double_backward.launches += 1
    _slab_launch("wilson_slab_bwd_bwd_launch", ext.device, ext.data_ptr(),
                 g.data_ptr(), w.data_ptr(), dext.data_ptr(), dg.data_ptr(),
                 b, e, lx, p_lo, w_off, w.shape[1])
    return dext, dg


wilson_slab_forward.launches = 0
wilson_slab_action_only.launches = 0
wilson_slab_backward.launches = 0
wilson_slab_force.launches = 0
wilson_slab_double_backward.launches = 0


class WilsonSlabForceKernel(torch.autograd.Function):
    """``(ext, sinp, g) ->`` the slab action's gradient on the extended
    slab; differentiable in ``ext`` and ``g`` through the slab double
    backward (``sinp`` is the forward's residual)."""

    @staticmethod
    def forward(ctx, ext, sinp, g):
        ctx.save_for_backward(ext, g)
        return wilson_slab_backward(sinp, g)

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        ext, g = ctx.saved_tensors
        dext, dg = wilson_slab_double_backward(ext, g, w.contiguous(), 1, 0)
        return dext, None, dg


class WilsonSlabAction(torch.autograd.Function):
    """``ext (B, E, Lx, 2) -> (B,)``, the owned plaquette rows' action on
    the slab route; its backward is :class:`WilsonSlabForceKernel`.  Where
    no gradient can reach the links, the action-only kernel runs."""

    @staticmethod
    def forward(ctx, ext):
        if not ctx.needs_input_grad[0]:
            return wilson_slab_action_only(ext)
        action, sinp = wilson_slab_forward(ext)
        ctx.save_for_backward(ext, sinp)
        return action

    @staticmethod
    def backward(ctx, g):
        ext, sinp = ctx.saved_tensors
        return WilsonSlabForceKernel.apply(ext, sinp, g.contiguous())


class WilsonSlabForceFn(torch.autograd.Function):
    """``(ext, g) ->`` the complete force on the owned links, on the slab
    route's force kernel; its backward is the slab double backward, whose
    gradient on the halo rows the halo exchange routes to their owners."""

    @staticmethod
    def forward(ctx, ext, g):
        ctx.save_for_backward(ext, g)
        return wilson_slab_force(ext, g)

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        ext, g = ctx.saved_tensors
        return wilson_slab_double_backward(ext, g, w.contiguous(), 0, 1)


def _slab_rows(lt: int, n: int, c: int, device):
    k = lt // n
    return (torch.arange(-1, k + 1, device=device) + c * k) % lt


def cut_slabs(links: torch.Tensor, n: int):
    """The ``n`` extended slabs ``(B, Lt/n + 2, Lx, 2)`` of ``links (B, Lt,
    Lx, 2)`` on one device, each with its halo rows cut from the
    neighbouring slabs (periodic): what the halo exchange hands each
    'space' rank.  For checking the slab route against the whole lattice."""
    lt = links.shape[1]
    return [links[:, _slab_rows(lt, n, c, links.device)].contiguous()
            for c in range(n)]


def join_slab_grads(grads, lt: int) -> torch.Tensor:
    """Gradients on the extended slabs of :func:`cut_slabs` added into the
    rows they came from, ``(B, Lt, Lx, 2)``: what the halo exchange's
    backward does across ranks."""
    n = len(grads)
    out = torch.zeros((grads[0].shape[0], lt, *grads[0].shape[2:]),
                      dtype=grads[0].dtype, device=grads[0].device)
    for c, g in enumerate(grads):
        out.index_add_(1, _slab_rows(lt, n, c, g.device), g)
    return out


def make_slab_potential_fn(shape, sharding, plain: bool = False):
    """The flat-slab potential of a lattice split over 'space'
    (``parallel/spatial.py``): ``U(x_slab) -> (B,)`` the WHOLE lattice's
    action per chain (the owned rows' sums added over 'space') for this
    rank's columns ``x_slab (B, x_dim / n)``; its ``force(x_slab, beta)``
    is ``d/dx [beta U]`` on the owned links, complete, from one forward
    halo of one row each side.  Both differentiable: the slab route's
    kernels for CUDA states (:class:`WilsonSlabAction`,
    :class:`WilsonSlabForceFn`), their plain versions for CPU ones;
    ``plain=True``: the plain versions on any device, differentiated by
    autograd (the yardstick on the card)."""
    sharding.check_shape(shape)
    sp, lx = sharding, shape.space_size

    def ext_of(x):
        links = x.reshape(x.shape[0], sp.lt_blk, lx, 2)
        return sp.halo(links, 1, 1, 1).contiguous()

    def potential(x: torch.Tensor) -> torch.Tensor:
        ext = ext_of(x)
        local = (wilson_slab_forward_reference(ext)[0] if plain
                 else WilsonSlabAction.apply(ext))
        return sp.space_sum(local)

    def force(x: torch.Tensor, beta) -> torch.Tensor:
        ext = ext_of(x)
        g = sp.enter(_per_chain(beta, x.shape[0], x))
        f = (wilson_slab_force_reference(ext, g) if plain
             else WilsonSlabForceFn.apply(ext, g))
        return f.reshape(x.shape)

    potential.force = force
    return potential


def make_plain_potential_fn(shape):
    """Flat-state potential on the plain :class:`WilsonAction` for any
    device (the yardstick the kernels are held against on the card); it has
    no ``force``, so the dynamics differentiate it by autograd."""

    def potential(x: torch.Tensor) -> torch.Tensor:
        return wilson_action(x.reshape(*x.shape[:-1], *shape.links_shape))

    return potential
