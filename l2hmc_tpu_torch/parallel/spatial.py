"""dp x sp of the full transition: the lattice's time rows split over the
mesh's 'space' axis, chains over 'data' (the port of the reference's
``lattice_sharding``, ``l2hmc_tpu/parallel/mesh.py``).

In JAX one ``NamedSharding(mesh, P("data", "space"))`` on the flat state is
enough: GSPMD inserts the conv halos and the per-chain psums.  Here it is
hand-written tensor parallelism.  A flat state ``x (B, x_dim)`` has the
layout ``(Lt, Lx, 2)``, so the contiguous column slab of 'space' rank ``c``
of ``n`` is the time rows ``[c Lt/n, (c+1) Lt/n)`` of every chain, the
partition of ``parallel/domain.py``.  Every function of the path computes
on this rank's slab and meets the others through three autograd-aware
collectives:

- :meth:`LatticeSharding.halo`, the neighbours' rows around the slab
  (depth ``(before, after)``); its backward sends each halo row's
  cotangent back to the row's owner, which adds it;
- :meth:`LatticeSharding.space_sum`, the sum over 'space' of a per-chain
  partial sum (forward all-reduce, backward identity: what follows it is
  replicated over 'space');
- :meth:`LatticeSharding.enter`, its mirror where a replicated tensor (a
  parameter, a hidden layer) enters the slab's computation (forward
  identity, backward all-reduce).

Each is the other's backward, so the path is differentiable twice (the
improved action's autograd force inside a differentiated trajectory).
With these, every parameter's gradient comes out whole on every 'space'
rank; without the last two a replicated layer's gradient would count
``n`` times, or one rank's share only.  Collectives run in program order,
the same on every rank of a 'space' line (``torch.utils.checkpoint``
recomputations included).  A 'space' axis of one rank runs the same code:
its halos wrap locally, as ``domain._exchange`` does.
"""

from __future__ import annotations

import torch

from l2hmc_tpu_torch.parallel.domain import _exchange
from l2hmc_tpu_torch.parallel.mesh import Mesh, shard_chains
from l2hmc_tpu_torch.utils import trace

AXIS = "space"


# spans (utils/trace.py) around each collective, on the profiler's timeline
# (their host time; the NCCL kernels carry the device time):
# benchmarks/space_scaling.py reads them
HALO_RANGE = "lattice_sharding.halo"
SUM_RANGE = "lattice_sharding.space_sum"


def _halo(t, sp, dim, before, after):
    with trace.span(HALO_RANGE):
        return _halo_parts(t, sp, dim, before, after)


def _halo_parts(t, sp, dim, before, after):
    lt = t.shape[dim]
    parts = []
    if before:
        parts.append(_exchange(t.narrow(dim, lt - before, before), sp.mesh,
                               AXIS, -1))
    parts.append(t)
    if after:
        parts.append(_exchange(t.narrow(dim, 0, after), sp.mesh, AXIS, +1))
    return torch.cat(parts, dim)


def _halo_transpose(g, sp, dim, before, after):
    with trace.span(HALO_RANGE):
        return _halo_transpose_parts(g, sp, dim, before, after)


def _halo_transpose_parts(g, sp, dim, before, after):
    lt = g.shape[dim] - before - after
    out = g.narrow(dim, before, lt).clone()
    if before:
        got = _exchange(g.narrow(dim, 0, before), sp.mesh, AXIS, +1)
        out.narrow(dim, lt - before, before).add_(got)
    if after:
        got = _exchange(g.narrow(dim, before + lt, after), sp.mesh, AXIS, -1)
        out.narrow(dim, 0, after).add_(got)
    return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sp, dim, before, after):
        ctx.args = (sp, dim, before, after)
        return _halo(t, sp, dim, before, after)

    @staticmethod
    def backward(ctx, g):
        return (_HaloTranspose.apply(g.contiguous(), *ctx.args),
                None, None, None, None)


class _HaloTranspose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, sp, dim, before, after):
        ctx.args = (sp, dim, before, after)
        return _halo_transpose(g, sp, dim, before, after)

    @staticmethod
    def backward(ctx, gg):
        return (_Halo.apply(gg.contiguous(), *ctx.args),
                None, None, None, None)


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sp):
        ctx.sp = sp
        with trace.span(SUM_RANGE):
            return sp.mesh.all_reduce(t, AXIS, "sum")

    @staticmethod
    def backward(ctx, g):
        return _Enter.apply(g, ctx.sp), None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sp):
        ctx.sp = sp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _SpaceSum.apply(g, ctx.sp), None


class LatticeSharding:
    """Chains over 'data' and the time rows of the lattice ``shape``
    (``u1.LatticeShape``) over 'space' of ``mesh``: the slab of this rank
    and the collectives that join the slabs.  Raises ``ValueError`` where
    the time rows do not split evenly.

    Attributes: ``t0`` (the slab's first global time row), ``lt_blk`` (its
    rows), ``cols`` (its columns of a flat ``(B, x_dim)`` state),
    ``x_dim`` (their number)."""

    def __init__(self, mesh: Mesh, shape):
        lt, lx = shape.time_size, shape.space_size
        self.mesh = mesh
        self.n = mesh.size(AXIS)
        self.coord = mesh.coords[AXIS]
        if lt % self.n:
            raise ValueError(f"lattice_sharding: Lt={lt} time rows do not "
                             f"split over the 'space' axis of {self.n}")
        self.shape = shape
        self._index = {}
        self.lt_blk = lt // self.n
        self.t0 = self.coord * self.lt_blk
        self.lx = lx
        self.x_dim = self.lt_blk * lx * 2
        self.cols = slice(self.t0 * lx * 2, self.t0 * lx * 2 + self.x_dim)

    def check_shape(self, shape):
        """Raise ``ValueError`` unless ``shape`` is the sharded lattice."""
        if (self.shape.time_size, self.shape.space_size) != (
                shape.time_size, shape.space_size):
            raise ValueError(f"lattice_sharding of {self.shape}, not of "
                             f"{shape}")

    def check_stride(self, stride: int):
        """Raise ``ValueError`` unless a stride-``stride`` conv's windows
        start on the slab's first row (``lt_blk % stride == 0``)."""
        if self.lt_blk % stride:
            raise ValueError(
                f"lattice_sharding: slabs of {self.lt_blk} time rows do not "
                f"hold whole windows of a stride-{stride} conv")

    # -- placement -------------------------------------------------------

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a global batch: ``x (B, x_dim)`` -> ``(B /
        n_data, x_dim / n_space)``, links ``(B, Lt, Lx, 2)`` -> ``(B /
        n_data, lt_blk, Lx, 2)``."""
        x = shard_chains(x, self.mesh)
        if x.dim() == 4:
            return x[:, self.t0:self.t0 + self.lt_blk].contiguous()
        return x[:, self.cols].contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch from every rank's part (collective): the
        inverse of :meth:`shard`, flat or links."""
        links = x.dim() == 4
        flat = x.reshape(x.shape[0], -1)
        whole = self.mesh.all_gather(flat.T.contiguous(), AXIS).T
        whole = self.mesh.all_gather(whole.contiguous(), "data")
        if links:
            return whole.reshape(whole.shape[0], -1, *x.shape[2:])
        return whole

    def field_index(self, copies: int, device) -> torch.Tensor:
        """Indices of the slab's columns in ``copies`` side-by-side copies
        of a flat field (``[cos | sin]`` features: 2; the heads' ``[S | T
        | Q]``: 3), as a ``(copies x_dim / n,)`` int64 tensor on
        ``device``."""
        key = (copies, str(device))
        if key not in self._index:
            d = self.shape.x_dim
            self._index[key] = torch.cat([
                torch.arange(j * d + self.cols.start, j * d + self.cols.stop,
                             device=device) for j in range(copies)])
        return self._index[key]

    def columns(self, t: torch.Tensor) -> torch.Tensor:
        """The slab's columns of ``t (..., x_dim)`` (a global draw, the
        masks, a field over every link)."""
        return t[..., self.cols]

    # -- collectives -----------------------------------------------------

    def halo(self, t: torch.Tensor, dim: int, before: int,
             after: int) -> torch.Tensor:
        """``t`` extended along its time-row axis ``dim`` by the previous
        rank's last ``before`` rows and the next rank's first ``after``
        (periodic; one rank wraps its own); differentiable."""
        dim = dim % t.dim()
        if max(before, after) > t.shape[dim]:
            raise ValueError(f"lattice_sharding: a halo of {before, after} "
                             f"rows needs slabs of at least that many rows, "
                             f"not {t.shape[dim]}")
        return _Halo.apply(t.contiguous(), self, dim, before, after)

    def space_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Per-chain partial sums added over 'space'; differentiable, the
        result replicated."""
        return t if self.n == 1 else _SpaceSum.apply(t, self)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated ``t`` used on the slab: the identity, whose
        backward adds the ranks' cotangents."""
        return t if self.n == 1 else _Enter.apply(t, self)

    def all_chains(self, ok: torch.Tensor) -> torch.Tensor:
        """``ok (B,)`` (bool) true on every slab."""
        if self.n == 1:
            return ok
        bad = self.mesh.all_reduce((~ok).to(torch.float32), AXIS, "sum")
        return bad == 0
