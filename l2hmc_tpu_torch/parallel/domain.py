"""Lattice-domain decomposition: the time axis sharded over 'space' (port
of ``l2hmc_tpu/parallel/domain.py``).

Each 'space' rank holds ``Lt / n`` time rows of every chain's links.
Inside a shard the plaquette rows ``0..n-2`` are local; the last row needs
``u1``'s first row from the NEXT shard (``roll(u1, -1, t)`` wraps across
the boundary), so the forward pass sends one ``(B, Lx)`` row around the
ring, and the analytic backward sends one ``sin P`` row the other way.
The per-chain sums are all-reduced over 'space'.

The halos go by ``torch.distributed.batch_isend_irecv`` on the 'space'
group; a 'space' axis of one rank wraps locally (NCCL does not send to its
own rank).  Plain tensor code, as JAX's is: its domain action reaches no
Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from l2hmc_tpu_torch.lattice import u1 as u1mod
from l2hmc_tpu_torch.parallel.mesh import Mesh


def _exchange(row: torch.Tensor, mesh: Mesh, axis: str,
              offset: int) -> torch.Tensor:
    """The ``row`` of the rank ``offset`` steps along ``axis`` (periodic);
    this rank's own row goes to the rank ``-offset`` steps away."""
    if mesh.size(axis) == 1 or mesh.groups[axis] is None:
        return row
    row = row.contiguous()
    out = torch.empty_like(row)
    group = mesh.groups[axis]
    ops = [dist.P2POp(dist.isend, row, mesh.peer(axis, -offset), group),
           dist.P2POp(dist.irecv, out, mesh.peer(axis, offset), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _local_plaq_sums(blk: torch.Tensor, mesh: Mesh, axis: str):
    """Plaquette angles of a time shard ``(B, lt_blk, Lx, 2)``; the
    ``t+1`` of the last local row lives on the next shard."""
    u0, u1_ = blk[..., 0], blk[..., 1]
    halo = _exchange(u1_[:, :1], mesh, axis, +1)
    u1_tp = torch.cat([u1_[:, 1:], halo], dim=1)
    return u0 - u1_ - torch.roll(u0, -1, dims=-1) + u1_tp


def make_domain_action(mesh: Mesh, shape: u1mod.LatticeShape,
                       axis_name: str = "space"):
    """Sharded action and observables over ``mesh``'s ``axis_name``.

    Returns a dict: ``action(links_blk) -> (B,)`` the global per-chain
    Wilson action of the time shards ``links_blk (B, Lt/n, Lx, 2)``, with
    the analytic backward (one reverse halo); ``observables(links_blk)``
    (actions, plaqs, rounded charges, each ``(B,)``); ``links_spec`` (the
    reference's partition of ``(B, Lt, Lx, 2)``); ``sharding(links)``, this
    rank's time slice of global links."""
    n = mesh.size(axis_name)
    if shape.time_size % n:
        raise ValueError(f"Lt={shape.time_size} not divisible by mesh axis "
                         f"{axis_name}={n}")
    lt_blk = shape.time_size // n
    group_sum = (lambda t: mesh.all_reduce(t, axis_name, "sum"))

    class DomainAction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, blk):
            p = _local_plaq_sums(blk, mesh, axis_name)
            ctx.save_for_backward(torch.sin(p))
            return group_sum(torch.sum(1.0 - torch.cos(p), dim=(-2, -1)))

        @staticmethod
        def backward(ctx, g):
            (sinp,) = ctx.saved_tensors
            # dS/du0(t,x) = sin P(t,x) - sin P(t,x-1)      (x local)
            g0 = sinp - torch.roll(sinp, 1, dims=-1)
            # dS/du1(t,x) = -sin P(t,x) + sin P(t-1,x)     (t-1 crosses)
            halo = _exchange(sinp[:, -1:], mesh, axis_name, -1)
            g1 = -sinp + torch.cat([halo, sinp[:, :-1]], dim=1)
            return g[:, None, None, None] * torch.stack([g0, g1], dim=-1)

    def action(blk: torch.Tensor) -> torch.Tensor:
        return DomainAction.apply(blk)

    def observables(blk: torch.Tensor):
        with torch.no_grad():
            p = _local_plaq_sums(blk, mesh, axis_name)
            cosp = torch.cos(p)
            sums = group_sum(torch.stack([
                torch.sum(1.0 - cosp, dim=(-2, -1)),
                torch.sum(cosp, dim=(-2, -1)),
                torch.sum(u1mod.project_angle(p), dim=(-2, -1))]))
        return {"actions": sums[0],
                "plaqs": sums[1] / shape.num_plaquettes,
                "charges": torch.round(sums[2] / (2 * np.pi))}

    def sharding(links: torch.Tensor) -> torch.Tensor:
        c = mesh.coords[axis_name]
        return links[:, c * lt_blk:(c + 1) * lt_blk]

    return {"action": action, "observables": observables,
            "links_spec": (None, axis_name, None, None),
            "sharding": sharding}
