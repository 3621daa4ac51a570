"""The process mesh and the chain sharding (port of
``l2hmc_tpu/parallel/mesh.py``).

JAX shards declaratively: one global program over a ``Mesh`` whose 'data'
axis splits the chain batch, and XLA inserts the collectives.  PyTorch has
no sharding annotations, so here a mesh is a set of process groups and the
shardings are operations on tensors: :func:`shard_chains` takes this rank's
slice of a global batch, :func:`gather_chains` puts the slices back
together, :func:`replicate` broadcasts from rank 0.  A step that runs on
the slices then all-reduces what JAX's global program would have reduced
(``train/gauge.py``, ``dynamics/smc.py``).

Axes, as in JAX:

- ``data``  : independent Markov chains (gradients mean-reduced over it);
- ``space`` : the lattice's time axis: the domain action
  (``parallel/domain.py``) and the full transition under
  :func:`lattice_sharding` (``parallel/spatial.py``).

Rank ``r`` sits at ``(r // num_space, r % num_space)``: 'space' innermost,
as the reference reshapes its device list.  Without an initialized process
group a mesh has one rank and every collective is the identity.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from l2hmc_tpu_torch._device import local_rank, resolve_device
from l2hmc_tpu_torch.utils import trace

AXES = ("data", "space")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass
class Mesh:
    """A ``(data, space)`` grid of ranks: each axis's size, this rank's
    coordinates, and the process group of this rank's line along each axis
    (``None`` without a process group)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]
    ranks: Dict[str, List[int]]
    device: torch.device
    axis_names: tuple = AXES

    def size(self, axis: str) -> int:
        return self.shape[axis]

    @property
    def world(self) -> int:
        return self.shape["data"] * self.shape["space"]

    def all_reduce(self, t: torch.Tensor, axis: str = "data",
                   op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op='sum'``) or averaged (``'mean'``) over
        ``axis``, a new tensor; the identity where the axis has no
        group."""
        group = self.groups[axis]
        if group is None:
            return t
        with trace.span("mesh.all_reduce"):
            out = t.detach().clone().contiguous()
            dist.all_reduce(out, group=group)
        return out / self.shape[axis] if op == "mean" else out

    def all_gather(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The ``axis``-line's tensors concatenated on dim 0 in coordinate
        order (every rank's ``t`` of one shape)."""
        group = self.groups[axis]
        if group is None:
            return t
        with trace.span("mesh.all_gather"):
            parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts, dim=0)

    def barrier(self):
        if _initialized():
            dist.barrier()

    def peer(self, axis: str, offset: int) -> int:
        """Global rank of the neighbour ``offset`` steps along ``axis``
        (periodic)."""
        line = self.ranks[axis]
        return line[(self.coords[axis] + offset) % len(line)]


def initialize_distributed(device=None) -> bool:
    """Launcher bring-up (the reference's ``jax.distributed.initialize()``;
    ``hvd.init()`` in the original): reads ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
    and initializes the default process group, NCCL for the card and gloo
    for ``device="cpu"``.  A no-op, returning ``False``, when ``WORLD_SIZE``
    is unset or the group exists already."""
    if "WORLD_SIZE" not in os.environ or _initialized():
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True


def is_primary() -> bool:
    """Rank-0 gate for IO (``utils.io.is_primary``)."""
    from l2hmc_tpu_torch.utils.io import is_primary as primary

    return primary()


def get_mesh(num_data: Optional[int] = None, num_space: int = 1,
             device=None) -> Mesh:
    """The ``(data, space)`` mesh over every rank of the process group
    (one rank without a group), its tensors on ``device`` (``None``: this
    rank's card).  ``num_data`` defaults to the world size
    over ``num_space``; ``num_data * num_space`` must be the world size.
    Collective: every rank calls it, in the same order."""
    world = dist.get_world_size() if _initialized() else 1
    rank = dist.get_rank() if _initialized() else 0
    if num_data is None:
        num_data = world // num_space
    if num_data * num_space != world:
        raise ValueError(f"mesh {num_data}x{num_space} does not cover the "
                         f"{world} ranks of the process group")
    coords = {"data": rank // num_space, "space": rank % num_space}
    lines = {
        "data": [[d * num_space + s for d in range(num_data)]
                 for s in range(num_space)],
        "space": [[d * num_space + s for s in range(num_space)]
                  for d in range(num_data)],
    }
    groups: Dict[str, Optional[object]] = {"data": None, "space": None}
    ranks = {"data": lines["data"][coords["space"]],
             "space": lines["space"][coords["data"]]}
    if _initialized():
        # every rank creates every group, in one order (new_group is
        # collective over the world)
        for axis in AXES:
            for line in lines[axis]:
                g = dist.new_group(line)
                if rank in line:
                    groups[axis] = g
    return Mesh(shape={"data": num_data, "space": num_space}, coords=coords,
                groups=groups, ranks=ranks, device=resolve_device(device))


def _data_slice(n: int, mesh: Mesh) -> slice:
    k = mesh.size("data")
    if n % k:
        raise ValueError(f"{n} chains do not split over the mesh's 'data' "
                         f"axis of {k}")
    per = n // k
    c = mesh.coords["data"]
    return slice(c * per, (c + 1) * per)


def shard_chains(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's contiguous slice of a global chain batch ``x (B, ...)``
    (the reference's ``chain_sharding``); ``B`` must divide by the 'data'
    axis.  ``mesh=None`` keeps ``x``."""
    if mesh is None:
        return x
    return x[_data_slice(x.shape[0], mesh)]


def gather_chains(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global chain batch from every 'data' rank's slice (collective)."""
    return x if mesh is None else mesh.all_gather(x, "data")


def replicate(tree, mesh: Optional[Mesh]):
    """Broadcast a tree (tensor, ``nn.Module``, dict, list or tuple of them)
    from global rank 0 into every rank's copy, in place where the leaves are
    tensors (the reference's replicated sharding).  Returns ``tree``."""
    if mesh is None or not _initialized():
        return tree
    if isinstance(tree, torch.Tensor):
        dist.broadcast(tree.data, src=0)
    elif isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            replicate(t, mesh)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
    return tree


def mesh_of(mesh: Optional[Mesh], sharding=None) -> Optional[Mesh]:
    """The mesh a builder runs on: ``mesh``, or the mesh of a
    ``sharding`` from :func:`lattice_sharding`, which a given ``mesh``
    must be (``ValueError``)."""
    if sharding is None:
        return mesh
    if mesh is not None and mesh is not sharding.mesh:
        raise ValueError("the mesh given is not the lattice sharding's")
    return sharding.mesh


def shard_train_state(state, mesh: Optional[Mesh], sharding=None):
    """Place a ``train.gauge.TrainState``: params, optimizer state and dual
    averaging replicated from rank 0, the chains sliced over 'data' (and,
    with a ``sharding`` from :func:`lattice_sharding`, their columns over
    'space')."""
    mesh = mesh_of(mesh, sharding)
    if mesh is None:
        return state
    replicate(state.params, mesh)
    replicate(state.opt_state.mu, mesh)
    replicate(state.opt_state.nu, mesh)
    replicate(list(state.da), mesh)
    return state._replace(x=shard_chains(state.x, mesh) if sharding is None
                          else sharding.shard(state.x))


def lattice_sharding(mesh: Mesh, shape):
    """Chains over 'data' and the flat lattice axis over 'space': the
    reference's ``NamedSharding(mesh, P("data", "space"))`` for the FULL
    transition, as hand-written tensor parallelism
    (``parallel/spatial.py``: the slab, its halos and the 'space' sums)
    of the lattice ``shape`` (``ValueError`` where its time rows do not
    split evenly).  The builders take it in place of the mesh, e.g.
    ``make_train_step(cfg, sharding=lattice_sharding(m, cfg.shape))``."""
    from l2hmc_tpu_torch.parallel.spatial import LatticeSharding

    return LatticeSharding(mesh, shape)
