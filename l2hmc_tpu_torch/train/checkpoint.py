"""Checkpoints of the port's training, and trained weights carried across
from the JAX package.

Checkpoints (port of ``l2hmc_tpu/train/checkpoint.py``): one directory per
step, ``<ckpt_dir>/<step>/state.pt`` (``attempt<a>_<step>`` in a
retraining attempt ``a``), a ``torch.save`` of the whole
:class:`TrainState` as tensors (params, Adam's moments and count, the
dual-averaging state, the chain state and the step) and, when given, the
generator's state, so a restored run draws what the saved run would have
drawn next, and the training attempt with the attempts finished so far.
The newest ``keep`` (3) by (attempt, step) are kept.  ``config.json`` beside
them is ``dataclasses.asdict(config)`` at indent 2, written once, as the
reference writes it, so :func:`load_config_dict` reads either package's.

From the JAX package: a ``DynamicsParams`` pytree flattens
(``jax.tree_util.tree_flatten``) to ``[xnet leaves..., vnet leaves...,
raw_eps, masks]``, each net dict with its keys in sorted order at every
level (:func:`net_leaf_order`; :data:`NET_LEAF_ORDER` for the MLP family);
each leaf goes through its module's ``from_reference_leaf`` (the image
nets' layouts differ).  The shipped ``benchmarks/champion_16x16.npz``
stores those leaves as ``arr_0..arr_17`` beside a ``config`` JSON string.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from l2hmc_tpu_torch._device import resolve_device
from l2hmc_tpu_torch.dynamics.l2hmc import DynamicsParams
from l2hmc_tpu_torch.dynamics.nuts import DualAveragingState
from l2hmc_tpu_torch.train.gauge import (
    GaugeConfig,
    OptState,
    TrainState,
    build_networks,
    config_from_dict,
    make_optimizer,
    named_leaves,
)

# sorted-key flatten order of one make_mlp_net parameter dict
NET_LEAF_ORDER = ("coeff_scale", "coeff_transformation", "h_layer.b",
                  "h_layer.w", "head_b", "head_w", "in_b", "in_w")

CHAMPION_PATH = (Path(__file__).resolve().parents[2] / "benchmarks"
                 / "champion_16x16.npz")


def _net_arrays(net) -> dict:
    """``{'in_w': ..., 'h_layer.w': ...}`` from a nested dict of arrays."""
    out = {}
    for k, v in net.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def net_leaf_order(cfg: GaugeConfig) -> tuple:
    """Dotted parameter names of one net of ``cfg.network_arch`` in the JAX
    flatten order (dict keys sorted at every level)."""
    xnet, _ = build_networks(cfg, torch.Generator().manual_seed(0))
    return tuple(sorted(xnet.state_dict(), key=lambda k: k.split(".")))


def _nest(flat: dict) -> dict:
    """``{'a.b': v}`` -> ``{'a': {'b': v}}``."""
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_numpy(tree, cfg: GaugeConfig, device=None) -> DynamicsParams:
    """Port params from a reference ``DynamicsParams`` with numpy leaves
    (fields ``xnet``, ``vnet`` — dicts as the reference's ``init`` of
    ``cfg.network_arch`` makes them —, ``raw_eps`` and ``masks``), on
    ``device`` (``None``: the first CUDA device)."""
    device = resolve_device(device)
    # the modules' initial values are overwritten; a private generator keeps
    # their construction off the global RNG
    xnet, vnet = build_networks(cfg, torch.Generator().manual_seed(0))
    for net, arrays in ((xnet, tree.xnet), (vnet, tree.vnet)):
        state = {k: torch.tensor(net.from_reference_leaf(
                     k, np.asarray(v, np.float32)))
                 for k, v in _net_arrays(arrays).items()}
        net.load_state_dict(state, strict=True)
    params = DynamicsParams(
        xnet, vnet, torch.tensor(np.asarray(tree.raw_eps, np.float32)),
        torch.tensor(np.asarray(tree.masks, np.float32)))
    return params.to(device)


def params_from_leaves(leaves, cfg: GaugeConfig, device=None):
    """Port params from the flat leaf list (the npz ``arr_i`` order) of a
    ``cfg.network_arch`` pytree."""
    order = net_leaf_order(cfg)
    n = len(order)
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"expected {2 * n + 2} leaves, got {len(leaves)}")
    tree = SimpleNamespace(xnet=_nest(dict(zip(order, leaves[:n]))),
                           vnet=_nest(dict(zip(order, leaves[n:2 * n]))),
                           raw_eps=leaves[2 * n], masks=leaves[2 * n + 1])
    return params_from_numpy(tree, cfg, device)


def leaves_from_params(params: DynamicsParams, cfg: GaugeConfig) -> list:
    """The inverse of :func:`params_from_leaves`: the flat numpy leaves of
    ``params`` in the JAX pytree's flatten order and layouts (each net's
    ``to_reference_leaf``), as the champion npz stores them."""
    order = net_leaf_order(cfg)
    leaves = []
    for net in (params.xnet, params.vnet):
        state = net.state_dict()
        leaves += [net.to_reference_leaf(k, state[k].detach().cpu().numpy())
                   for k in order]
    return leaves + [params.raw_eps.detach().cpu().numpy(),
                     params.masks.cpu().numpy()]


def load_champion(path=CHAMPION_PATH, device=None):
    """``(GaugeConfig, DynamicsParams)`` from the shipped champion npz, on
    ``device`` (``None``: the first CUDA device)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        cfg = config_from_dict(json.loads(str(z["config"])))
        n = 2 * len(net_leaf_order(cfg)) + 2
        leaves = [z[f"arr_{i}"] for i in range(n)]
    return cfg, params_from_leaves(leaves, cfg, device)


def _find_adam(opt_state):
    """The ``ScaleByAdamState`` (fields ``count``, ``mu``, ``nu``) inside a
    reference optax state (chains and ``MaskedState`` are tuples)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for item in opt_state:
            found = _find_adam(item)
            if found is not None:
                return found
    return None


def _leaf_at(tree, name: str, params: DynamicsParams):
    """The leaf of a reference params-shaped tree at ``xnet/h_layer/w``, in
    the layout of the port's tensor of that name in ``params``."""
    head, *rest = name.split("/")
    node = getattr(tree, head)
    for part in rest:
        node = node[part]
    node = np.asarray(node, np.float32)
    if head in ("xnet", "vnet"):
        return getattr(params, head).from_reference_leaf(".".join(rest),
                                                         node)
    return node


def train_state_from_numpy(tree, cfg: GaugeConfig, device=None) -> TrainState:
    """Port ``TrainState`` from a reference ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``), on ``device`` (``None``: the first
    CUDA device): params, Adam's ``mu``/``nu`` of the optimized tensors and
    optax's count, the chain state, the step and the dual-averaging state.
    """
    device = resolve_device(device)
    params = params_from_numpy(tree.params, cfg, device)
    adam = _find_adam(tree.opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam state (mu, nu)")
    init = make_optimizer(cfg).init(named_leaves(params))

    def moments(field):
        return {k: torch.tensor(_leaf_at(getattr(adam, field), k, params),
                                device=device)
                for k in init.mu}

    opt_state = OptState(count=int(adam.count), mu=moments("mu"),
                         nu=moments("nu"))
    da = DualAveragingState(*[torch.tensor(np.asarray(a, np.float32),
                                           device=device) for a in tree.da])
    return TrainState(params=params, opt_state=opt_state,
                      x=torch.tensor(np.asarray(tree.x, np.float32),
                                     device=device),
                      step=int(tree.step), da=da)


# ---------------------------------------------------------------------------
# Checkpoints of the port's training
# ---------------------------------------------------------------------------


def checkpoint_name(attempt: int, step: int) -> str:
    """Directory name of the checkpoint of ``step`` in training attempt
    ``attempt``: ``<step>`` for attempt 0 (the reference's layout),
    ``attempt<a>_<step>`` for a retraining attempt ``a``."""
    return str(int(step)) if attempt == 0 else f"attempt{attempt}_{step}"


def _parse_name(name: str) -> Optional[Tuple[int, int]]:
    if name.isdigit():
        return 0, int(name)
    head, _, step = name.partition("_")
    if head.startswith("attempt") and head[7:].isdigit() and step.isdigit():
        return int(head[7:]), int(step)
    return None


def _checkpoint_dirs(ckpt_dir: Path):
    """``{(attempt, step): dir}`` of the complete checkpoints under
    ``ckpt_dir``."""
    if not ckpt_dir.is_dir():
        return {}
    out = {}
    for p in ckpt_dir.iterdir():
        key = _parse_name(p.name)
        if key is not None and (p / "state.pt").is_file():
            out[key] = p
    return out


def save_checkpoint(ckpt_dir, state: TrainState, step: int, config=None,
                    keep: int = 3, generator_state=None, attempt: int = 0,
                    attempts=(), mesh=None, sharding=None):
    """Write ``state`` as the checkpoint of ``step`` in training attempt
    ``attempt`` and prune to the newest ``keep`` by (attempt, step); a
    retraining attempt restarts at step 0, so its checkpoints are newer
    than every one of the attempts before it.  ``config.json`` is written
    when absent.  ``generator_state`` (``torch.Generator.get_state()``) is
    saved beside the state for :func:`restore_checkpoint`; ``attempts``, the
    attempts finished so far (``{"attempt", "end_accept"}`` records), for
    :func:`checkpoint_attempts`.

    With a ``mesh`` (``parallel/mesh.py``) every rank calls it: the chains
    are gathered over 'data' and the primary (global rank 0) writes the
    full state, so the layout is one for any world size; the call returns
    on every rank once the file is there.  With a ``sharding``
    (``lattice_sharding``; the mesh is its mesh) the chains are
    gathered over 'space' as well."""
    from l2hmc_tpu_torch.parallel.mesh import (gather_chains, is_primary,
                                               mesh_of)

    mesh = mesh_of(mesh, sharding)
    if sharding is not None:
        state = state._replace(x=sharding.gather(state.x))
    elif mesh is not None:
        state = state._replace(x=gather_chains(state.x, mesh))
    if mesh is not None:
        if not is_primary():
            mesh.barrier()
            return
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if config is not None:
        cfg_file = ckpt_dir / "config.json"
        if not cfg_file.exists():
            cfg_file.write_text(json.dumps(dataclasses.asdict(config),
                                           indent=2))
    opt = state.opt_state
    payload = {
        "params": {k: v.detach() for k, v in state.params.state_dict().items()},
        "opt_count": int(opt.count), "mu": opt.mu, "nu": opt.nu,
        "x": state.x, "step": int(state.step), "da": list(state.da),
        "attempt": int(attempt),
        "attempts": [{"attempt": int(a["attempt"]),
                      "end_accept": float(a["end_accept"])}
                     for a in attempts],
    }
    if generator_state is not None:
        payload["generator"] = generator_state
    _write_payload(ckpt_dir, checkpoint_name(attempt, step), payload, keep)
    if mesh is not None:
        mesh.barrier()


def _write_payload(ckpt_dir: Path, name: str, payload: dict, keep: int):
    """``payload`` as ``<ckpt_dir>/<name>/state.pt`` (written whole, then
    renamed), pruned to the newest ``keep`` by (attempt, step)."""
    out = ckpt_dir / name
    out.mkdir(exist_ok=True)
    tmp = out / "state.pt.tmp"
    torch.save(payload, tmp)
    tmp.replace(out / "state.pt")
    dirs = _checkpoint_dirs(ckpt_dir)
    for old in sorted(dirs)[:-keep] if keep > 0 else []:
        shutil.rmtree(dirs[old])


def save_tensors(ckpt_dir, tensors: dict, step: int, config=None,
                 keep: int = 3):
    """A dict of tensors and numbers (e.g. the flow's parameters, or its
    optimizer state) as the checkpoint of ``step``, in the layout of
    :func:`save_checkpoint` (``<step>/state.pt``, ``config.json`` when
    given and absent, the newest ``keep`` kept); read back by
    :func:`load_tensors`."""
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if config is not None and not (ckpt_dir / "config.json").exists():
        (ckpt_dir / "config.json").write_text(
            json.dumps(dataclasses.asdict(config), indent=2))
    _write_payload(ckpt_dir, checkpoint_name(0, step), dict(tensors), keep)


def load_tensors(ckpt_dir, step: Optional[int] = None,
                 device=None) -> dict:
    """What :func:`save_tensors` wrote for ``step`` (``None``: the newest),
    on ``device`` (``None``: where it was saved from)."""
    return torch.load(_checkpoint_file(Path(ckpt_dir).absolute(), step, 0),
                      map_location=device, weights_only=True)


def latest_checkpoint(ckpt_dir) -> Optional[Tuple[int, int]]:
    """``(attempt, step)`` of the newest checkpoint under ``ckpt_dir``, or
    ``None``."""
    keys = _checkpoint_dirs(Path(ckpt_dir).absolute())
    return max(keys) if keys else None


def latest_step(ckpt_dir) -> Optional[int]:
    """The step of the newest checkpoint (by attempt, then step) under
    ``ckpt_dir``, or ``None``."""
    key = latest_checkpoint(ckpt_dir)
    return None if key is None else key[1]


def _checkpoint_file(ckpt_dir: Path, step, attempt) -> Path:
    if step is None:
        keys = [k for k in _checkpoint_dirs(ckpt_dir)
                if attempt is None or k[0] == attempt]
        if not keys:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
        attempt, step = max(keys)
    return ckpt_dir / checkpoint_name(attempt or 0, step) / "state.pt"


def restore_checkpoint(ckpt_dir, template: TrainState,
                       step: Optional[int] = None, generator=None,
                       attempt: Optional[int] = None,
                       mesh=None, sharding=None) -> TrainState:
    """The checkpointed state of ``step`` in ``attempt`` (``step=None``: the
    newest by (attempt, step), within ``attempt`` when given; a given
    ``step`` is attempt 0's unless ``attempt`` says otherwise) in the
    structure of ``template`` (a state of the same config, e.g. from
    ``init_train_state``), on the template's device; ``template.params``
    is loaded in place.  A ``generator`` is set to the saved generator
    state when the checkpoint has one.  With a ``mesh`` the saved (global)
    chains are sliced to this rank's: a checkpoint of n ranks restores on
    any m that divide its chains; with a ``sharding``, to this rank's
    columns too."""
    from l2hmc_tpu_torch.parallel.mesh import mesh_of, shard_chains

    mesh = mesh_of(mesh, sharding)
    ckpt_dir = Path(ckpt_dir).absolute()
    device = template.x.device
    payload = torch.load(_checkpoint_file(ckpt_dir, step, attempt),
                         map_location=device, weights_only=True)
    params = template.params
    params.load_state_dict(payload["params"], strict=True)
    if generator is not None and "generator" in payload:
        generator.set_state(payload["generator"].cpu())
    return TrainState(
        params=params,
        opt_state=OptState(count=int(payload["opt_count"]),
                           mu=payload["mu"], nu=payload["nu"]),
        x=(shard_chains(payload["x"], mesh) if sharding is None
           else sharding.shard(payload["x"])), step=int(payload["step"]),
        da=DualAveragingState(*payload["da"]))


def checkpoint_attempts(ckpt_dir, step: Optional[int] = None,
                        attempt: Optional[int] = None):
    """``(attempt, finished)`` recorded with a checkpoint (chosen as by
    :func:`restore_checkpoint`): its training attempt and the attempts
    finished when it was written, as ``{"attempt", "end_accept"}``
    records."""
    payload = torch.load(_checkpoint_file(Path(ckpt_dir).absolute(), step,
                                          attempt),
                         map_location="cpu", weights_only=True)
    return int(payload.get("attempt", 0)), list(payload.get("attempts", []))


def load_config_dict(ckpt_dir) -> Optional[dict]:
    """The ``config.json`` beside the checkpoints, or ``None``."""
    f = Path(ckpt_dir).absolute() / "config.json"
    return json.loads(f.read_text()) if f.exists() else None
