"""dp x sp train steps under ``lattice_sharding`` on several meshes: ms per
step, the share of the halo exchanges and 'space' sums, and the chains
after the first step against a one-rank run of the same state and draws.

One JSON line on stdout: per mesh ``DxS`` (D 'data' ranks, S 'space'
ranks, one process and one card per rank, NCCL; gloo ranks with
``--device cpu``), the host-clock ms per train step over ``--steps``
steps after one warm step (the device synchronized), then one profiled
window of ``--profile_steps`` steps on rank 0 (``torch.profiler``): the
device time of the NCCL kernels against all device time, and the host time
inside the ``lattice_sharding.halo`` / ``.space_sum`` ranges
(``parallel/spatial.py``) against the window; and ``x_diff``, the largest
difference of the first step's gathered chains from the first mesh's::

    python -m l2hmc_tpu_torch.benchmarks.space_scaling --config quickstart \\
        --meshes 1x1 1x4 2x2
    python -m l2hmc_tpu_torch.benchmarks.space_scaling --config local64 \\
        --meshes 1x1 1x2 1x4
    python -m l2hmc_tpu_torch.benchmarks.space_scaling --device cpu \\
        --config quickstart --size 8 --chains 8 --meshes 1x1 1x2 --steps 2

Configs: ``quickstart``, the README quick start's train step
(``train.gauge.quickstart_config``: 16x16, MLP h64, K=4, fixed eps 0.079,
``merge_v_halves``, ``charge_reward``, ``train_hops``, 128 chains);
``local64``, ``local64_h2h``'s training cell at its defaults
(``local64_h2h.train_config``: 64x64, ``local_flat`` c4 L1, K=4, eps
0.10014 fixed, ``merge_v_halves``, ``charge_reward``, 128 chains).
``--size`` and ``--chains`` cut either.  The ranks are spawned
by ``parallel/dryrun.spawn_local``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def make_cfg(name: str, size: int = 0, chains: int = 0):
    """The config ``name`` (``quickstart`` or ``local64``), its lattice cut
    to ``size`` x ``size`` and its chains to ``chains`` where given."""
    import dataclasses

    from l2hmc_tpu_torch.benchmarks import local64_h2h
    from l2hmc_tpu_torch.train.gauge import quickstart_config

    if name == "quickstart":
        cfg = quickstart_config()
    elif name == "local64":
        cfg = local64_h2h.train_config(local64_h2h.build_parser().parse_args(
            []))
    else:
        raise ValueError(f"config {name!r}: quickstart or local64")
    cut = {}
    if size:
        cut.update(time_size=size, space_size=size)
    if chains:
        cut.update(num_chains=chains)
    return dataclasses.replace(cfg, **cut)


def _profile_shares(prof, window_ms):
    from torch.autograd import DeviceType

    from l2hmc_tpu_torch.parallel.spatial import HALO_RANGE, SUM_RANGE

    dev_total = dev_nccl = 0.0
    host = {HALO_RANGE: 0.0, SUM_RANGE: 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            dev_total += us
            if "nccl" in e.key.lower():
                dev_nccl += us
        elif e.key in host:
            host[e.key] += e.cpu_time_total
    return {"device_ms": dev_total / 1e3,
            "nccl_device_ms": dev_nccl / 1e3,
            "nccl_device_share": (dev_nccl / dev_total if dev_total
                                  else None),
            "halo_host_share": host[HALO_RANGE] / 1e3 / window_ms,
            "space_sum_host_share": host[SUM_RANGE] / 1e3 / window_ms}


def rank_run(cfg_dict: dict, num_space: int, steps: int, profile_steps: int,
             device: str, seed: int = 0):
    """On each rank of the current group: the config's state and draws from
    ``seed`` (global, sliced), one warm step, ``steps`` timed steps, a
    profiled window on rank 0.  Returns the timing and the chains after
    the first step (gathered)."""
    import torch.distributed as dist

    from l2hmc_tpu_torch._device import float32_matmuls
    from l2hmc_tpu_torch.parallel.mesh import (get_mesh, lattice_sharding,
                                               shard_train_state)
    from l2hmc_tpu_torch.train.gauge import (config_from_dict,
                                             init_train_state,
                                             make_train_step)

    float32_matmuls()
    cfg = config_from_dict(cfg_dict)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mesh = get_mesh(num_space=num_space, device=dev)
    sp = lattice_sharding(mesh, cfg.shape)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = shard_train_state(init_train_state(cfg, gen, dev), mesh, sp)
    step, _ = make_train_step(cfg, mesh=mesh, sharding=sp)
    state, _ = step(state, gen)
    x1 = sp.gather(state.x).cpu()
    sync()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, gen)
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    shares = None
    if profile_steps:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        mesh.barrier()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_steps):
                state, m = step(state, gen)
            sync()
            window = 1e3 * (time.perf_counter() - t0)
        shares = _profile_shares(prof, window)
        shares["profiled_ms_per_step"] = window / profile_steps
    return {"ms_per_step": ms, "x1": x1, "loss": float(m["loss"]),
            "accept_prob": float(m["accept_prob"]),
            "rank": dist.get_rank() if dist.is_initialized() else 0,
            "profile": shares}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="quickstart",
                   choices=("quickstart", "local64"))
    p.add_argument("--meshes", nargs="+", default=["1x1", "1x4", "2x2"],
                   help="DxS: D 'data' ranks by S 'space' ranks")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--profile_steps", type=int, default=3)
    p.add_argument("--size", type=int, default=0)
    p.add_argument("--chains", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo ranks; default: a card per rank")
    args = p.parse_args(argv)

    import dataclasses

    from l2hmc_tpu_torch.parallel.dryrun import spawn_local

    on_card = args.device != "cpu"
    cfg = make_cfg(args.config, args.size, args.chains)
    if on_card:
        from l2hmc_tpu_torch.ops import _cuda

        _cuda.library()             # build once, before the ranks load it
    out = {"config": args.config, "lattice": [cfg.time_size, cfg.space_size],
           "chains": cfg.num_chains, "steps": args.steps,
           "profile_steps": args.profile_steps, "meshes": {}}
    first = None
    for spec in args.meshes:
        d, s = (int(v) for v in spec.split("x"))
        res = spawn_local(rank_run, d * s, "nccl" if on_card else "gloo",
                          "cuda" if on_card else "cpu",
                          args=(dataclasses.asdict(cfg), s, args.steps,
                                args.profile_steps,
                                "cuda" if on_card else "cpu", args.seed))
        r0 = res[0]
        if first is None:
            first = r0["x1"]
        out["meshes"][spec] = {
            "ms_per_step": r0["ms_per_step"],
            "ms_per_step_ranks": [r["ms_per_step"] for r in res],
            "x_diff": float((r0["x1"] - first).abs().max()),
            "loss": r0["loss"], "accept_prob": r0["accept_prob"],
            "profile": r0["profile"]}
        print(f"[space_scaling] {spec}: {out['meshes'][spec]}",
              file=sys.stderr, flush=True)
    if on_card:
        from l2hmc_tpu_torch.benchmarks import device_info

        out["device"] = device_info()
        out["device_count"] = torch.cuda.device_count()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
