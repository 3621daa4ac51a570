"""Samples/s weak-scaling harness (port of ``benchmarks/scaling.py``;
BASELINE.json's north star: >= 80% efficiency from 1 host to 2+).

Measures sampling (or training) throughput with the chain batch sharded
over the ranks of a ``torch.distributed`` group, the per-rank chain count
fixed (weak scaling, the regime that matters for ensemble MCMC).  One
process per rank, a card each (NCCL), or gloo ranks on the CPU with
``--device cpu``; JAX's loop over the virtual devices of one process has
no counterpart here, so a run measures its whole group once (and prints
no ``weak_scaling_efficiency_vs_1dev`` line: the efficiency is against
``--baseline_rate``, a one-process run's rate).  Every
transition's forces and Hamiltonians go through the Wilson kernels of
``ops/wilson.py`` on the card; the draws are made for the global batch and
sliced (``train.gauge.draw_transition`` with the mesh).

Launch, one process per rank::

    # one card, no group
    python -m l2hmc_tpu_torch.benchmarks.scaling --chains_per_device 256
    # the ranks of one host
    torchrun --standalone --nproc_per_node=4 \\
        -m l2hmc_tpu_torch.benchmarks.scaling --chains_per_device 256
    # two hosts, the JAX script's flags (the coordinator is rank 0's
    # host:port, a TCP rendezvous)
    python -m l2hmc_tpu_torch.benchmarks.scaling --coordinator 10.0.0.1:8476 \\
        --num_processes 2 --process_id 0 --chains_per_device 256
    # then the efficiency against a one-process run's rate R1
    ... --num_processes 2 ... --baseline_rate R1

Before timing, the collective topology is checked on the group: an
all-reduce of the ranks' indices must be exactly n(n-1)/2, and the mean of
a per-chain vector sharded over the ranks must equal the host's float64
mean within 1e-6.  Global rank 0 prints one JSON line per check and
measurement (the JAX script's keys).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def verify_psum_topology(mesh, device):
    """Check that the 'data'-axis reduction is wired across every rank;
    returns the number of ranks checked.

    1. index sum: the global vector ``arange(n)`` sharded over 'data' (each
       rank holds its own index); the all-reduced sum must be exactly
       n(n-1)/2, so a miswired or dropped participant changes it.
    2. mean reduction: the mean of a sharded ``(8n, 4)`` per-chain vector,
       all-reduced, must match the host's float64 mean within 1e-6.
    """
    from l2hmc_tpu_torch.parallel.mesh import shard_chains

    n = mesh.size("data")
    idx = shard_chains(torch.arange(n, dtype=torch.float32,
                                    device=device)[:, None], mesh)
    total = float(mesh.all_reduce(idx.sum()))
    expect = n * (n - 1) / 2.0
    if total != expect:
        raise AssertionError(f"psum topology broken: {total} != {expect}")

    v = np.random.default_rng(0).normal(size=(8 * n, 4)).astype(np.float32)
    vs = shard_chains(torch.tensor(v, device=device), mesh)
    got = float(mesh.all_reduce(vs.sum())) / v.size
    want = float(np.mean(v, dtype=np.float64))
    if abs(got - want) >= 1e-6:
        raise AssertionError(f"mean reduction off: {got} vs {want}")
    return n


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chains_per_device", type=int, default=64)
    p.add_argument("--time_size", type=int, default=16)
    p.add_argument("--space_size", type=int, default=16)
    p.add_argument("--num_steps", type=int, default=3)
    p.add_argument("--network_arch", default="conv")
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--mode", default="sample", choices=["sample", "train"])
    p.add_argument("--coordinator", default="",
                   help="rank 0's host:port; with --num_processes and "
                        "--process_id, a TCP rendezvous for this process's "
                        "group")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--baseline_rate", type=float, default=0.0,
                   help="single-host transitions/s to compute cross-host "
                        "weak-scaling efficiency against")
    p.add_argument("--device", default=None,
                   help="torch device (default: this rank's card; 'cpu' "
                        "for gloo ranks)")
    return p


def _join_group(args, device) -> bool:
    """Join ``--coordinator``'s group, or a launcher's; ``True`` when this
    call created it (and must destroy it)."""
    import torch.distributed as dist

    from l2hmc_tpu_torch.parallel.mesh import initialize_distributed

    if args.coordinator and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_processes, rank=args.process_id)
        return True
    return initialize_distributed(str(device))


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch.distributed as dist

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.parallel.mesh import (get_mesh, is_primary,
                                               shard_chains,
                                               shard_train_state)
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, build_dynamics,
                                             draw_transition,
                                             init_train_state,
                                             make_train_chunk)

    float32_matmuls()
    device = resolve_device(args.device)
    launched = _join_group(args, device)
    mesh = get_mesh(device=device)
    processes = mesh.world

    def emit(line):
        if is_primary():
            print(json.dumps(line), flush=True)

    def drain(t):
        # every rank's share of the chunk is done once the sum is reduced
        return float(mesh.all_reduce(t.detach().sum()))

    group_mesh = mesh if dist.is_initialized() else None
    nd = mesh.size("data")
    cfg = GaugeConfig(
        time_size=args.time_size, space_size=args.space_size,
        num_chains=args.chains_per_device * nd, num_steps=args.num_steps,
        network_arch=args.network_arch, eps_init=0.1,
    )
    n_checked = verify_psum_topology(mesh, device)
    emit({"psum_topology_ok": True, "devices_checked": n_checked,
          "processes": processes})
    gen = torch.Generator(device=device).manual_seed(0)
    state = shard_train_state(init_train_state(cfg, gen, device), group_mesh)

    if args.mode == "train":
        chunk_fn = make_train_chunk(cfg, args.chunk, mesh=group_mesh)

        def run():
            _, m = chunk_fn(state, gen)
            drain(m["loss"])
    else:
        _, dyn = build_dynamics(cfg)
        x0 = shard_chains(u1.random_links(gen, cfg.num_chains, cfg.shape,
                                          device=device), group_mesh)

        @torch.no_grad()
        def run():
            x, probs = x0, []
            for _ in range(args.chunk):
                out = dyn["transition_with"](
                    state.params, x, 4.0,
                    *draw_transition(gen, x, group_mesh))
                x = u1.wrap(out.x_out)
                probs.append(out.accept_prob)
            drain(torch.stack(probs))

    run()                                      # warm-up
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    rate = args.chunk * cfg.num_chains / best      # chain-transitions/s
    emit({"devices": nd, "chains": cfg.num_chains, "processes": processes,
          "transitions_per_s": round(rate, 1)})
    if args.baseline_rate > 0:
        emit({"weak_scaling_efficiency_vs_baseline": round(
                  rate / (args.baseline_rate * processes), 3),
              "baseline_rate": args.baseline_rate,
              "processes": processes})
    if launched:
        dist.destroy_process_group()
    return 0


def rank_lines(argv):
    """``main(argv)`` on this rank of an initialized group (a worker for
    ``parallel/dryrun.spawn_local``): the JSON lines it printed, empty off
    global rank 0."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(list(argv))
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


if __name__ == "__main__":
    sys.exit(main())
