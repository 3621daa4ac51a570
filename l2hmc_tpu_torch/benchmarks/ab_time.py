"""Time a kernel of two source trees in turns.

A kernel change is compared with its parent on one card in one call: each
tree's kernel is timed in a process of its own, in the order base, new,
new, base, ...,
so that a drift of the card's clock falls on both sides alike.  Kernels
(``--kernel``):

- ``champion`` (default): ``l2hmc_chain`` (``csrc/l2hmc_chain.cu``, float32)
  with the shipped champion's weights, 2048 chains thermalized at beta 4,
  calls of 200 transitions;
- ``local``: ``l2hmc_local_chain`` (``csrc/l2hmc_local_chain.cu``) at the
  local64 config of chip_smoke.py (64x64, ``local_flat`` c=4 L=1 from the
  port's seeded init, K=4, eps 0.10014, beta 4), 512 chains from a hot
  start, calls of 50 transitions;
- ``hmc16``: ``hmc_chain`` (``csrc/hmc_chain.cu``) at the champion path's
  HMC (16x16, 2048 chains, K=5, eps 0.08, beta 4), thermalized by 200
  transitions from a cold start, calls of 500 transitions;
- ``hmc64``: ``hmc_chain`` at local64's HMC (64x64, 512 chains, K=8, eps
  0.04552, beta 4) after a Metropolis warm start (300 checkerboard sweeps),
  calls of 100 transitions;
- ``wilson16``: the Wilson forward, backward and double backward
  (``csrc/wilson.cu``; their signatures are the same in trees before and
  after the fused force) at the training shape (128, 16, 16, 2), uniform
  links, g = 4, device time per launch, the inputs cycled through copies
  (each kernel's more than twice the L2); and the train step at the README
  quick-start config (16x16, 128 chains, K=4, MLP h64, charge_reward,
  train_hops), ms per step over 20 steps after 3 warm-up steps;
- ``wilson64``: the same three Wilson kernels at (512, 64, 64, 2).

A chain kernel's process reports the median of 9 calls (CUDA events) after
a warm-up call, in us per transition.  A Wilson kernel's reports the median
of 9 windows of 50 launches, each the device time per launch that
torch.profiler records (a launch at 16x16 takes less time on the card than
a call from Python, so CUDA events around calls would time the host).  Each
tree is built and warmed up once first.  One JSON line with, per metric:
every process's median; the mean and standard error of the paired
difference new - base and the number of pairs in which new is slower; the
spread of the base's own runs (the distance between their quartiles).

Usage (on the card; each tree a checkout of the repository, e.g. the parent
unpacked with ``git archive`` into an ignored directory)::

    python3 l2hmc_tpu_torch/benchmarks/ab_time.py build/parent . \
        [--kernel champion|local|hmc16|hmc64|wilson16|wilson64] [--pairs 10]

Run it as a file, not with ``-m``: each process imports the package from
the tree it times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 9
KERNELS = {"champion": ("l2hmc_chain f32, champion 16x16, 2048 chains", 200),
           "local": ("l2hmc_local_chain c4L1, local64 64x64, 512 chains",
                     50),
           "hmc16": ("hmc_chain K=5, 16x16, 2048 chains", 500),
           "hmc64": ("hmc_chain K=8, 64x64, 512 chains", 100),
           "wilson16": ("wilson kernels at (128, 16, 16, 2); quick-start "
                        "train step", None),
           "wilson64": ("wilson kernels at (512, 64, 64, 2)", None)}
WILSON_SHAPES = {"wilson16": (128, 16, 16), "wilson64": (512, 64, 64)}
WILSON_LAUNCHES = 50          # launches per profiled window
L2_BYTES = 50 * 2 ** 20       # the H100's L2
TRAIN_STEPS, TRAIN_WARMUP = 20, 3


def _champion(torch, dev, gen):
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
    from l2hmc_tpu_torch.ops import l2hmc_kernel
    from l2hmc_tpu_torch.train.checkpoint import load_champion
    from l2hmc_tpu_torch.train.gauge import build_dynamics

    cfg, params = load_champion(device=dev)
    eps = float(get_eps(params, build_dynamics(cfg)[0]))
    links = torch.zeros((2048, cfg.time_size, cfg.space_size, 2), device=dev)
    links = hmc_chain_u1_fused(links, gen, 0.08, 4.0, 5, 200)[0]
    nt = KERNELS["champion"][1]
    return lambda: l2hmc_kernel.l2hmc_chain(links, params, gen, eps, 4.0,
                                            cfg.num_steps, nt)


def _local(torch, dev, gen):
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops import l2hmc_kernel
    from l2hmc_tpu_torch.train.gauge import GaugeConfig, init_params

    cfg = GaugeConfig(time_size=64, space_size=64, num_chains=512,
                      num_steps=4, network_arch="local_flat", num_filters=4,
                      local_layers=1, merge_v_halves=True, eps_init=0.10014,
                      eps_trainable=False, beta_final=4.0, bounded_q=True)
    params = init_params(cfg, torch.Generator().manual_seed(640), device=dev)
    links = u1.to_links(u1.random_links(gen, 512, cfg.shape, device=dev),
                        cfg.shape).contiguous()
    nt = KERNELS["local"][1]
    return lambda: l2hmc_kernel.l2hmc_local_chain(links, params, gen,
                                                  0.10014, 4.0, 4, nt, 1)


def _hmc16(torch, dev, gen):
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    links = torch.zeros((2048, 16, 16, 2), device=dev)
    links = hmc_chain(links, gen, 0.08, 4.0, 5, 200)[0]
    nt = KERNELS["hmc16"][1]
    return lambda: hmc_chain(links, gen, 0.08, 4.0, 5, nt)


def _hmc64(torch, dev, gen):
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    shape = u1.LatticeShape(64, 64)
    x = thermalize(gen, u1.random_links(gen, 512, shape, device=dev), shape,
                   4.0, 300)
    links = u1.to_links(x, shape).contiguous()
    nt = KERNELS["hmc64"][1]
    return lambda: hmc_chain(links, gen, 0.04552, 4.0, 8, nt)


def _device_us(torch, fn):
    """Device time per call of ``fn`` (us) over ``WILSON_LAUNCHES`` calls,
    from torch.profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(WILSON_LAUNCHES):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / WILSON_LAUNCHES


def _device_us_retried(torch, fn, tries: int = 3):
    """:func:`_device_us`, taken again when a window records no device time
    (the profiler occasionally drops a window's kernels)."""
    for _ in range(tries):
        us = _device_us(torch, fn)
        if us > 0:
            return us
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} "
                       "windows")


def _train_step_ms(torch, dev, gen):
    """ms per train step at the README quick-start config, host clock
    around ``TRAIN_STEPS`` steps ending in a synchronize."""
    import time

    from l2hmc_tpu_torch.train import gauge as tg

    cfg = tg.GaugeConfig(
        time_size=16, space_size=16, num_chains=128, num_steps=4,
        eps_init=0.079, eps_trainable=False, network_arch="mlp",
        num_hidden=64, merge_v_halves=True, charge_reward=True,
        train_hops=True, beta_init=2.0, beta_final=5.0, train_steps=12000)
    state = tg.init_train_state(cfg, gen, dev)
    step = tg.make_train_step(cfg)[0]
    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, _ = step(state, gen)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS


def _wilson(torch, dev, gen, kernel):
    """``{metric: [values]}``: the Wilson kernels' device us per launch
    (``REPS`` windows each) and, at 16x16, the train step's ms.  The
    launches cycle through copies of the inputs, so many that the copies of
    sin P (the smallest input a kernel reads) exceed twice the L2
    (``L2_BYTES``): each launch reads its inputs from device memory."""
    import itertools

    import numpy as np

    from l2hmc_tpu_torch.ops import wilson

    b, lt, lx = WILSON_SHAPES[kernel]
    rng = np.random.default_rng(7)
    links = torch.tensor(rng.uniform(-np.pi, np.pi, (b, lt, lx, 2)),
                         dtype=torch.float32, device=dev)
    w = torch.tensor(rng.standard_normal((b, lt, lx, 2)),
                     dtype=torch.float32, device=dev)
    g = torch.full((b,), 4.0, device=dev)
    sinp = wilson.wilson_forward(links)[1]
    one = (links, g, w, sinp)
    sets = [one] + [tuple(t.clone() for t in one)
                    for _ in range(-(-2 * L2_BYTES // (4 * sinp.numel())) - 1)]

    def rotated(fn):
        it = itertools.cycle(sets)
        return lambda: fn(*next(it))

    runs = {"forward_us": lambda l, g, w, s: wilson.wilson_forward(l),
            "backward_us": lambda l, g, w, s: wilson.wilson_backward(s, g),
            "double_backward_us": lambda l, g, w, s:
                wilson.wilson_double_backward(l, g, w)}
    out = {}
    for name, fn in runs.items():
        fn = rotated(fn)
        fn()
        out[name] = [_device_us_retried(torch, fn) for _ in range(REPS)]
    if kernel == "wilson16":
        out["train_step_ms"] = [_train_step_ms(torch, dev, gen)]
    return out


def time_tree(tree, kernel):
    """``{metric: [values]}`` of ``kernel``, the package imported from
    ``tree``: us per transition of ``REPS`` calls of a chain kernel, or the
    Wilson metrics of :func:`_wilson`."""
    sys.path.insert(0, str(tree))
    import torch

    from l2hmc_tpu_torch.ops import l2hmc_kernel

    if not Path(l2hmc_kernel.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {l2hmc_kernel.__file__}, not {tree}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    if kernel in WILSON_SHAPES:
        return _wilson(torch, dev, gen, kernel)
    run = {"champion": _champion, "local": _local, "hmc16": _hmc16,
           "hmc64": _hmc64}[kernel](torch, dev, gen)
    nt = KERNELS[kernel][1]

    def once():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / nt

    once()
    return {"us_per_transition": [once() for _ in range(REPS)]}


def paired_difference(runs):
    """``runs``: ``[(tree, median_us), ...]`` in the order base, new, new,
    base, ...  Returns ``(mean, standard error, [new - base per pair])``."""
    diffs = []
    for i in range(0, len(runs) - 1, 2):
        (ta, a), (tb, b) = runs[i], runs[i + 1]
        if {ta, tb} != {"base", "new"}:
            raise ValueError(f"runs {i}, {i + 1} are not a pair: {ta}, {tb}")
        diffs.append(b - a if ta == "base" else a - b)
    se = (statistics.stdev(diffs) / len(diffs) ** 0.5 if len(diffs) > 1
          else float("nan"))
    return statistics.fmean(diffs), se, diffs


def _run_one(tree, kernel):
    out = subprocess.run([sys.executable, __file__, "--one", str(tree),
                          "--kernel", kernel],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"timing {tree} ({kernel}) failed:\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["metrics"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("base", nargs="?")
    p.add_argument("new", nargs="?")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--kernel", choices=sorted(KERNELS), default="champion")
    p.add_argument("--one", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps({"metrics": time_tree(Path(args.one).resolve(),
                                               args.kernel)}))
        return 0
    trees = {"base": Path(args.base).resolve(),
             "new": Path(args.new).resolve()}
    for tree in trees.values():            # build and warm each tree once
        _run_one(tree, args.kernel)
    order = []
    for i in range(args.pairs):
        order += ["base", "new"] if i % 2 == 0 else ["new", "base"]
    per_run = [(t, _run_one(trees[t], args.kernel)) for t in order]
    metrics = {}
    for name in per_run[0][1]:
        runs = [(t, statistics.median(m[name])) for t, m in per_run]
        mean, se, diffs = paired_difference(runs)
        base = [m for t, m in runs if t == "base"]
        q1, _, q3 = statistics.quantiles(base, n=4)
        metrics[name] = {
            "runs_median": runs, "diff": diffs, "diff_mean": mean,
            "diff_se": se, "diff_pct": 100 * mean / statistics.fmean(base),
            "pairs_new_slower": sum(d > 0 for d in diffs),
            "base_iqr": q3 - q1}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "benchmark": "ab_time", "kernel": KERNELS[args.kernel][0],
        "device": smi, "trees": {k: str(v) for k, v in trees.items()},
        "metrics": metrics}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
