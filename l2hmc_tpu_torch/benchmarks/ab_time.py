"""Time the float32 champion chain kernel of two source trees in turns.

A kernel change is compared with its parent on one card in one call: each
tree's ``l2hmc_chain`` (``csrc/l2hmc_chain.cu`` with the shipped champion's
weights, 2048 chains thermalized at beta 4, calls of 200 transitions) is
timed in a process of its own, in the order base, new, new, base, ...,
so that a drift of the card's clock falls on both sides alike.  Each
process reports the median of 9 calls (CUDA events) after a warm-up call;
each tree is built and warmed up once first.  One JSON line: every
process's median; the mean and standard error of the paired difference
new - base and the number of pairs in which new is slower; the spread of
the base's own runs (the distance between their quartiles).

Usage (on the card; each tree a checkout of the repository, e.g. the parent
unpacked with ``git archive`` into an ignored directory)::

    python3 l2hmc_tpu_torch/benchmarks/ab_time.py build/parent . [--pairs 10]

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

NT, REPS = 200, 9


def time_tree(tree):
    """us per transition of ``REPS`` calls of the f32 champion kernel, the
    package imported from ``tree``."""
    sys.path.insert(0, str(tree))
    import torch

    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
    from l2hmc_tpu_torch.ops import l2hmc_kernel
    from l2hmc_tpu_torch.train.checkpoint import load_champion
    from l2hmc_tpu_torch.train.gauge import build_dynamics

    if not Path(l2hmc_kernel.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {l2hmc_kernel.__file__}, not {tree}")
    dev = torch.device("cuda", 0)
    cfg, params = load_champion(device=dev)
    eps = float(get_eps(params, build_dynamics(cfg)[0]))
    gen = torch.Generator(device=dev).manual_seed(1)
    links = torch.zeros((2048, cfg.time_size, cfg.space_size, 2), device=dev)
    links = hmc_chain_u1_fused(links, gen, 0.08, 4.0, 5, 200)[0]

    def once():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        l2hmc_kernel.l2hmc_chain(links, params, gen, eps, 4.0,
                                 cfg.num_steps, NT)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / NT

    once()
    return [once() for _ in range(REPS)]


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


def _run_one(tree):
    out = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])["us"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("base", nargs="?")
    p.add_argument("new", nargs="?")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--one", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps({"us": time_tree(Path(args.one).resolve())}))
        return 0
    trees = {"base": Path(args.base).resolve(),
             "new": Path(args.new).resolve()}
    for tree in trees.values():            # build and warm each tree once
        _run_one(tree)
    order = []
    for i in range(args.pairs):
        order += ["base", "new"] if i % 2 == 0 else ["new", "base"]
    runs = [(t, statistics.median(_run_one(trees[t]))) for t in order]
    mean, se, diffs = paired_difference(runs)
    base = [m for t, m in runs if t == "base"]
    q1, _, q3 = statistics.quantiles(base, n=4)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "benchmark": "ab_time", "kernel": "l2hmc_chain f32, champion",
        "device": smi, "trees": {k: str(v) for k, v in trees.items()},
        "runs_median_us": runs, "diff_us": diffs, "diff_us_mean": mean,
        "diff_us_se": se, "diff_pct": 100 * mean / statistics.fmean(base),
        "pairs_new_slower": sum(d > 0 for d in diffs),
        "base_iqr_us": q3 - q1}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
