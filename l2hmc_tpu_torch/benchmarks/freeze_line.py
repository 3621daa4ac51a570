"""Matched-physical-volume freezing line: the hop's advantage along beta
proportional to V (port of ``benchmarks/freeze_line.py``).

At fixed beta the hop's tunneling ratio shrinks with volume, so the
physically relevant direction is fixed lattice spacing, beta ~ V (the
continuum limit at constant physical volume).  Along that line the hop's
Metropolis exponent beta*dS stays O(1), so its acceptance approaches a
constant (column ``hop_accept``), while HMC's diffusive tunneling dies
exponentially in beta (instanton suppression).

Per point: HMC's joint (K, eps) optimum by ``train/autotune.tune_hmc``
(probes on ``ops/leapfrog.hmc_chain`` on the card) unless cached with
``--hmc_cache``, then ``benchmarks/topo_ensemble.py`` (interleaved timed
chunks, all hop cost counted, pooled tau_int(Q), jackknife over reps) at
the tuned point, without the champion.  Writes
``<out_dir>/freeze_<size>_<beta>.json`` per point and
``<out_dir>/freeze_line.json``, and prints the latter.

Randomness: each point's tuner streams come from
``h2h_seeds.stream_generator(31 + size, stream)`` (0 the links, 7 the
Metropolis warm start, 1 the tuner), JAX's key numbers.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.freeze_line \\
        --points 8:2.5,16:5.0,32:10.0 --reps 3 --eval_steps 8000
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _trace(msg):
    print(f"[freeze {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def parse_points(text):
    """``"8:2.5,16:5.0"`` -> ``[(8, 2.5), (16, 5.0)]``."""
    points = []
    for item in text.split(","):
        s, b = item.split(":")
        points.append((int(s), float(b)))
    return points


def parse_cache(text):
    """``"size:K:eps;..."`` -> ``{size: (K, eps)}``."""
    cache = {}
    for item in text.split(";"):
        if item:
            s, k, e = item.split(":")
            cache[int(s)] = (int(k), float(e))
    return cache


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--points", default="8:2.5,16:5.0,32:10.0",
                   help="comma list of size:beta along the beta ~ V line")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--eval_steps", type=int, default=8000)
    p.add_argument("--eval_chains", type=int, default=2048)
    p.add_argument("--trace_chains", type=int, default=256)
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--probe_chains", type=int, default=1024)
    p.add_argument("--hmc_cache", default="",
                   help="optional cached optima 'size:K:eps;...' to skip "
                        "tune_hmc at points already tuned (tuner-produced "
                        "values only, e.g. from a prior campaign JSON)")
    p.add_argument("--out_dir", default="runs")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.benchmarks import topo_ensemble
    from l2hmc_tpu_torch.benchmarks.h2h_seeds import stream_generator
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import device_name
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train.autotune import tune_hmc
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    float32_matmuls()
    device = resolve_device(args.device)
    cache = parse_cache(args.hmc_cache)
    points = parse_points(args.points)
    _trace(f"device: {device_name(device)}; line: {points}")
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)

    rows = []
    for size, beta in points:
        cfg = GaugeConfig(time_size=size, space_size=size,
                          num_chains=args.probe_chains, beta_final=beta)
        if size in cache:
            k_h, eps_h = cache[size]
            _trace(f"{size}x{size} beta={beta}: cached HMC K={k_h} "
                   f"eps={eps_h}")
        else:
            seed = 31 + size
            x0 = u1.random_links(stream_generator(seed, 0, device),
                                 args.probe_chains, cfg.shape, device=device)
            x0 = thermalize(stream_generator(seed, 7, device), x0, cfg.shape,
                            beta, args.therm_sweeps)
            t0 = time.perf_counter()
            opt = tune_hmc(cfg, x0, beta, stream_generator(seed, 1, device),
                           probe_chains=args.probe_chains)
            k_h, eps_h = opt.num_steps, opt.eps
            _trace(f"{size}x{size} beta={beta}: tuned HMC K={k_h} "
                   f"eps={eps_h} acc={opt.accept:.3f} "
                   f"({time.perf_counter()-t0:.0f}s)")

        out_path = f"{args.out_dir}/freeze_{size}_{beta:g}.json"
        topo_ensemble.main([
            "--size", str(size), "--beta", str(beta),
            "--reps", str(args.reps),
            "--eval_steps", str(args.eval_steps),
            "--eval_chains", str(args.eval_chains),
            "--trace_chains", str(args.trace_chains),
            "--therm_sweeps", str(args.therm_sweeps),
            "--hmc_num_steps", str(k_h), "--hmc_eps", str(eps_h),
            "--no_champion", "--out", out_path, "--device", str(device),
        ])
        res = json.loads(Path(out_path).read_text())
        s = res["summary"]["hmc+hop"]
        h = res["summary"]["hmc"]
        row = {
            "size": size, "beta": beta,
            "hmc": f"K={k_h} eps={eps_h}",
            "hop_accept": res["per_rep"][0]["hmc+hop"].get("hop_accept"),
            "ratio_tunneling_per_s": s["ratio_tunneling_per_s"],
            "ratio_q_ess_per_s_pooled": s["ratio_q_ess_per_s_pooled"],
            "ratio_plaq_ess_per_s": s["ratio_plaq_ess_per_s"],
            "hmc_tunneling_per_step": res["per_rep"][0]["hmc"][
                "tunneling_per_step"],
            "hop_tunneling_per_step": res["per_rep"][0]["hmc+hop"][
                "tunneling_per_step"],
            "q2_hop": s["q2_mean"], "q2_hmc": h["q2_mean"],
            "q2_exact": res["q2_exact"],
            "detail": out_path,
        }
        rows.append(row)
        _trace(f"row: {json.dumps(row)}")

    result = {"benchmark": "freeze_line",
              "protocol": (f"topo_ensemble reps={args.reps} "
                           f"eval_steps={args.eval_steps} "
                           f"chains={args.eval_chains}, HMC auto-tuned "
                           "per point, all hop cost counted"),
              "rows": rows}
    out_s = json.dumps(result)
    print(out_s, flush=True)
    Path(f"{args.out_dir}/freeze_line.json").write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
