"""Offline re-analysis CLI (port of ``cli/analyze_run.py``).

Usage::

    python -m l2hmc_tpu_torch.cli.analyze_run runs/gauge/run_1 [--therm_frac 0.25]

Reads metrics.jsonl and eval_*.npz from the run dir (of either package's
training CLI) and writes analysis.json (jackknife stats, IAT/ESS, charge
histograms, tunneling rates); with ``--plots``, the plot families under
``<run_dir>/plots/`` (``analysis/plots.py``; needs matplotlib, which the
card's machine lacks: there ``--plots`` raises an ``ImportError``).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("--therm_frac", type=float, default=0.25)
    p.add_argument("--plots", action="store_true")
    p.add_argument("--beta", type=float, default=None,
                   help="beta for the exact-plaquette reference line")
    args = p.parse_args(argv)

    from l2hmc_tpu_torch.analysis.observables import analyze_run

    report = analyze_run(args.run_dir, args.therm_frac)
    print(f"wrote {Path(args.run_dir) / 'analysis.json'}")
    for name, section in report.items():
        if (
            isinstance(section, dict)
            and isinstance(section.get("plaqs"), dict)
            and "jackknife_mean" in section["plaqs"]
        ):
            pl = section["plaqs"]
            print(
                f"{name}: plaq = {pl['jackknife_mean']:.5f} "
                f"+- {pl['jackknife_err']:.5f} (tau_int {pl['tau_int']:.1f})"
            )
            if "charges" in section:
                ch = section["charges"]
                rel = "" if ch.get("tau_int_pooled_reliable") else \
                    " [unreliable: window exceeds trace]"
                print(
                    f"{name}: <Q^2> = {ch['susceptibility']:.3f} "
                    f"tunneling <|dQ|> = {ch['tunneling_rate']:.3f} "
                    f"tau_int(Q) sokal = {ch['tau_int']:.1f}, "
                    f"pooled = {ch['tau_int_pooled']:.1f}{rel}"
                )
            if "hop_accept" in section:
                print(
                    f"{name}: hop_accept = "
                    f"{section['hop_accept']['mean']:.4f} "
                    f"hop_dq = {section['hop_dq']['mean']:.4f}"
                )

    if args.plots:
        from l2hmc_tpu_torch.analysis.plots import make_run_plots

        exact = None
        if args.beta is not None:
            from l2hmc_tpu_torch.lattice import u1

            exact = float(u1.u1_plaq_exact(args.beta))
        written = make_run_plots(args.run_dir, exact)
        print(f"wrote {len(written)} plots under "
              f"{Path(args.run_dir) / 'plots'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
