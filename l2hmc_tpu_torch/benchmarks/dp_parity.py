"""A data-parallel ``train_gauge`` run against a one-process run, record by
record, with cuDNN's and cuBLAS's TF32 on or off.

PyTorch leaves cuDNN's TF32 on by default, so the conv nets' products
round to ~1e-3, and differently at another per-rank batch; the accept
decisions then amplify the difference step by step.  With TF32 off an
n-rank run should follow the one-process run to float32 rounding, so the
two records first part where an accept decision flips.  Run the CLI
(under ``torchrun`` for n ranks) with TF32 set, then compare the run
dirs::

    python3 -m l2hmc_tpu_torch.benchmarks.dp_parity run --tf32 off -- \\
        @configs/gauge_8x8.txt --train_steps 100 --logging_steps 1 \\
        --log_dir build/dp1_off
    python3 -m torch.distributed.run --standalone --nproc_per_node=4 -m \\
        l2hmc_tpu_torch.benchmarks.dp_parity run --tf32 off -- ... \\
        --log_dir build/dp4_off
    python3 -m l2hmc_tpu_torch.benchmarks.dp_parity compare \\
        build/dp1_off/run_1 build/dp4_off/run_1

``compare`` prints one JSON line: per metric the largest relative
difference over the first 1, 10 and all records, the first record where
any metric parts by more than 1e-3, and the eval summaries' plaquettes.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

METRICS = ("loss", "accept_prob", "eps", "actions", "plaqs", "charges2")


def run(tf32: bool, argv) -> int:
    from l2hmc_tpu_torch.cli import train_gauge

    return train_gauge.main(list(argv), tf32=tf32)


def _records(run_dir: Path):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def compare(a: Path, b: Path) -> dict:
    ra, rb = _records(a), _records(b)
    if [r["step"] for r in ra] != [r["step"] for r in rb]:
        raise ValueError("the runs logged different steps")

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-12)

    diffs = [{k: rel(x[k], y[k]) for k in METRICS} for x, y in zip(ra, rb)]
    out = {"records": len(diffs), "steps": [ra[0]["step"], ra[-1]["step"]]}
    for n in (1, 10, len(diffs)):
        out[f"max_rel_first_{n}"] = {
            k: max(d[k] for d in diffs[:n]) for k in METRICS}
    parted = [r["step"] for r, d in zip(ra, diffs) if max(d.values()) > 1e-3]
    out["first_step_apart_1e-3"] = parted[0] if parted else None
    out["last"] = {k: [ra[-1][k], rb[-1][k]] for k in METRICS}
    for ev in sorted(a.glob("eval_beta*.json")):
        pa = json.loads(ev.read_text())["plaqs"]["mean"]
        pb = json.loads((b / ev.name).read_text())["plaqs"]["mean"]
        out[ev.stem + "_plaq"] = [pa, pb]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="train_gauge with TF32 set")
    r.add_argument("--tf32", choices=["on", "off"], required=True)
    r.add_argument("cli", nargs=argparse.REMAINDER,
                   help="train_gauge's arguments, after '--'")
    c = sub.add_parser("compare", help="two run dirs, record by record")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args(argv)
    if args.cmd == "run":
        cli = args.cli[1:] if args.cli[:1] == ["--"] else args.cli
        return run(args.tf32 == "on", cli)
    print(json.dumps(compare(Path(args.a), Path(args.b))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
