"""Readings behind the limits of ``correct``, in one process for many seeds.

    python3 bench_h100/control.py --workload <cell> --seeds 1 2 3 \\
        --mode control
    python3 bench_h100/control.py --workload <cell> --seeds 1 2 3 \\
        --mode program --seconds 1

``control``: the cell's control (``workloads/<cell>.json`` ``control``:
the plain reference in the next precision below the configuration's, TF32
products or bfloat16 arithmetic) put in the program's place for the
window's first call at the cell's own size, judged as the program is: the
upper readings.  ``program``: the program's own runs, each a short window
at the cell's load with the run's check: the lower readings.  One JSON
line per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=("control", "program"),
                   default="control")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--dump", default="",
                   help="a directory for each checked call's per-chain "
                        "readings (npz)")
    args = p.parse_args(argv)

    import torch

    from bench_h100 import run
    from bench_h100.lib import common
    from bench_h100.reference import chains

    device = torch.device(args.device)
    spec = common.load_json("workloads", args.workload)
    for seed in args.seeds:
        t = time.time()
        cells = []
        if args.mode == "program":
            result, _ = run.run_cell(args.workload, seed, args.seconds, 0,
                                     device, on_cell=cells.append)
            values = {k: v["value"] for k, v in result["checks"].items()}
        else:
            config = common.load_json("configs", spec["config"])
            traffic = common.load_json("traffic", spec["traffic"])
            ctx = SimpleNamespace(workload=args.workload, seed=seed,
                                  device=device, config=config,
                                  traffic=traffic)
            chains.float32_only()
            cell = common.load_module("drivers", traffic["driver"]).Cell(ctx)
            cell.setup()
            values = cell.control(spec["limits"],
                                  chains.Precision(spec["control"]))
            cells.append(cell)
        if args.dump:
            dump(Path(args.dump), args.workload, args.mode, seed, cells[0])
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "seconds": round(time.time() - t, 1),
                          "values": values}), flush=True)


def dump(where: Path, workload, mode, seed, cell):
    import numpy as np

    where.mkdir(parents=True, exist_ok=True)
    for name, s in getattr(cell, "summaries", []):
        np.savez_compressed(
            where / f"{workload}.{mode}.{seed}.{name}.npz",
            **{k: v.detach().cpu().numpy() for k, v in s.items()})


if __name__ == "__main__":
    main()
