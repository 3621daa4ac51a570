"""Each cell for a few seconds on the card, as the check runs it (one
process per run, the line last).  Marked ``cuda``: skips without a card
(decided inside the test), and the four-card cell without four.  Run on
the chip from the repository root::

    python -m pytest bench_h100/tests/test_bench_h100_cells.py -m cuda \\
        -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest

from bench_h100.lib import common

CELLS = [w["name"] for w in common.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(workload):
    import torch

    chips = common.load_json("workloads", workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    for trace in (0, 1):
        proc = subprocess.run(
            [sys.executable, "bench_h100/run.py", "--workload", workload,
             "--seed", str(2 ** 33 + 7 + trace), "--seconds", "3",
             "--trace", str(trace)], cwd=common.ROOT, capture_output=True,
            text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-4000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu"
        assert line["metrics"]
