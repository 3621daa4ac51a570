"""What every part of the harness shares: where things are, finding a cell's
pieces by name, seeds derived from ``--seed``, the card's identity."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "l2hmc_tpu")
_MARKS = []


def mark(phase: str) -> None:
    """Ends the set-up phase ``phase`` now."""
    _MARKS.append((phase, time.time()))


def phases(t_start: float, t_end: float) -> list:
    """``[(phase, seconds)]`` of the phases marked since ``t_start``, the
    time after the last mark up to ``t_end`` as ``rest``; clears the
    marks."""
    out, t = [], t_start
    for name, at in _MARKS:
        out.append((name, at - t))
        t = at
    out.append(("rest", t_end - t))
    _MARKS.clear()
    return out


def load_json(kind: str, name: str) -> dict:
    """``bench_h100/<kind>/<name>.json``."""
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``bench_h100/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_h100_{kind}_{name.replace('.', '_')}", path)
    if spec.name in sys.modules:
        return sys.modules[spec.name]
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads(BENCHMARK_JSON.read_text())


def cell_metrics(workload: str, trace: bool) -> list:
    """The metric entries of ``BENCHMARK.json`` this cell reports: its
    end-to-end ones with ``--trace 0``, its per-layer ones with ``1``."""
    spec = benchmark()
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries
            if workload in m.get("workloads", [workload])]


def derive_seed(seed: int, *keys: int) -> int:
    """A 62-bit seed from ``--seed`` and ``keys`` (e.g. a call index)."""
    words = np.random.SeedSequence([seed, *keys]).generate_state(2, np.uint32)
    return (int(words[0]) << 30 ^ int(words[1])) & ((1 << 62) - 1)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: the port ``l2hmc_tpu_torch`` is not ``l2hmc_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def plaquette_at(beta: float) -> float:
    """The infinite-volume plaquette ``I1(beta) / I0(beta)``."""
    import torch

    b = torch.tensor(beta, dtype=torch.float64)
    return float(torch.special.i1e(b) / torch.special.i0e(b))


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
