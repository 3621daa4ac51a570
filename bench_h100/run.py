"""The benchmark of ``l2hmc_tpu_torch`` (the PyTorch/CUDA port) on NVIDIA
H100 cards.  From the root of a checkout::

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` and prints one JSON line last: whether
the window's answers matched the plain reference (``correct``), the
calls made and judged wrong, the cell's end-to-end metrics (``--trace 0``)
or its per-layer metrics read from a ``torch.profiler`` trace of the
window (``--trace 1``), the card and, last, each number that decided
``correct`` beside its limit (also the last lines on stderr, after the
seconds of each set-up phase).

Everything a cell is comes from files found by name: ``workloads/<cell>``
names its configuration (``configs/``), its traffic (``traffic/``, whose
``driver`` is ``drivers/<driver>.py``) and its limits; each per-layer
metric is ``metrics/<metric>.py``; the work behind the rooflines is
``counts/<config>.py``.

The run exits non-zero without a line when there is no CUDA card, or too
few, and when JAX or the JAX package ``l2hmc_tpu`` was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

NO_CARD, FORBIDDEN_LOADED = 2, 3


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the kernel library builds into ``build/kernels`` there itself)."""
    base = ROOT / "build" / "bench_h100_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def _cards_missing(chips: int):
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch.cuda.device_count() "
                f"is {torch.cuda.device_count()}")
    return None


def run_cell(workload, seed, seconds, trace, device, t_start=None,
             overrides=None, on_cell=None):
    """Set up, measure, check.  Returns ``(result, checks)``;
    ``overrides`` (``{'config': {...}, 'traffic': {...}}``) shrink a cell
    for the CPU tests; ``on_cell(cell)`` sees the driver's cell after its
    check."""
    import torch

    from bench_h100.lib import common, readings
    from bench_h100.lib.trace import WINDOW_SPAN, profiled, reduce, span
    from bench_h100.reference import chains, judge

    t_start = time.time() if t_start is None else t_start
    spec = common.load_json("workloads", workload)
    over = overrides or {}
    config = {**common.load_json("configs", spec["config"]),
              **over.get("config", {})}
    traffic = {**common.load_json("traffic", spec["traffic"]),
               **over.get("traffic", {})}
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    ctx = SimpleNamespace(workload=workload, seed=seed, device=device,
                          config=config, traffic=traffic)
    from l2hmc_tpu_torch._device import float32_matmuls

    float32_matmuls()
    chains.float32_only()
    common.mark("harness and program imports")
    cell = common.load_module("drivers", traffic["driver"]).Cell(ctx)
    cell.setup()
    common.sync(device)
    with profiled(trace) as prof:
        with span(WINDOW_SPAN):
            t0 = time.perf_counter()
            setup_s = time.time() - t_start
            steps = 0
            while steps == 0 or time.perf_counter() < t0 + seconds:
                with span("bench.step"):
                    cell.step()
                steps += 1
            cell.drain()
            window_s = time.perf_counter() - t0
    phases = common.phases(t_start, t_start + setup_s)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = reduce(prof) if prof is not None else None
    del prof
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = cell.judge(spec["limits"])
    ok = judge.correct(checks)
    if on_cell is not None:
        on_cell(cell)

    metrics = {}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": cell.attempted,
              "failed": cell.failed}
    wanted = common.cell_metrics(workload, bool(trace))
    result_breakdown = None
    if not trace:
        values = {"chain_transitions_per_s": cell.transitions / window_s,
                  "setup_s": setup_s}
        for m in wanted:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    elif traced is not None:
        r = readings.Reading(trace=traced, config=config,
                             config_name=spec["config"], work=cell.work(),
                             window_s=window_s)
        for m in wanted:
            v = common.load_module("metrics", m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result_breakdown = traced.breakdown()
        result_breakdown["bound_by"] = readings.bound_by(r)
    else:
        device_info.update(busy_s=0.0, window_s=window_s)
    result["metrics"] = metrics
    result["device"] = device_info
    print("setup phases (s): " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in phases),
          file=sys.stderr, flush=True)
    print(f"window: {window_s:.3f} s, calls in flight "
          f"{cell.work().get('in_flight')}", file=sys.stderr, flush=True)
    if result_breakdown is not None:
        result["breakdown"] = {k: result_breakdown[k]
                               for k in ("device_ops", "idle_gaps")}
        print(f"traced: {cell.work()['kernel']} bound by "
              f"{result_breakdown['bound_by']}; card "
              f"{common.power_limit() if cuda else 'cpu'}",
              file=sys.stderr, flush=True)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def check_lines(checks) -> list:
    return [f"check {k}: {v!r} (limit {lim!r})"
            for k, (v, lim) in checks.items()]


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from bench_h100.lib import common

    _caches()
    chips = common.load_json("workloads", args.workload)["chips"]
    missing = _cards_missing(chips)
    common.mark("torch import")
    if missing:
        print(f"bench_h100: {missing}; no result", file=sys.stderr)
        return NO_CARD
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    common.mark("CUDA context")
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              args.trace, device, T_START)
    found = common.forbidden_modules()
    if found:
        print(f"bench_h100: loaded {found} (JAX or the JAX package); no "
              "result", file=sys.stderr)
        return FORBIDDEN_LOADED
    print("\n".join(check_lines(checks)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
