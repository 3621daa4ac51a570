"""Time each route of the Wilson kernels (``csrc/wilson.cu``) on the card.

For every (chains, Lt, Lx) of ``SHAPES`` and every kernel (forward,
action-only forward, backward, fused force, double backward), each route
that can hold the lattice (``ops/wilson.py wilson_plan``) is timed in turns
(the routes in order, then reversed): device time per launch by
torch.profiler over 50 launches, the smaller of the two turns.  The route
that ``wilson_plan`` picks for the kernel is marked.  One JSON line, with
the card's name and power limit::

    python3 -m l2hmc_tpu_torch.benchmarks.wilson_routes

Links are uniform in [-pi, pi), g = 4, w standard normal (seeded numpy).
The launches cycle through copies of the inputs, so many that the copies of
each kernel's inputs together exceed twice the card's L2: each launch reads
its inputs from device memory, as the bytes bound (chip_smoke.py
``wilson_bounds``) assumes.
"""

from __future__ import annotations

import itertools
import json
import math
from unittest import mock

import numpy as np
import torch

from l2hmc_tpu_torch.benchmarks import device_info, device_profile

SHAPES = ((128, 16, 16), (512, 16, 16), (2048, 16, 16), (128, 32, 32),
          (512, 32, 32), (512, 64, 64), (8, 128, 128))
LAUNCHES = 50
L2_BYTES = 50 * 2 ** 20         # the H100's L2


def device_us(fn, launches: int = LAUNCHES) -> float:
    """Device time per call of ``fn`` in us from torch.profiler's CUDA
    activity over ``launches`` calls after one warm-up call (NaN if two
    windows record none)."""
    fn()
    torch.cuda.synchronize()
    prof = device_profile(fn, launches)
    return float("nan") if prof is None else 1e3 * prof[0]


def input_sets(b: int, lt: int, lx: int, device, seed: int = 0):
    """Copies of one set of Wilson inputs ``(links, g, w, sinp)`` at (b,
    lt, lx, 2), as many as make the copies of sin P, the smallest input a
    kernel reads, exceed twice ``L2_BYTES``."""
    from l2hmc_tpu_torch.ops import wilson as W

    rng = np.random.default_rng(seed)
    links = torch.tensor(rng.uniform(-np.pi, np.pi, (b, lt, lx, 2)),
                         dtype=torch.float32, device=device)
    w = torch.tensor(rng.standard_normal((b, lt, lx, 2)),
                     dtype=torch.float32, device=device)
    g = torch.full((b,), 4.0, device=device)
    sinp = W.wilson_forward_reference(links)[1].contiguous()
    one = (links, g, w, sinp)
    return [one] + [tuple(t.clone() for t in one)
                    for _ in range(-(-2 * L2_BYTES // (4 * sinp.numel())) - 1)]


def rotated(sets, fn):
    """A call of ``fn(*inputs)`` on the next set of ``sets`` each time."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def routes_of(b: int, lt: int, lx: int):
    """The routes that can run the lattice, in ``WILSON_ROUTES`` order."""
    from l2hmc_tpu_torch.ops import wilson as W

    out = []
    for route in W.WILSON_ROUTES:
        try:
            W.wilson_plan(b, lt, lx, route)
        except ValueError:
            continue
        out.append(route)
    return out


def on_route(route):
    """A context in which the Wilson wrappers launch on ``route``."""
    from l2hmc_tpu_torch.ops import wilson as W

    plan = W.wilson_plan.__wrapped__
    return mock.patch.object(W, "wilson_plan",
                             lambda b, lt, lx: plan(b, lt, lx, route))


def time_routes(b: int, lt: int, lx: int, device) -> dict:
    """``{kernel: {route: us}}`` at one shape, and each kernel's planned
    route."""
    from l2hmc_tpu_torch.ops import wilson as W

    sets = input_sets(b, lt, lx, device, seed=b + lt * lx)
    kernels = {
        "forward": lambda l, g, w, s: W.wilson_forward(l),
        "action_only": lambda l, g, w, s: W.wilson_action_only(l),
        "backward": lambda l, g, w, s: W.wilson_backward(s, g),
        "force": lambda l, g, w, s: W.wilson_force(l, g),
        "double_backward": lambda l, g, w, s: W.wilson_double_backward(
            l, g, w),
    }
    routes = routes_of(b, lt, lx)
    out = {}
    for name, fn in kernels.items():
        us = {r: [] for r in routes}
        for route in routes + routes[::-1]:
            with on_route(route):
                us[route].append(device_us(rotated(sets, fn)))
        out[name] = {r: min((x for x in v if not math.isnan(x)),
                            default=float("nan")) for r, v in us.items()}
    return {"planned": W.wilson_plan(b, lt, lx).routes, "sets": len(sets),
            "us": out}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("wilson_routes needs a CUDA device")
    device = torch.device("cuda", 0)
    results = {}
    for b, lt, lx in SHAPES:
        r = time_routes(b, lt, lx, device)
        results[f"{b}x{lt}x{lx}"] = r
        for name, us in r["us"].items():
            txt = ", ".join(
                f"{k}{'*' if k == r['planned'][name] else ''} {v:.2f}"
                for k, v in us.items())
            print(f"[wilson_routes] ({b}, {lt}, {lx}, 2) {name}: {txt} us",
                  flush=True)
    print(json.dumps({"benchmark": "wilson_routes", "device": device_info(),
                      "launches": LAUNCHES, "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
