"""Time variants of the Wilson forward and backward in turns on the card.

The variants (``wilson_variants.cu``, next to this file; listed at its top)
are forms that ``ops/csrc/wilson.cu`` took or could take: the form before
the routes, the kernel parameters as one struct or as ``__restrict__``
pointers, the site loop unrolled or not, 256 or 512 threads, sin P staged
by a TMA bulk copy or read from device memory.  Each is first held against
the plain version (sin P within 1e-6, S within 1e-5 relative, the force
exactly), then all are timed in turns, 9 rounds (in order, then reversed):
device time per launch by torch.profiler over 50 launches, the inputs
cycled through copies (the copies of sin P, the backward's input, more than
twice the L2).  Prints the medians per shape and one JSON line with the
card's name and power limit::

    python3 -m l2hmc_tpu_torch.benchmarks.wilson_variants

The source builds with ``nvcc`` into ``build/wilson_variants/`` (listed in
``.gitignore``).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from l2hmc_tpu_torch.benchmarks import device_info
from l2hmc_tpu_torch.benchmarks.wilson_routes import (
    L2_BYTES, device_us, rotated)

SOURCE = Path(__file__).resolve().with_name("wilson_variants.cu")
BUILD = Path(__file__).resolve().parents[2] / "build" / "wilson_variants"
SHAPES = ((128, 16, 16), (512, 64, 64), (8, 128, 128))
FORWARDS, BACKWARDS = 7, 4
ROUNDS = 9


def build() -> ctypes.CDLL:
    from l2hmc_tpu_torch.ops import _cuda

    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libwilson_variants.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(SOURCE)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    out.fwd_variant.argtypes = [i, p, p, p, i, i, i, p]
    out.bwd_variant.argtypes = [i, p, p, p, i, i, i, p]
    return out


def time_shape(lib, b: int, lt: int, lx: int, device) -> dict:
    """``{variant: median device us}`` at one shape."""
    from l2hmc_tpu_torch.ops import wilson as W

    rng = np.random.default_rng(b + lt * lx)
    links = torch.tensor(rng.uniform(-np.pi, np.pi, (b, lt, lx, 2)),
                         dtype=torch.float32, device=device)
    g = torch.full((b,), 4.0, device=device)
    s_ref, sinp = W.wilson_forward_reference(links)
    f_ref = W.wilson_backward_reference(sinp, g)
    one = (links, sinp.contiguous())
    sets = [one] + [tuple(t.clone() for t in one)
                    for _ in range(-(-2 * L2_BYTES // (4 * sinp.numel())) - 1)]
    action = torch.empty(b, device=device)
    sinp_out = torch.empty((b, lt, lx), device=device)
    force = torch.empty((b, lt, lx, 2), device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def fwd(v):
        return lambda l, s: lib.fwd_variant(
            v, l.data_ptr(), action.data_ptr(), sinp_out.data_ptr(), b, lt,
            lx, stream)

    def bwd(v):
        return lambda l, s: lib.bwd_variant(
            v, s.data_ptr(), g.data_ptr(), force.data_ptr(), b, lt, lx,
            stream)

    runs = {f"forward{v}": fwd(v) for v in range(FORWARDS)}
    runs.update({f"backward{v}": bwd(v) for v in range(BACKWARDS)})
    for name, fn in runs.items():
        if fn(*one) != 0:
            raise RuntimeError(f"{name} did not launch")
        torch.cuda.synchronize()
        if name.startswith("forward"):
            ok = (float((sinp_out - sinp).abs().max()) <= 1e-6 and
                  float(((action - s_ref).abs() / s_ref.abs()).max()) <= 1e-5)
        else:
            ok = torch.equal(force, f_ref)
        if not ok:
            raise AssertionError(f"{name} disagrees with the plain version")
    us = {name: [] for name in runs}
    for k in range(ROUNDS):
        for name in (list(runs) if k % 2 == 0 else list(runs)[::-1]):
            us[name].append(device_us(rotated(sets, runs[name])))
    return {"sets": len(sets),
            "us": {n: statistics.median(v) for n, v in us.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("wilson_variants needs a CUDA device")
    device = torch.device("cuda", 0)
    lib = build()
    results = {}
    for b, lt, lx in SHAPES:
        r = time_shape(lib, b, lt, lx, device)
        results[f"{b}x{lt}x{lx}"] = r
        print(f"[wilson_variants] ({b}, {lt}, {lx}, 2), {r['sets']} input "
              "copies: " + ", ".join(f"{n} {v:.3f}"
                                     for n, v in r["us"].items()) + " us",
              flush=True)
    print(json.dumps({"benchmark": "wilson_variants", "device": device_info(),
                      "rounds": ROUNDS, "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
