"""Per-class issue estimate of the chain kernels' L2HMC machinery on the card.

Port of ``benchmarks/vpu_roofline.py``.  Three parts:

1. **Exact op counts.**  :func:`count_ops` runs a function under a
   ``TorchDispatchMode`` and sums the output elements of every aten op by
   class (:data:`CLASSES`, :data:`CHEAP`), the counterpart of the JAX
   script's jaxpr walk.  Matrix products count their multiply-adds (m n k)
   in a class ``mm``, which the jaxpr walk leaves out.  The kernels and
   their plain versions share one transition-math function, so the counts
   of ``_l2hmc_transition_math(ablate_nets=True)`` and the HMC
   ``_transition_math`` (:func:`transition_op_counts`) are the kernels' own;
   machinery = their difference.  Counts run on the ``meta`` device: shapes
   only, no arithmetic.
2. **Measured per-class rates.**  A dependency chain of ``m`` steps of one
   probe body (``ops/issue_rates.py``) is timed at two lengths with CUDA
   events; the slope is the time per step.  :func:`rates_from_slopes` turns
   the slopes into elements per second per class, subtracting the cheap ops
   of each body at the measured cheap rate with a floor of 0.2 of the raw
   time.  :func:`measure_rates_kernel` runs the chains in
   ``csrc/issue_rates.cu`` (the counterpart of the JAX script's Pallas
   rates); :func:`measure_rates` in eager PyTorch (the counterpart of its
   XLA rates, here bound by the host's launches).
3. **Estimate against measurement.**  :func:`issue_estimate` is the
   serial-issue sum ``sum_c count_c / rate_c``, with ``mm`` multiply-adds at
   the FFMA rate (half the cheap rate, which counts an FFMA as 2 ops) and
   each sin/cos pair charged as one trig op.  With ``--measure_kernel`` the
   script prints it beside the measured ablated minus HMC time of the
   kernels.  The JSON keys keep the JAX script's names (``bound_*_us``).

It is an estimate, not a bound, and errs both ways.  Under: the cheap class
counts every add, mul and select as one op at the rate of a body that nvcc
contracts into one FFMA (2 ops), so an uncontracted op costs about twice
what it is charged; the load/store issue of the weights and of the
shared-memory fields is not counted at all.  Over: the sum is serial, while
the MUFU (exp, log and trig approximations), FMA and load/store pipes issue
side by side and overlap.  The op counts keep one trig op per ``sin`` and
per ``cos``, as the JAX walk does; every sin in the transition math has a
cos of the same argument beside it, which the kernels compute with one
``sincosf``, so the estimate charges the pair once, at the ``sin`` probe's
rate (a ``sincosf`` also evaluates a second polynomial: under).

Usage (on the card)::

    python3 -m l2hmc_tpu_torch.benchmarks.vpu_roofline [--size 16]
        [--chains 2048] [--num_steps 3] [--measure_kernel]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from l2hmc_tpu_torch.ops.issue_rates import (PROBES, probe_chain,
                                             probe_chain_reference)

# aten op name -> op class; anything else that is not CHEAP is layout or
# allocation (copies, views, rolls, fills) and is not counted
CLASSES = {
    "exp": "exp", "tanh": "exp",         # tanh: same class as in the JAX walk
    "sin": "trig", "cos": "trig",
    "log": "log",
    "div": "div", "reciprocal": "div", "rsqrt": "div", "sqrt": "div",
    "floor": "floor", "round": "floor",
    "atan2": "atan2",
}
CHEAP = {
    "add", "sub", "rsub", "mul", "neg", "abs", "maximum", "minimum",
    "clamp", "clamp_max", "clamp_min", "where", "sign", "eq", "ne", "ge",
    "gt", "le", "lt", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "pow", "square", "relu", "_to_copy", "sum", "amax", "amin", "isfinite",
    "isinf", "isnan", "arange",
}
# matrix products: multiply-adds = output elements x contraction length
MM = {"mm", "addmm", "bmm", "baddbmm"}


def _trace(msg):
    print(f"[vpu {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}
        self.by_op = {}

    def _add(self, cls, n, name):
        self.counts[cls] = self.counts.get(cls, 0) + n
        self.by_op[name] = self.by_op.get(name, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.endswith("__"):
            name = name[:-1]                 # in-place form of the same op
        first = out[0] if isinstance(out, (tuple, list)) else out
        if not isinstance(first, torch.Tensor):
            return out
        n = first.numel()
        if name in MM:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            self._add("mm", n * int(a.shape[-1]), name)
        elif name in CLASSES:
            self._add(CLASSES[name], n, name)
        elif name in CHEAP:
            self._add("cheap", n, name)
        return out


def count_ops(fn, *args, by_op=False):
    """``{class: elements}`` of the aten ops ``fn(*args)`` runs, or with
    ``by_op`` ``{aten op name: elements}`` of the counted ops."""
    with _OpCounter() as counter:
        fn(*args)
    return counter.by_op if by_op else counter.counts


def _mlp_weights(lt, lx, K, hidden, device):
    from l2hmc_tpu_torch.ops.l2hmc_kernel import WEIGHT_NAMES, pack_weights
    from l2hmc_tpu_torch.train.gauge import GaugeConfig, init_params

    cfg = GaugeConfig(time_size=lt, space_size=lx, num_steps=K,
                      network_arch="mlp", num_hidden=hidden,
                      merge_v_halves=True, eps_init=0.1, eps_trainable=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return SimpleNamespace(**{n: w.to(device) for n, w in zip(
        WEIGHT_NAMES, pack_weights(params, 2 * lt * lx))})


def _local_weights(lt, lx, K, channels, layers, device):
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (local_weight_names,
                                                  pack_local_weights)
    from l2hmc_tpu_torch.train.gauge import GaugeConfig, init_params

    cfg = GaugeConfig(time_size=lt, space_size=lx, num_steps=K,
                      network_arch="local_flat", num_filters=channels,
                      local_layers=layers, merge_v_halves=True, eps_init=0.1,
                      eps_trainable=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return SimpleNamespace(**{n: w.to(device) for n, w in zip(
        local_weight_names(layers),
        pack_local_weights(params, 2 * lt * lx, layers))})


def op_counts(kind, b, lt, lx, K, hidden=64, channels=4, layers=1,
              by_op=False):
    """Per-transition op counts of one chain kernel's transition math on
    ``b`` chains of ``lt x lx`` at ``K`` leapfrog steps.  ``kind``:
    ``'ablated'`` (nets ablated, either family), ``'mlp'`` (the trained MLP
    conditioner of width ``hidden``), ``'local'`` (the stencil conditioner of
    ``channels`` x ``layers``) or ``'hmc'``; ``by_op``: by aten op name."""
    from l2hmc_tpu_torch.ops.l2hmc_kernel import _l2hmc_transition_math
    from l2hmc_tpu_torch.ops.leapfrog import _transition_math

    dev = torch.device("meta")
    d = lt * lx
    z = torch.zeros((b, d), device=dev)
    zb = torch.zeros((b,), device=dev)
    if kind == "hmc":
        return count_ops(lambda: _transition_math(
            z, z, z, z, zb, 0.1, 4.0, K, lx, zb, z, zb, z), by_op=by_op)
    if kind in ("ablated", "mlp"):
        W, local_layers = _mlp_weights(lt, lx, K, hidden, dev), 0
    elif kind == "local":
        W = _local_weights(lt, lx, K, channels, layers, dev)
        local_layers = layers
    else:
        raise ValueError(f"kind={kind!r}")
    return count_ops(lambda: _l2hmc_transition_math(
        z, z, z, z, zb, zb, W, 0.1, 4.0, K, lx, True, zb, z, zb, z,
        local_layers=local_layers, ablate_nets=kind == "ablated"),
        by_op=by_op)


def transition_op_counts(b, lt, lx, K):
    """Per-transition element counts of (a) the ablated trained transition
    (the whole L2HMC machinery, no conditioner) and (b) the plain HMC
    transition, from the math the kernels and plain versions share."""
    return op_counts("ablated", b, lt, lx, K), op_counts("hmc", b, lt, lx, K)


def rates_from_slopes(slopes, elems):
    """Elements per second per op class from the seconds per chain step of
    each probe (``slopes``, by :data:`PROBES` name) over ``elems``
    elements.  cheap: ``n_target / t``; every other class: ``1 / max(t -
    n_cheap t_cheap, 0.2 t)`` with ``t`` the time per element and step and
    ``t_cheap`` the time of one cheap op (the JAX script's arithmetic)."""
    probes = {p.name: p for p in PROBES}
    t_cheap = slopes["cheap"] / elems / probes["cheap"].n_target
    rates = {"cheap": 1.0 / t_cheap}
    for name, slope in slopes.items():
        if name == "cheap":
            continue
        t_step = slope / elems
        rates[name] = 1.0 / max(t_step - probes[name].n_cheap * t_cheap,
                                0.2 * t_step)
    return rates


def _slopes(run, b, d, m_lo, m_hi, reps, device, inner=1):
    """Seconds per chain step of every probe from the two-length slope of
    ``run(x, probe, m)``'s CUDA-event times."""
    from l2hmc_tpu_torch.benchmarks import best_ms

    x0 = torch.full((b, d), 0.5, dtype=torch.float32, device=device)
    slopes = {}
    for p in PROBES:
        ts = {m: best_ms(lambda: run(x0, p.name, m), reps, inner) * 1e-3
              for m in (m_lo, m_hi)}
        slopes[p.name] = max(ts[m_hi] - ts[m_lo], 1e-12) / (m_hi - m_lo)
    return slopes


def measure_rates_kernel(b, d, reps=2, m_lo=8192, m_hi=32768, inner=4,
                         device=None):
    """Per-class rates (elements/s) measured inside ``csrc/issue_rates.cu``
    on a ``(b, d)`` array; returns ``(rates, slopes)``.  Each length is
    timed over ``inner`` back-to-back launches: a launch costs the host
    ~50 us (H100 machine), so the fastest chain (cheap, ~16 ns per step at
    (2048, 256)) needs m >= 8192 for its device time to hide it."""
    slopes = _slopes(probe_chain, b, d, m_lo, m_hi, reps, device or "cuda",
                     inner)
    return rates_from_slopes(slopes, b * d), slopes


def measure_rates(b, d, reps=3, m_lo=64, m_hi=512, device=None):
    """Per-class rates (elements/s) of the plain eager chains (one launch
    per op of each step, so the host's launch rate bounds them); returns
    ``(rates, slopes)``."""
    slopes = _slopes(probe_chain_reference, b, d, m_lo, m_hi, reps,
                     device or "cuda")
    return rates_from_slopes(slopes, b * d), slopes


def issue_estimate(counts, rates):
    """Seconds: ``sum_c counts[c] / rates[c]`` with the trig count halved
    (one ``sincosf`` per sin/cos pair), plus the ``mm`` multiply-adds at the
    FFMA rate (``rates['cheap'] / 2``)."""
    t = sum(counts.get(k, 0) / r for k, r in rates.items())
    t -= 0.5 * counts.get("trig", 0) / rates["trig"]
    return t + counts.get("mm", 0) / (rates["cheap"] / 2.0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--chains", type=int, default=2048)
    p.add_argument("--num_steps", type=int, default=3)
    p.add_argument("--measure_kernel", action="store_true",
                   help="also time the ablated and full trained kernels and "
                        "HMC at the same K for the measured machinery time "
                        "next to the estimate")
    args = p.parse_args(argv)
    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.benchmarks import device_info

    device = resolve_device(None)
    lt = lx = args.size
    b, d, K = args.chains, lt * lx, args.num_steps

    c_abl, c_hmc = transition_op_counts(b, lt, lx, K)
    delta = {k: c_abl.get(k, 0) - c_hmc.get(k, 0)
             for k in set(c_abl) | set(c_hmc)}
    _trace(f"ablated counts: {c_abl}")
    _trace(f"hmc counts:     {c_hmc}")
    _trace(f"machinery delta: {delta}")

    rates, _ = measure_rates_kernel(b, d, device=device)
    rates_plain, _ = measure_rates(b, d, device=device)
    for name in rates:
        _trace(f"{name}: kernel {rates[name] / 1e9:.2f} Gelem/s, plain "
               f"{rates_plain[name] / 1e9:.3f} Gelem/s")

    bound_machinery = issue_estimate(delta, rates)
    result = {
        "benchmark": "vpu_roofline",
        "device": device_info(),
        "config": {"size": args.size, "chains": b, "K": K},
        "counts_ablated": c_abl,
        "counts_hmc": c_hmc,
        "counts_machinery_delta": delta,
        "rates_gelem_per_s_kernel": {k: v / 1e9 for k, v in rates.items()},
        "rates_gelem_per_s_plain": {k: v / 1e9
                                    for k, v in rates_plain.items()},
        "bound_machinery_us": bound_machinery * 1e6,
        "bound_ablated_us": issue_estimate(c_abl, rates) * 1e6,
        "bound_hmc_us": issue_estimate(c_hmc, rates) * 1e6,
    }

    if args.measure_kernel:
        from l2hmc_tpu_torch.benchmarks.kernel_decomposition import (
            time_variants)
        from l2hmc_tpu_torch.lattice import u1
        from l2hmc_tpu_torch.train.gauge import GaugeConfig, init_params

        cfg = GaugeConfig(time_size=lt, space_size=lx, num_chains=b,
                          num_steps=K, network_arch="mlp", num_hidden=64,
                          merge_v_halves=True, eps_init=0.125,
                          eps_trainable=False)
        gen = torch.Generator(device=device).manual_seed(1)
        params = init_params(cfg, torch.Generator().manual_seed(1),
                             device=device)
        links = u1.to_links(u1.random_links(gen, b, cfg.shape,
                                            device=device), cfg.shape)
        meas = time_variants(links, params, gen, 0.125, 4.0, K, 500,
                             ("full", "ablated", "hmc"))
        machinery = meas["ablated"] - meas["hmc"]
        result.update(
            measured_full_us=meas["full"] * 1e6,
            measured_ablated_us=meas["ablated"] * 1e6,
            measured_hmc_us=meas["hmc"] * 1e6,
            measured_machinery_us=machinery * 1e6,
            machinery_measured_over_bound=machinery / max(bound_machinery,
                                                          1e-12),
        )

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
