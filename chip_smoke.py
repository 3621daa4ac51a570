#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's sampling path once on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: name, ``nvidia-smi`` name and power limit; TF32 off.
2. Build: compile ``l2hmc_tpu_torch/ops/csrc/*.cu`` with nvcc (sm_90a).
3. Each kernel against its plain PyTorch version on the card, with the same
   injected randomness (numpy, seeded), 16x16, 2048 chains, 8 transitions,
   ``hop`` off and on: ``hmc_chain`` (K=5, eps=0.08) and ``l2hmc_chain``
   with the shipped champion's weights.  A chain whose accept decision is
   a near-tie (|u - prob| < 1e-4) may flip on rounding; it is reported and
   excluded, at most 1 in 64.
4. Main path: load the champion, thermalize 2048 chains at beta=4 from a
   cold start with ``hmc_chain_u1_fused`` (K=5, eps=0.08, 500 transitions),
   then sample 4 calls x 250 transitions each with the champion, the
   champion + instanton hop and HMC; check plaquettes against I1(4)/I0(4),
   the champion+hop <Q^2> against the exact finite-volume value, and that
   each kernel was launched; time each kernel and its plain version.

The last two lines are a JSON object of per-kernel results and the
``{"ok": true, "device": ...}`` line.  The script needs a CUDA device; it
never falls back to the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BETA = 4.0
HMC_K, HMC_EPS = 5, 0.08
SIDE = 16
MAIN_CHAINS, THERM_N, CALL_N, CALLS = 2048, 500, 250, 4
CHECK_CHAINS, CHECK_N = MAIN_CHAINS, 8   # the main path's shapes
# plain versions are eager PyTorch, bound by the host's launches, whose
# pace varies between windows: report the median of a few
PLAIN_N, PLAIN_REPS = 10, 5
# Kernel vs plain version on the same inputs.  The two differ only in the
# order of floating-point sums (block reductions vs torch's) and in CUDA's
# libm against torch's kernels, so float32 rounding (~1e-6 relative on the
# Hamiltonian, whose magnitude is ~1e3 here) sets the scale: 1e-4 on link
# angles (compared modulo 2 pi, since a wrap at +-pi may land on either
# side) and on accept probabilities.  Rounded charges must agree exactly.
ATOL = 1e-4
NEAR_TIE = 1e-4       # |u - prob| below this: the decision may flip
MAX_EXCLUDED = CHECK_CHAINS // 64
PLAQ_TOL = 1e-3
Q2_RTOL = 0.10


def log(msg):
    print(msg, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch.cuda.get_device_name: {name}; "
        f"count {torch.cuda.device_count()}")
    log("[device] nvidia-smi --query-gpu=name,power.limit:")
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, smi


def build_phase():
    from l2hmc_tpu_torch.ops import _cuda

    path, secs = _cuda.build()
    _cuda.library()
    log(f"[build] {path.relative_to(_cuda.BUILD_ROOT.parents[1])} "
        f"built in {secs:.1f} s (0 = already built)")


def angle_err(a, b):
    """Largest |a - b| modulo 2 pi."""
    d = torch.remainder(a - b + np.pi, 2 * np.pi) - np.pi
    return float(d.abs().max())


def check_kernel(name, kernel_out, plain_out, us):
    """Compare (links, plaq, charge, prob) of kernel and plain version;
    chains with a near-tie accept decision are excluded."""
    links_k, plaq_k, chg_k, prob_k = kernel_out
    links_p, plaq_p, chg_p, prob_p = plain_out
    tie = ((us - prob_p).abs() < NEAR_TIE).any(dim=0)
    n_ex = int(tie.sum())
    if n_ex > MAX_EXCLUDED:
        raise AssertionError(f"{name}: {n_ex} chains hit a near-tie accept "
                             f"decision (at most {MAX_EXCLUDED} allowed)")
    keep = ~tie
    err_links = angle_err(links_k[keep], links_p[keep])
    err_prob = float((prob_k[:, keep] - prob_p[:, keep]).abs().max())
    err_plaq = float((plaq_k[:, keep] - plaq_p[:, keep]).abs().max())
    same_q = bool(torch.equal(chg_k[:, keep], chg_p[:, keep]))
    log(f"[check] {name}: max|dlinks| {err_links:.3e}  max|dprob| "
        f"{err_prob:.3e}  max|dplaq| {err_plaq:.3e}  charges equal "
        f"{same_q}  excluded {n_ex}/{us.shape[1]}  mean prob "
        f"{float(prob_p.mean()):.4f}")
    if not (err_links <= ATOL and err_prob <= ATOL and err_plaq <= ATOL
            and same_q):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (atol {ATOL})")
    return max(err_links, err_prob, err_plaq)


def check_phase(params, eps_c, K_c, device):
    """Phase 3: each kernel against its plain version, injected randomness."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain,
                                                  l2hmc_chain_reference)
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain, hmc_chain_reference

    rng = np.random.default_rng(1234)
    b, n, d = CHECK_CHAINS, CHECK_N, SIDE * SIDE
    # near-equilibrium links, <cos P> ~ 0.84, where the champion accepts
    links = torch.tensor(typical_links(rng, b, SIDE, SIDE, sigma=0.3),
                         device=device)

    def arr(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    v0s = arr(rng.standard_normal((n, b, d)))
    v1s = arr(rng.standard_normal((n, b, d)))
    ds = arr(rng.choice([-1.0, 1.0], (n, b)))
    us = arr(rng.uniform(size=(n, b)))
    nus = arr(rng.choice([-1.0, 1.0], (n, b)))
    uhs = arr(rng.uniform(size=(n, b)))
    errs = {"hmc_chain": 0.0, "l2hmc_chain": 0.0}
    for hop in (False, True):
        hop_arrays = (nus, uhs) if hop else None
        tag = "hop" if hop else "plain"
        rand = (v0s, v1s, us) + ((nus, uhs) if hop else ())
        out_k = hmc_chain(links, None, HMC_EPS, BETA, HMC_K, n, hop=hop,
                          rand_arrays=rand)
        out_p = hmc_chain_reference(links, v0s, v1s, us, HMC_EPS, BETA,
                                    HMC_K, hop_arrays=hop_arrays)
        torch.cuda.synchronize()
        errs["hmc_chain"] = max(errs["hmc_chain"], check_kernel(
            f"hmc_chain hop={hop}", out_k, out_p, us))
        rand = (v0s, v1s, ds, us) + ((nus, uhs) if hop else ())
        out_k = l2hmc_chain(links, params, None, eps_c, BETA, K_c, n,
                            hop=hop, rand_arrays=rand)
        out_p = l2hmc_chain_reference(links, params, v0s, v1s, ds, us,
                                      eps_c, BETA, K_c,
                                      hop_arrays=hop_arrays)
        torch.cuda.synchronize()
        errs["l2hmc_chain"] = max(errs["l2hmc_chain"], check_kernel(
            f"l2hmc_chain({tag}) champion", out_k, out_p, us))
    return errs


def timed(fn):
    """(result, milliseconds) of fn() on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main_phase(cfg, params, eps_c, device):
    """Phase 4: thermalize with HMC, then sample with all three samplers."""
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.lattice.u1 import (topological_susceptibility_exact,
                                            u1_plaq_exact)
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (
        draw_l2hmc_randomness, l2hmc_chain, l2hmc_chain_reference)
    from l2hmc_tpu_torch.ops.leapfrog import (draw_hmc_randomness,
                                              hmc_chain, hmc_chain_reference)

    K_c = cfg.num_steps
    gen = torch.Generator(device=device).manual_seed(20261016)
    hmc_chain.launches = 0
    l2hmc_chain.launches = 0

    links = torch.zeros((MAIN_CHAINS, SIDE, SIDE, 2), device=device)
    (links, pl, _, pr), ms = timed(lambda: hmc_chain_u1_fused(
        links, gen, HMC_EPS, BETA, HMC_K, THERM_N))
    log(f"[main] thermalized {MAIN_CHAINS} chains: {THERM_N} HMC transitions "
        f"in {ms:.1f} ms; last plaquette {float(pl[-1].mean()):.5f}, "
        f"accept {float(pr.mean()):.4f}")

    samplers = {
        "champion": (K_c, lambda x: l2hmc_chain(
            x, params, gen, eps_c, BETA, K_c, CALL_N, hop=False)),
        "champion+hop": (K_c, lambda x: l2hmc_chain(
            x, params, gen, eps_c, BETA, K_c, CALL_N, hop=True)),
        "hmc": (HMC_K, lambda x: hmc_chain_u1_fused(
            x, gen, HMC_EPS, BETA, HMC_K, CALL_N)),
    }
    plaq_exact = u1_plaq_exact(BETA)
    q2_exact = topological_susceptibility_exact(BETA, SIDE * SIDE)
    results = {}
    for name, (K, run) in samplers.items():
        x = links.clone()
        plaqs, chgs, probs, times = [], [], [], []
        for _ in range(CALLS):
            (x, pl, ch, pr), ms = timed(lambda: run(x))
            plaqs.append(pl)
            chgs.append(ch)
            probs.append(pr)
            times.append(ms)
        plaq = torch.cat(plaqs)
        chg = torch.cat(chgs)
        prob = torch.cat(probs)
        for t in (x, plaq, chg, prob):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: non-finite output")
        if x.shape != links.shape:
            raise AssertionError(f"{name}: links shape {tuple(x.shape)}")
        # first call is burn-in for the charge (HMC leaves Q ~ 0)
        ms_tr = float(np.mean(times[1:])) / CALL_N
        res = {
            "plaq": float(plaq.double().mean()),
            "q2": float((chg[CALL_N:].double() ** 2).mean()),
            "accept": float(prob.double().mean()),
            "us_per_transition": 1e3 * ms_tr,
            "lf_steps_per_s": K * MAIN_CHAINS / (ms_tr * 1e-3),
        }
        results[name] = res
        log(f"[main] {name}: kernel {res['us_per_transition']:.1f} us/"
            f"transition at {MAIN_CHAINS} chains = "
            f"{res['lf_steps_per_s']:.4g} lf-steps/s; accept "
            f"{res['accept']:.4f}; plaquette {res['plaq']:.6f} (exact "
            f"{plaq_exact:.6f}); <Q^2> {res['q2']:.4f} (exact {q2_exact:.4f})")
        if abs(res["plaq"] - plaq_exact) > PLAQ_TOL:
            raise AssertionError(f"{name}: plaquette {res['plaq']:.6f} not "
                                 f"within {PLAQ_TOL} of {plaq_exact:.6f}")
    q2 = results["champion+hop"]["q2"]
    if abs(q2 - q2_exact) > Q2_RTOL * q2_exact:
        raise AssertionError(f"champion+hop <Q^2> {q2:.4f} not within "
                             f"{Q2_RTOL:.0%} of {q2_exact:.4f}")
    launches = {"hmc_chain": hmc_chain.launches,
                "l2hmc_chain": l2hmc_chain.launches}
    log(f"[main] launches during the main path: {launches}")
    for k, v in launches.items():
        if v < 1:
            raise AssertionError(f"{k} was not launched on the main path")

    # plain versions at the same shape (CUDA tensors, injected randomness
    # drawn on the card outside the timed region)
    d = SIDE * SIDE

    def hmc_ref(n, hop=False):
        r = draw_hmc_randomness(gen, n, MAIN_CHAINS, d, hop, device)
        return lambda: hmc_chain_reference(
            links, *r[:3], HMC_EPS, BETA, HMC_K,
            hop_arrays=r[3:] if hop else None)

    def l2_ref(n, hop=False):
        r = draw_l2hmc_randomness(gen, n, MAIN_CHAINS, d, hop, device)
        return lambda: l2hmc_chain_reference(
            links, params, *r[:4], eps_c, BETA, K_c,
            hop_arrays=r[4:] if hop else None)

    plain = {}
    for name, make, K, hop in (("hmc", hmc_ref, HMC_K, False),
                               ("champion", l2_ref, K_c, False),
                               ("champion+hop", l2_ref, K_c, True)):
        make(1, hop)()
        fn = make(PLAIN_N, hop)
        windows = sorted(timed(fn)[1] / PLAIN_N for _ in range(PLAIN_REPS))
        ms_tr = windows[PLAIN_REPS // 2]
        plain[name] = ms_tr
        log(f"[main] {name} plain PyTorch version: {1e3 * ms_tr:.1f} us/"
            f"transition = {K * MAIN_CHAINS / (ms_tr * 1e-3):.4g} lf-steps/s "
            f"(median of {PLAIN_REPS} x {PLAIN_N} transitions, min "
            f"{1e3 * windows[0]:.1f}, max {1e3 * windows[-1]:.1f}); "
            f"kernel/plain speedup "
            f"{ms_tr * 1e3 / results[name]['us_per_transition']:.2f}x")
    return results, plain, launches


def main():
    name, smi = device_phase()
    device = torch.device("cuda", 0)
    build_phase()

    from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
    from l2hmc_tpu_torch.train.checkpoint import load_champion
    from l2hmc_tpu_torch.train.gauge import build_dynamics

    cfg, params = load_champion(device=device)
    eps_c = float(get_eps(params, build_dynamics(cfg)[0]).detach())
    log(f"[check] champion {cfg.time_size}x{cfg.space_size} h{cfg.hidden} "
        f"K={cfg.num_steps} eps={eps_c}")
    errs = check_phase(params, eps_c, cfg.num_steps, device)
    results, plain, launches = main_phase(cfg, params, eps_c, device)

    kernels = [
        {"name": "hmc_chain", "route": "cuda",
         "source": "l2hmc_tpu_torch/ops/csrc/hmc_chain.cu",
         "replaces": "l2hmc_tpu/ops/leapfrog.py:310",
         "launches": launches["hmc_chain"],
         "max_abs_err": errs["hmc_chain"],
         "ms": results["hmc"]["us_per_transition"] * 1e-3,
         "plain_ms": plain["hmc"]},
        {"name": "l2hmc_chain", "route": "cuda",
         "source": "l2hmc_tpu_torch/ops/csrc/l2hmc_chain.cu",
         "replaces": "l2hmc_tpu/ops/l2hmc_kernel.py:672",
         "launches": launches["l2hmc_chain"],
         "max_abs_err": errs["l2hmc_chain"],
         "ms": results["champion"]["us_per_transition"] * 1e-3,
         "plain_ms": plain["champion"]},
    ]
    log("[result] ms and plain_ms are per transition of "
        f"{MAIN_CHAINS} chains at {SIDE}x{SIDE} on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"[done] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
