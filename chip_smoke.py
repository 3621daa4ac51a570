#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's sampling paths once on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: name, ``nvidia-smi`` name and power limit; TF32 off.
2. Build: compile ``l2hmc_tpu_torch/ops/csrc/*.cu`` with nvcc (sm_90a), one
   process per source; print ptxas's registers and spills per kernel.
3. Each kernel against its plain PyTorch version on the card, with the same
   injected randomness (numpy, seeded), ``hop`` off and on:
   ``hmc_chain`` (K=5, eps=0.08) and ``l2hmc_chain`` with the shipped
   champion's weights at 16x16, 2048 chains, 8 transitions; and at 64x64,
   512 chains, 4 transitions: ``hmc_chain`` at local64's K=8, eps=0.04552,
   and ``l2hmc_local_chain`` at stencil depth L=1 and 2 (c=4, K=4,
   eps=0.01, where these weights accept ~0.3-0.6), weights from the port's
   init perturbed by a seeded N(0, 0.05^2).  A
   chain whose accept decision is a near-tie (|u - prob| < 1e-4) may flip
   on rounding; it is reported and excluded, at most 1 in 64.
4. Main path "champion" (16x16): load the champion, thermalize 2048 chains
   at beta=4 from a cold start with ``hmc_chain_u1_fused`` (K=5, eps=0.08,
   500 transitions), then sample 4 calls x 250 transitions each with the
   champion, the champion + instanton hop and HMC.
5. Main path "local64" (the config of benchmarks/local64_h2h.py): 64x64,
   ``local_flat`` c=4 L=1 from the port's seeded init, K=4, eps=0.10014,
   512 chains warm-started by 1500 checkerboard Metropolis sweeps at beta=4,
   then 4 calls x 250 transitions each of the local sampler, the local
   sampler + hop, and HMC (K=8, eps=0.04552).

Each main path checks plaquettes against I1(4)/I0(4), the hop sampler's
<Q^2> against the exact finite-volume value, and that its kernels were
launched (counts set to 0 just before the path and read just after); it
times each kernel and its plain version.  Acceptance: HMC and the trained
16x16 samplers must exceed 0.05; the untrained local64 samplers, whose
acceptance depends on the init seed, must match their plain version's on
the same warm-start links within 5 standard errors.  At 64x64 the Metropolis
warm start already equilibrates Q, so <Q^2> cannot tell a broken hop; there
the hop sampler must also change the rounded charge in at least 10x as
many transitions as the local sampler without it.

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
PLAQ_TOL = 1e-3
Q2_RTOL = 0.10
MIN_ACCEPT = 0.05
# kernel (Philox) vs plain (torch randomness) mean acceptance: standard
# errors from the spread of per-chain means, which holds for correlated
# transitions of one chain
ACCEPT_NSE = 5.0
# transitions changing the rounded charge: hop sampler / sampler without it
Q_HOP_RATIO = 10
CALL_N, CALLS = 250, 4
# 16x16 champion path
HMC_K, HMC_EPS = 5, 0.08
SIDE = 16
MAIN_CHAINS, THERM_N = 2048, 500
CHECK_CHAINS, CHECK_N = MAIN_CHAINS, 8   # the main path's shapes
# 64x64 local64 path (benchmarks/local64_h2h.py defaults)
L64_SIDE, L64_CHAINS, L64_K, L64_EPS = 64, 512, 4, 0.10014
L64_CHANNELS, L64_LAYERS = 4, 1
L64_HMC_K, L64_HMC_EPS = 8, 0.04552
L64_THERM_SWEEPS = 1500
L64_CHECK_N, L64_CHECK_EPS = 4, 0.01
# plain versions are eager PyTorch, bound by the host's launches, whose
# pace varies between windows: report the median of a few
PLAIN_N, PLAIN_REPS = 10, 5
L64_PLAIN_N, L64_PLAIN_REPS = 4, 5
# Kernel vs plain version on the same inputs.  The two differ only in the
# order of floating-point sums (block reductions vs torch's) and in CUDA's
# libm against torch's kernels, so float32 rounding (~1e-6 relative on the
# per-site energy terms) sets the scale: 1e-4 on link angles (compared
# modulo 2 pi, since a wrap at +-pi may land on either side) and on accept
# probabilities.  Rounded charges must agree exactly.
ATOL = 1e-4
NEAR_TIE = 1e-4       # |u - prob| below this: the decision may flip


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
    for line in _cuda.ptxas_report(path):
        log(f"[build] ptxas: {line}")


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
    max_excluded = us.shape[1] // 64
    if n_ex > max_excluded:
        raise AssertionError(f"{name}: {n_ex} chains hit a near-tie accept "
                             f"decision (at most {max_excluded} allowed)")
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


def injected(rng, n, b, d, device):
    """(v0s, v1s, ds, us, nus, uhs) made with numpy, on the card."""
    def arr(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return (arr(rng.standard_normal((n, b, d))),
            arr(rng.standard_normal((n, b, d))),
            arr(rng.choice([-1.0, 1.0], (n, b))),
            arr(rng.uniform(size=(n, b))),
            arr(rng.choice([-1.0, 1.0], (n, b))),
            arr(rng.uniform(size=(n, b))))


def check_phase(params, eps_c, K_c, device):
    """Phase 3, 16x16: the chain kernels against their plain versions."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain,
                                                  l2hmc_chain_reference)
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain, hmc_chain_reference

    rng = np.random.default_rng(1234)
    b, n, d = CHECK_CHAINS, CHECK_N, SIDE * SIDE
    # near-equilibrium links, <cos P> ~ 0.84, where the champion accepts
    links = torch.tensor(typical_links(rng, b, SIDE, SIDE, sigma=0.3),
                         device=device)
    v0s, v1s, ds, us, nus, uhs = injected(rng, n, b, d, device)
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


def local_cfg(layers):
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    return GaugeConfig(
        time_size=L64_SIDE, space_size=L64_SIDE, num_chains=L64_CHAINS,
        num_steps=L64_K, network_arch="local_flat", num_filters=L64_CHANNELS,
        local_layers=layers, merge_v_halves=True, eps_init=L64_EPS,
        eps_trainable=False, beta_final=BETA, bounded_q=True)


def local_check_phase(device):
    """Phase 3, 64x64: ``hmc_chain`` at local64's K and eps, and the
    local-stencil kernel at L=1 and 2, against their plain versions, hop off
    and on.  Returns ``{kernel: max error}``."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain_reference,
                                                  l2hmc_local_chain)
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain, hmc_chain_reference
    from l2hmc_tpu_torch.train.gauge import init_params

    rng = np.random.default_rng(4321)
    b, n, d = L64_CHAINS, L64_CHECK_N, L64_SIDE * L64_SIDE
    # <cos P> ~ exp(-2 sigma^2) = 0.864, the beta=4 equilibrium
    links = torch.tensor(typical_links(rng, b, L64_SIDE, L64_SIDE,
                                       sigma=0.27), device=device)
    v0s, v1s, ds, us, nus, uhs = injected(rng, n, b, d, device)
    errs = {"hmc_chain": 0.0, "l2hmc_local_chain": 0.0}
    for hop in (False, True):
        rand = (v0s, v1s, us) + ((nus, uhs) if hop else ())
        out_k = hmc_chain(links, None, L64_HMC_EPS, BETA, L64_HMC_K, n,
                          hop=hop, rand_arrays=rand)
        out_p = hmc_chain_reference(links, v0s, v1s, us, L64_HMC_EPS, BETA,
                                    L64_HMC_K,
                                    hop_arrays=(nus, uhs) if hop else None)
        torch.cuda.synchronize()
        errs["hmc_chain"] = max(errs["hmc_chain"], check_kernel(
            f"hmc_chain hop={hop} {L64_SIDE}x{L64_SIDE} K={L64_HMC_K}",
            out_k, out_p, us))
    for layers in (1, 2):
        gen = torch.Generator().manual_seed(60 + layers)
        params = init_params(local_cfg(layers), gen)
        with torch.no_grad():
            for net in (params.xnet, params.vnet):
                for p in net.parameters():
                    p.add_(0.05 * torch.randn(p.shape, generator=gen))
        params = params.to(device)
        for hop in (False, True):
            hop_arrays = (nus, uhs) if hop else None
            rand = (v0s, v1s, ds, us) + ((nus, uhs) if hop else ())
            out_k = l2hmc_local_chain(links, params, None, L64_CHECK_EPS,
                                      BETA, L64_K, n, layers, hop=hop,
                                      rand_arrays=rand)
            out_p = l2hmc_chain_reference(
                links, params, v0s, v1s, ds, us, L64_CHECK_EPS, BETA, L64_K,
                hop_arrays=hop_arrays, local_layers=layers)
            torch.cuda.synchronize()
            errs["l2hmc_local_chain"] = max(
                errs["l2hmc_local_chain"], check_kernel(
                    f"l2hmc_local_chain L={layers} hop={hop} {L64_SIDE}x"
                    f"{L64_SIDE} c={L64_CHANNELS}", out_k, out_p, us))
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


def accept_stats(prob):
    """Mean of a (N, B) accept-probability trace and its standard error
    from the spread of the B per-chain means."""
    per_chain = prob.double().mean(dim=0)
    return (float(per_chain.mean()),
            float(per_chain.std()) / np.sqrt(per_chain.numel()))


def run_samplers(path, links, samplers, chains, side, hop_sampler):
    """Sample CALLS x CALL_N transitions with each sampler ``name: (K,
    run, min_accept)`` from ``links``; check plaquette, acceptance (no floor
    where ``min_accept`` is None) and the hop sampler's <Q^2>.  Returns
    ``{name: result dict}``."""
    from l2hmc_tpu_torch.lattice.u1 import (topological_susceptibility_exact,
                                            u1_plaq_exact)

    plaq_exact = u1_plaq_exact(BETA)
    q2_exact = topological_susceptibility_exact(BETA, side * side)
    results = {}
    for name, (K, run, min_accept) in samplers.items():
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
                raise AssertionError(f"{path} {name}: non-finite output")
        if x.shape != links.shape:
            raise AssertionError(f"{path} {name}: links shape "
                                 f"{tuple(x.shape)}")
        # first call is burn-in for the charge
        ms_tr = float(np.mean(times[1:])) / CALL_N
        accept, accept_se = accept_stats(prob)
        res = {
            "plaq": float(plaq.double().mean()),
            "q2": float((chg[CALL_N:].double() ** 2).mean()),
            "q_changes": int((chg[1:] != chg[:-1]).sum()),
            "accept": accept,
            "accept_se": accept_se,
            "us_per_transition": 1e3 * ms_tr,
            "lf_steps_per_s": K * chains / (ms_tr * 1e-3),
        }
        results[name] = res
        log(f"[{path}] {name}: kernel {res['us_per_transition']:.1f} us/"
            f"transition at {chains} chains = "
            f"{res['lf_steps_per_s']:.4g} lf-steps/s; accept "
            f"{res['accept']:.4f} +- {res['accept_se']:.4f}; plaquette "
            f"{res['plaq']:.6f} (exact {plaq_exact:.6f}); <Q^2> "
            f"{res['q2']:.4f} (exact {q2_exact:.4f}); charge changed in "
            f"{res['q_changes']} of {chg.shape[0] - 1} x {chains} transitions")
        if abs(res["plaq"] - plaq_exact) > PLAQ_TOL:
            raise AssertionError(f"{path} {name}: plaquette {res['plaq']:.6f}"
                                 f" not within {PLAQ_TOL} of "
                                 f"{plaq_exact:.6f}")
        if min_accept is not None and res["accept"] <= min_accept:
            raise AssertionError(f"{path} {name}: acceptance "
                                 f"{res['accept']:.4f} <= {min_accept}")
    q2 = results[hop_sampler]["q2"]
    if abs(q2 - q2_exact) > Q2_RTOL * q2_exact:
        raise AssertionError(f"{path} {hop_sampler} <Q^2> {q2:.4f} not "
                             f"within {Q2_RTOL:.0%} of {q2_exact:.4f}")
    return results


def plain_times(path, results, plain_fns, chains, n, reps):
    """Median ms per transition of each plain version over ``reps``
    windows of ``n`` transitions from the path's starting links, each
    window with fresh randomness; logged beside the kernel's time.  Returns
    ``({name: ms}, {name: (accept, standard error)})`` over all windows."""
    plain, accept = {}, {}
    for name, (K, make) in plain_fns.items():
        make(1)()
        windows, probs = [], []
        for _ in range(reps):
            fn = make(n)
            out, ms = timed(fn)
            windows.append(ms / n)
            probs.append(out[3])
        windows.sort()
        ms_tr = windows[reps // 2]
        plain[name] = ms_tr
        accept[name] = accept_stats(torch.cat(probs))
        log(f"[{path}] {name} plain PyTorch version: {1e3 * ms_tr:.1f} us/"
            f"transition = {K * chains / (ms_tr * 1e-3):.4g} lf-steps/s "
            f"(median of {reps} x {n} transitions, min "
            f"{1e3 * windows[0]:.1f}, max {1e3 * windows[-1]:.1f}); "
            f"kernel/plain speedup "
            f"{ms_tr * 1e3 / results[name]['us_per_transition']:.2f}x; "
            f"accept {accept[name][0]:.4f} +- {accept[name][1]:.4f}")
    return plain, accept


def accept_vs_plain(path, results, plain_accept, names):
    """The kernel's mean acceptance (in-kernel Philox) against the plain
    version's (torch randomness), within ACCEPT_NSE standard errors.  Fails
    too if the plain acceptance is itself within that band of 0, where the
    comparison could not tell a kernel that never accepts."""
    for name in names:
        k, se_k = results[name]["accept"], results[name]["accept_se"]
        p, se_p = plain_accept[name]
        tol = ACCEPT_NSE * float(np.hypot(se_k, se_p))
        log(f"[{path}] {name}: accept kernel {k:.5f} vs plain {p:.5f}, "
            f"|diff| {abs(k - p):.5f} (tolerance {tol:.5f} = {ACCEPT_NSE:g} "
            f"standard errors)")
        if abs(k - p) > tol:
            raise AssertionError(f"{path} {name}: kernel acceptance {k:.5f} "
                                 f"differs from the plain version's {p:.5f} "
                                 f"by more than {tol:.5f}")
        if p <= tol:
            raise AssertionError(f"{path} {name}: plain acceptance {p:.5f} "
                                 f"is within the tolerance {tol:.5f} of 0")


def reset_launches():
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain,
                                                  l2hmc_local_chain)
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    kernels = {"hmc_chain": hmc_chain, "l2hmc_chain": l2hmc_chain,
               "l2hmc_local_chain": l2hmc_local_chain}
    for k in kernels.values():
        k.launches = 0
    return kernels


def read_launches(path, kernels, needed):
    launches = {k: v.launches for k, v in kernels.items()}
    log(f"[{path}] launches during the path: {launches}")
    for k in needed:
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the {path} path")
    return launches


def main_phase(cfg, params, eps_c, device):
    """Phase 4: thermalize with HMC, then sample with all three samplers."""
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (
        draw_l2hmc_randomness, l2hmc_chain, l2hmc_chain_reference)
    from l2hmc_tpu_torch.ops.leapfrog import (draw_hmc_randomness,
                                              hmc_chain_reference)

    K_c = cfg.num_steps
    gen = torch.Generator(device=device).manual_seed(20261016)
    kernels = reset_launches()

    links = torch.zeros((MAIN_CHAINS, SIDE, SIDE, 2), device=device)
    (links, pl, _, pr), ms = timed(lambda: hmc_chain_u1_fused(
        links, gen, HMC_EPS, BETA, HMC_K, THERM_N))
    log(f"[main] thermalized {MAIN_CHAINS} chains: {THERM_N} HMC transitions "
        f"in {ms:.1f} ms; last plaquette {float(pl[-1].mean()):.5f}, "
        f"accept {float(pr.mean()):.4f}")

    samplers = {
        "champion": (K_c, lambda x: l2hmc_chain(
            x, params, gen, eps_c, BETA, K_c, CALL_N, hop=False),
            MIN_ACCEPT),
        "champion+hop": (K_c, lambda x: l2hmc_chain(
            x, params, gen, eps_c, BETA, K_c, CALL_N, hop=True), MIN_ACCEPT),
        "hmc": (HMC_K, lambda x: hmc_chain_u1_fused(
            x, gen, HMC_EPS, BETA, HMC_K, CALL_N), MIN_ACCEPT),
    }
    results = run_samplers("main", links, samplers, MAIN_CHAINS, SIDE,
                           "champion+hop")
    launches = read_launches("main", kernels, ("hmc_chain", "l2hmc_chain"))

    # plain versions at the same shape (CUDA tensors, injected randomness
    # drawn on the card outside the timed region)
    d = SIDE * SIDE

    def hmc_ref(n):
        r = draw_hmc_randomness(gen, n, MAIN_CHAINS, d, False, device)
        return lambda: hmc_chain_reference(links, *r[:3], HMC_EPS, BETA,
                                           HMC_K)

    def l2_ref(hop):
        def make(n):
            r = draw_l2hmc_randomness(gen, n, MAIN_CHAINS, d, hop, device)
            return lambda: l2hmc_chain_reference(
                links, params, *r[:4], eps_c, BETA, K_c,
                hop_arrays=r[4:] if hop else None)
        return make

    plain, _ = plain_times("main", results, {
        "hmc": (HMC_K, hmc_ref), "champion": (K_c, l2_ref(False)),
        "champion+hop": (K_c, l2_ref(True))}, MAIN_CHAINS, PLAIN_N,
        PLAIN_REPS)
    return results, plain, launches


def local64_phase(device):
    """Phase 5: the local64 path, Metropolis warm start then three
    samplers."""
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (
        draw_l2hmc_randomness, l2hmc_chain_reference, l2hmc_local_chain)
    from l2hmc_tpu_torch.ops.leapfrog import (draw_hmc_randomness,
                                              hmc_chain_reference)
    from l2hmc_tpu_torch.train.gauge import init_params

    cfg = local_cfg(L64_LAYERS)
    params = init_params(cfg, torch.Generator().manual_seed(640)).to(device)
    shape = cfg.shape
    gen = torch.Generator(device=device).manual_seed(6400)
    kernels = reset_launches()

    x0 = u1.random_links(gen, L64_CHAINS, shape, device=device)
    x, ms = timed(lambda: thermalize(gen, x0, shape, BETA,
                                     L64_THERM_SWEEPS))
    links = u1.to_links(x, shape).contiguous()
    log(f"[local64] Metropolis warm start: {L64_CHAINS} chains, "
        f"{L64_THERM_SWEEPS} sweeps in {ms:.1f} ms; plaquette "
        f"{float(u1.avg_plaquette(links).mean()):.5f}")

    K, L = L64_K, L64_LAYERS
    samplers = {
        "local": (K, lambda x: l2hmc_local_chain(
            x, params, gen, L64_EPS, BETA, K, CALL_N, L, hop=False), None),
        "local+hop": (K, lambda x: l2hmc_local_chain(
            x, params, gen, L64_EPS, BETA, K, CALL_N, L, hop=True), None),
        "hmc64": (L64_HMC_K, lambda x: hmc_chain_u1_fused(
            x, gen, L64_HMC_EPS, BETA, L64_HMC_K, CALL_N), MIN_ACCEPT),
    }
    results = run_samplers("local64", links, samplers, L64_CHAINS, L64_SIDE,
                           "local+hop")
    launches = read_launches("local64", kernels,
                             ("hmc_chain", "l2hmc_local_chain"))
    hop_q, base_q = (results["local+hop"]["q_changes"],
                     results["local"]["q_changes"])
    log(f"[local64] transitions changing the charge: local+hop {hop_q}, "
        f"local {base_q} (need a ratio >= {Q_HOP_RATIO})")
    if hop_q < Q_HOP_RATIO * max(base_q, 1):
        raise AssertionError(f"local64: the hop changed the charge in {hop_q}"
                             f" transitions, under {Q_HOP_RATIO}x the "
                             f"{base_q} of the local sampler without it")

    d = L64_SIDE * L64_SIDE

    def local_ref(hop):
        def make(n):
            r = draw_l2hmc_randomness(gen, n, L64_CHAINS, d, hop, device)
            return lambda: l2hmc_chain_reference(
                links, params, *r[:4], L64_EPS, BETA, K,
                hop_arrays=r[4:] if hop else None, local_layers=L)
        return make

    def hmc_ref(n):
        r = draw_hmc_randomness(gen, n, L64_CHAINS, d, False, device)
        return lambda: hmc_chain_reference(links, *r[:3], L64_HMC_EPS, BETA,
                                           L64_HMC_K)

    plain, plain_accept = plain_times("local64", results, {
        "local": (K, local_ref(False)), "local+hop": (K, local_ref(True)),
        "hmc64": (L64_HMC_K, hmc_ref)}, L64_CHAINS, L64_PLAIN_N,
        L64_PLAIN_REPS)
    accept_vs_plain("local64", results, plain_accept, ("local", "local+hop"))
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
    errs64 = local_check_phase(device)
    errs["hmc_chain"] = max(errs["hmc_chain"], errs64["hmc_chain"])
    errs["l2hmc_local_chain"] = errs64["l2hmc_local_chain"]
    results, plain, launches = main_phase(cfg, params, eps_c, device)
    r64, p64, l64 = local64_phase(device)

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
        {"name": "l2hmc_local_chain", "route": "cuda",
         "source": "l2hmc_tpu_torch/ops/csrc/l2hmc_local_chain.cu",
         "replaces": "l2hmc_tpu/ops/l2hmc_kernel.py:925",
         "launches": l64["l2hmc_local_chain"],
         "max_abs_err": errs["l2hmc_local_chain"],
         "ms": r64["local"]["us_per_transition"] * 1e-3,
         "plain_ms": p64["local"]},
    ]
    log("[result] ms and plain_ms are per transition: hmc_chain and "
        f"l2hmc_chain of {MAIN_CHAINS} chains at {SIDE}x{SIDE}, "
        f"l2hmc_local_chain of {L64_CHAINS} chains at {L64_SIDE}x{L64_SIDE}"
        f" (c={L64_CHANNELS} L={L64_LAYERS} K={L64_K}), on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"[done] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
