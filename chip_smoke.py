#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's sampling and training paths once on one
NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: name, ``nvidia-smi`` name and power limit; TF32 off.
2. Build: compile ``l2hmc_tpu_torch/ops/csrc/*.cu`` with nvcc (sm_90a), one
   process per source; print ptxas's registers and spills per kernel.
3. Each kernel against its plain PyTorch version on the card, with the same
   injected randomness (numpy, seeded), ``hop`` off and on:
   ``hmc_chain`` (K=5, eps=0.08) and ``l2hmc_chain`` with the shipped
   champion's weights at 16x16, 2048 chains, 8 transitions, and
   ``l2hmc_chain`` at hidden width 256 (seeded init weights, f32 and bf16);
   at 64x64, 512 chains, 4 transitions: ``hmc_chain`` at local64's K=8,
   eps=0.04552, and ``l2hmc_local_chain`` at c=4 with stencil depth L=1, 2
   and 3 and at c=8 L=1 and 2 (c4L3 and c8L2 on the kernel's deep route),
   the variants phase 9 times (K=4, eps=0.01, where these weights accept
   ~0.3-0.6), weights from the port's init perturbed by a seeded N(0,
   0.05^2); and ``hmc_chain`` at 128x128 (64 chains, 4 transitions, its
   global route).  A
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
6. The Wilson action kernels (``csrc/wilson.cu``: forward, action-only
   forward, backward, fused force and the force's backward), on every
   route that can hold the lattice, against their plain versions at (128,
   16, 16, 2), (512, 64, 64, 2), (8, 128, 128, 2) and (1, 160, 160, 2) (the
   global route alone), near-equilibrium and uniform links, g = beta; at
   the first two shapes each timed beside its plain version (per-call host
   time by CUDA events, device time by torch.profiler, the inputs cycled
   through copies larger than twice the L2), beside the device time of an
   empty kernel (the launch floor); at the training shape each kernel also
   on both routes in turns (block, and global: one block per chain reading
   device memory).
7. One train step at the README quick-start config through the Wilson
   kernels against the same step on the plain potential: same state and
   injected draws; loss, metrics, every gradient, updated params, x.
8. Main path "train": the quick-start config (16x16, 128 chains, K=4, eps
   0.079 fixed, MLP h64, charge_reward, train_hops) from a seeded init on
   the card, 3 chunks of 100 train steps, every force through the Wilson
   kernels (launches per step checked against the count derived from the
   code); then the trained params served by ``l2hmc_chain`` at beta=4.
9. Main path "decomposition" (``l2hmc_tpu_torch/benchmarks``): each probe
   of ``csrc/issue_rates.cu`` against its plain chain; the ablated
   ``l2hmc_chain`` and ``l2hmc_local_chain`` (c=4 and 8) against their
   plain versions and against the same kernels on zeroed nets (bit for
   bit); the bf16
   ``l2hmc_chain`` against its plain version.  Then, counted: the per-class
   issue rates inside the kernel at (2048, 256) and (2048, 512), the op
   counts and issue estimates, the champion's full / ablated / bf16 / HMC
   decomposition, local64 c4L1 and c8L1 with their ablated forms and HMC at
   K=4 and 8, and the champion served with bf16 weights (plaquette gate).

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

The last two lines are a JSON object of per-kernel results (with each
kernel's least possible time ``bound_ms`` from this run's shapes: for
``l2hmc_chain`` the conditioner's products at the tensor-core rate, 3 TF32
passes for float32, beside the rest at 67 TFLOP/s; ``library_ms`` of
``l2hmc_chain`` is its ten conditioner products per transition as float32
``torch.matmul``, a yardstick the port never calls) and the
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


def check_kernel(name, kernel_out, plain_out, us, atol=ATOL):
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
    if not (err_links <= atol and err_prob <= atol and err_plaq <= atol
            and same_q):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (atol {atol})")
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


def local_cfg(layers, channels=L64_CHANNELS):
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    return GaugeConfig(
        time_size=L64_SIDE, space_size=L64_SIDE, num_chains=L64_CHAINS,
        num_steps=L64_K, network_arch="local_flat", num_filters=channels,
        local_layers=layers, merge_v_halves=True, eps_init=L64_EPS,
        eps_trainable=False, beta_final=BETA, bounded_q=True)


def live_local_params(layers, channels, seed, device):
    """local64 params from the port's seeded init, every array perturbed by
    a seeded N(0, 0.05^2) so that S, T and Q depend on the inputs."""
    from l2hmc_tpu_torch.train.gauge import init_params

    gen = torch.Generator().manual_seed(seed)
    params = init_params(local_cfg(layers, channels), gen, device="cpu")
    with torch.no_grad():
        for net in (params.xnet, params.vnet):
            for p in net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return params.to(device)


# hmc_chain at 128x128 (its global route), kernel against plain
H128_SIDE, H128_CHAINS, H128_N = 128, 64, 4
# l2hmc_chain at hidden width 256 (two tile rows per product warp)
WIDE_HIDDEN, WIDE_CHAINS, WIDE_N, WIDE_TIME_N = 256, 128, 2, 20
# these h256 weights accept ~0.06 at the champion's eps 0.125, ~0.3 at 0.05
WIDE_EPS = 0.05


def wide_check(K_c, device):
    """Phase 3: ``l2hmc_chain`` at h=256 from seeded init weights (16x16,
    f32 and bf16) against its plain version, and its time at the main
    path's batch.  Returns the f32 error."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain,
                                                  l2hmc_chain_reference)

    params = live_mlp_params(K_c, device, hidden=WIDE_HIDDEN)
    rng = np.random.default_rng(2561)
    b, n, d = WIDE_CHAINS, WIDE_N, SIDE * SIDE
    links = torch.tensor(typical_links(rng, b, SIDE, SIDE, sigma=0.3),
                         device=device)
    rand = injected(rng, n, b, d, device)[:4]
    err = 0.0
    for precision in ("f32", "bf16"):
        out_k = l2hmc_chain(links, params, None, WIDE_EPS, BETA, K_c, n,
                            rand_arrays=rand, precision=precision)
        out_p = l2hmc_chain_reference(links, params, *rand, WIDE_EPS, BETA,
                                      K_c, precision=precision)
        torch.cuda.synchronize()
        name = f"l2hmc_chain({precision}) h{WIDE_HIDDEN} {SIDE}x{SIDE}"
        if precision == "f32":
            err = check_kernel(name, out_k, out_p, rand[3])
        else:
            check_bf16(name, out_k, out_p, rand[3])
    # its time at the main path's batch, from the same near-equilibrium links
    from l2hmc_tpu_torch.benchmarks import best_ms

    big = links.repeat(MAIN_CHAINS // b, 1, 1, 1)
    gen = torch.Generator(device=device).manual_seed(2562)
    for precision in ("f32", "bf16"):
        ms = best_ms(lambda: l2hmc_chain(big, params, gen, WIDE_EPS, BETA,
                                         K_c, WIDE_TIME_N,
                                         precision=precision), 2) / WIDE_TIME_N
        log(f"[check] l2hmc_chain({precision}) h{WIDE_HIDDEN} {SIDE}x{SIDE}: "
            f"{1e3 * ms:.1f} us/transition at {MAIN_CHAINS} chains (best of "
            f"2 calls of {WIDE_TIME_N} transitions, CUDA events)")
    return err


def hmc128_check(device):
    """Phase 3: ``hmc_chain`` at 128x128 against its plain version, hop off
    and on.  Returns the largest error."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops.leapfrog import (hmc_chain, hmc_chain_plan,
                                              hmc_chain_reference)

    rng = np.random.default_rng(1281)
    b, n, d = H128_CHAINS, H128_N, H128_SIDE * H128_SIDE
    links = torch.tensor(typical_links(rng, b, H128_SIDE, H128_SIDE,
                                       sigma=0.27), device=device)
    v0s, v1s, _, us, nus, uhs = injected(rng, n, b, d, device)
    err = 0.0
    plan = hmc_chain_plan(H128_SIDE, H128_SIDE)
    for hop in (False, True):
        rand = (v0s, v1s, us) + ((nus, uhs) if hop else ())
        out_k = hmc_chain(links, None, L64_HMC_EPS, BETA, L64_HMC_K, n,
                          hop=hop, rand_arrays=rand)
        out_p = hmc_chain_reference(links, v0s, v1s, us, L64_HMC_EPS, BETA,
                                    L64_HMC_K,
                                    hop_arrays=(nus, uhs) if hop else None)
        torch.cuda.synchronize()
        err = max(err, check_kernel(
            f"hmc_chain hop={hop} {H128_SIDE}x{H128_SIDE} K={L64_HMC_K} "
            f"({plan.route} route)", out_k, out_p, us))
    return err


def local_check_phase(device):
    """Phase 3, 64x64: ``hmc_chain`` at local64's K and eps, and the
    local-stencil kernel at c4L1, c4L2, c4L3, c8L1 and c8L2, against their
    plain versions, hop off and on.  Returns ``{kernel: max error}``."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain_reference,
                                                  l2hmc_local_chain)
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain, hmc_chain_reference

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
    for layers, channels, seed in ((1, L64_CHANNELS, 61),
                                   (2, L64_CHANNELS, 62), (1, 8, 69),
                                   (3, L64_CHANNELS, 63), (2, 8, 68)):
        params = live_local_params(layers, channels, seed, device)
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
                    f"{L64_SIDE} c={channels}", out_k, out_p, us))
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
    """Set every kernel wrapper's launch counts to 0; returns ``{name:
    (wrapper, count attribute)}``, where ``name[variant]`` counts one mode
    of a kernel (``l2hmc_chain`` counts all of its launches)."""
    from l2hmc_tpu_torch.ops import wilson as W
    from l2hmc_tpu_torch.ops.issue_rates import probe_chain
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain,
                                                  l2hmc_local_chain)
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    kernels = {"hmc_chain": (hmc_chain, "launches"),
               "l2hmc_chain": (l2hmc_chain, "launches"),
               "l2hmc_chain[ablate]": (l2hmc_chain, "ablate_launches"),
               "l2hmc_chain[bf16]": (l2hmc_chain, "bf16_launches"),
               "l2hmc_local_chain": (l2hmc_local_chain, "launches"),
               "l2hmc_local_chain[ablate]": (l2hmc_local_chain,
                                             "ablate_launches"),
               "wilson_forward": (W.wilson_forward, "launches"),
               "wilson_action_only": (W.wilson_action_only, "launches"),
               "wilson_backward": (W.wilson_backward, "launches"),
               "wilson_force": (W.wilson_force, "launches"),
               "wilson_double_backward": (W.wilson_double_backward,
                                          "launches"),
               "issue_rates": (probe_chain, "launches")}
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)
    return kernels


def launch_counts(kernels):
    return {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}


def read_launches(path, kernels, needed):
    launches = launch_counts(kernels)
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
    params = init_params(cfg, torch.Generator().manual_seed(640),
                         device=device)
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

# ---------------------------------------------------------------------------
# Least time the card could take (a roofline bound):
# each input read once and each output written once at the memory rate, or
# the operations at the float32 rate without tensor cores, whichever is
# larger.  Published peaks of one H100 SXM at 700 W.
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12      # dense, tensor cores
TF32_FLOP_PER_S = 495e12      # dense, tensor cores


def bound(nbytes, flops):
    """``(bound_ms, bound_by)`` for work moving ``nbytes`` and doing
    ``flops`` operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def hmc_chain_bound(b, d, K, n):
    """Per transition of ``hmc_chain``: links in and out once per call of
    ``n`` transitions, three (n, b) traces; per site and leapfrog step 25
    operations (plaquette 3, sincos 2, two kicks of 3, two drifts with the
    wrap of 7), per site and transition 15 (energy change, accept select)."""
    nbytes = (2 * b * 2 * d * 4 + 3 * n * b * 4) / n
    return bound(nbytes, b * d * (25 * K + 15))


def mlp_macs(net):
    """Multiply-adds of one MLP conditioner call per chain."""
    return net.in_w.numel() + net.h_layer.w.numel() + net.head_w.numel()


def stencil_macs(net):
    """Multiply-adds of one local conditioner call per site."""
    return (sum(s.w.numel() for s in net.stencils())
            + net.head.w.numel())


def l2hmc_chain_bound(b, K, macs):
    """Per transition of the trained chains: K+1 VNet and 2K XNet calls of
    ``macs`` multiply-adds per chain (the conditioners dominate), at the
    float32 rate without tensor cores (the local kernel's route, and the
    MLP kernel's before it ran its products on tensor cores)."""
    return bound(0.0, 2.0 * b * (3 * K + 1) * macs)


def tensor_core_chain_bound(b, K, macs, rest_ops, precision="f32"):
    """Per transition of ``csrc/l2hmc_chain.cu``'s route: the conditioner's
    products on tensor cores (float32 as 3 TF32 passes at 495 TFLOP/s, bf16
    as one pass at 989 TFLOP/s) and the rest of the transition
    (``rest_ops``, the ablated transition's operations) at 67 TFLOP/s; the
    pipes can overlap, so the larger of the two.  Returns ``(bound_ms,
    bound_by, tensor-core ms, rest ms)``."""
    flops = 2.0 * b * (3 * K + 1) * macs
    t_tc = (3.0 * flops / TF32_FLOP_PER_S if precision == "f32"
            else flops / BF16_FLOP_PER_S)
    t_rest = rest_ops / F32_FLOP_PER_S
    return 1e3 * max(t_tc, t_rest), "operations", 1e3 * t_tc, 1e3 * t_rest


def conditioner_matmul_ms(params, K, device, reps=5):
    """Yardstick for ``l2hmc_chain`` (library_ms; never called by the port):
    ms of the ten conditioner products of one transition (K+1 VNet and 2K
    XNet calls, each (B, 6d) @ (6d, h), (B, h) @ (h, h), (B, h) @ (h, 6d))
    as float32 ``torch.matmul`` calls (TF32 off) at MAIN_CHAINS chains.
    The 30 calls are captured in a CUDA graph and its replay is timed
    (median of ``reps``, CUDA events): launched one by one from Python they
    run at the host's pace, and torch.profiler records only some of them."""
    from l2hmc_tpu_torch.ops.l2hmc_kernel import WEIGHT_NAMES, pack_weights

    d = SIDE * SIDE
    w = dict(zip(WEIGHT_NAMES, pack_weights(params, 2 * d)))
    gen = torch.Generator(device=device).manual_seed(11)
    f = torch.randn((MAIN_CHAINS, 6 * d), generator=gen, device=device)
    nets = ["v" if i % 3 == 0 else "x" for i in range(3 * K + 1)]

    def run():
        for n in nets:
            h = torch.matmul(f, w[n + "in"])
            h = torch.matmul(h, w[n + "h_w"])
            torch.matmul(h, w[n + "head"])

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    times = sorted(timed(graph.replay)[1] for _ in range(reps))
    return times[reps // 2]


def weight_stream_bytes(b, lt, lx, h, K, precision="f32"):
    """Bytes ``csrc/l2hmc_chain.cu`` streams from L2 per transition: every
    block reads its net's packed chunks once per MLP call."""
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (CHUNK_BYTES,
                                                  chains_per_block,
                                                  mma_geometry)

    geo = mma_geometry(lt * lx, h, precision)
    c, _ = chains_per_block(lt, lx, h, precision)
    blocks = -(-b // c)
    return (geo.n_in + geo.n_tr + geo.n_hd) * CHUNK_BYTES * (3 * K + 1) \
        * blocks


def local_trig_per_transition(b, d, K):
    """sincosf calls of ``csrc/l2hmc_local_chain.cu``'s conditioner inputs
    per transition: 2 per site for each of the K+1 kicks (both directions
    staged), none for the first position half-update of a step (it reuses
    the kick's), d over both directions for the second (the held links: a
    mask holds half of the 2d).  The design before staging rebuilt 2 per
    stencil point and site for each kick and 1 per held stencil point for
    each half-update: (K+1) 10 d + 2K 5 d."""
    return b * d * (2 * (K + 1) + K), b * d * (10 * (K + 1) + 10 * K)


def wilson_bounds(b, lt, lx):
    """``{kernel: (bound_ms, bound_by)}`` of the Wilson kernels on a (b, lt,
    lx, 2) batch: forward reads links and writes sin P and S (7 operations
    per site), the action-only forward reads links and writes S (6),
    backward reads sin P and g and writes the force (4), the fused force
    reads links and g and writes the force (8), double backward reads links,
    g and w and writes dlinks and dg (14, the neighbours' recomputation not
    counted)."""
    s = b * lt * lx
    return {"wilson_forward": bound(s * 8 + s * 4 + b * 4, 7 * s),
            "wilson_action_only": bound(s * 8 + b * 4, 6 * s),
            "wilson_backward": bound(s * 4 + b * 4 + s * 8, 4 * s),
            "wilson_force": bound(s * 8 + b * 4 + s * 8, 8 * s),
            "wilson_double_backward": bound(s * 8 * 3 + b * 8, 14 * s)}


# ---------------------------------------------------------------------------
# Phase 6: the Wilson kernels against their plain versions
# ---------------------------------------------------------------------------

WILSON_SHAPES = ((128, 16, 16), (512, 64, 64), (8, 128, 128), (1, 160, 160))
WILSON_TIMED = 2              # the first shapes are timed
WILSON_REPS = 200
WILSON_PROFILE_REPS = 20
# Kernel and plain version compute P in the same order (identical angles);
# sin and cos come from CUDA's libm against torch's (~1 ulp), the per-chain
# sums in another order.  Tolerances: sin P 1e-6 absolute; S and dg 1e-5
# relative to the sum of their terms' magnitudes (float32 sums of up to
# 25600 terms, ~5e-7 rounding each); the backward from the same sin P
# exactly (same products and differences); the fused force (its own sin P)
# and dlinks 1e-5 of their largest entry.
WILSON_RTOL = 1e-5
SINP_ATOL = 1e-6


def empty_kernel_us(device):
    """Device time per launch of an empty kernel (128 blocks of 256
    threads, the Wilson kernels' grid at the training shape), measured as
    they are (torch.profiler); None when the profiler saw no device time."""
    from l2hmc_tpu_torch.benchmarks.wilson_routes import device_us
    from l2hmc_tpu_torch.ops import _cuda

    lib, stream = _cuda.library(), _cuda.stream_handle(device)

    def launch():
        _cuda.check(lib.empty_launch(128, 256, device.index or 0, stream),
                    "empty_launch")

    us = device_us(launch, WILSON_PROFILE_REPS)
    return None if np.isnan(us) else us


def wilson_errors(W, links, g, w):
    """``(max abs error per kernel, failures)`` of every Wilson kernel
    against its plain version on one set of inputs."""
    s_k, sinp_k = W.wilson_forward(links)
    s_only = W.wilson_action_only(links)
    s_p, sinp_p = W.wilson_forward_reference(links)
    f_k = W.wilson_backward(sinp_p, g)
    f_p = W.wilson_backward_reference(sinp_p, g)
    force_k = W.wilson_force(links, g)
    force_p = W.wilson_force_reference(links, g)
    dl_k, dg_k = W.wilson_double_backward(links, g, w)
    dl_p, dg_p = W.wilson_double_backward_reference(links, g, w)
    torch.cuda.synchronize()
    p = W._plaq_sums(links[..., 0], links[..., 1])
    r = (w[..., 0] - torch.roll(w[..., 0], -1, -1) - w[..., 1]
         + torch.roll(w[..., 1], -1, -2))
    s_scale = torch.sum(1.0 - torch.cos(p), dim=(1, 2))
    dg_scale = torch.sum(torch.abs(r * torch.sin(p)), dim=(1, 2))
    errs = {
        "wilson_forward": max(float((s_k - s_p).abs().max()),
                              float((sinp_k - sinp_p).abs().max())),
        "wilson_action_only": float((s_only - s_p).abs().max()),
        "wilson_backward": float((f_k - f_p).abs().max()),
        "wilson_force": float((force_k - force_p).abs().max()),
        "wilson_double_backward": max(float((dl_k - dl_p).abs().max()),
                                      float((dg_k - dg_p).abs().max())),
    }
    rel = {"S": float(((s_k - s_p).abs() / s_scale).max()),
           "action-only S": float(((s_only - s_p).abs() / s_scale).max()),
           "fused force": errs["wilson_force"] / float(force_p.abs().max()),
           "dlinks": float((dl_k - dl_p).abs().max() / dl_p.abs().max()),
           "dg": float(((dg_k - dg_p).abs() / dg_scale).max())}
    fails = [k for k, v in rel.items() if not v <= WILSON_RTOL]
    err_sin = float((sinp_k - sinp_p).abs().max())
    if not err_sin <= SINP_ATOL:
        fails.append("sin P")
    if errs["wilson_backward"] != 0.0:
        fails.append("backward")
    txt = ", ".join(f"{k} rel {v:.3e}" for k, v in rel.items())
    return errs, fails, (f"{txt}, max|d sinP| {err_sin:.3e}, backward "
                         f"max|d| {errs['wilson_backward']:.3e}")


def wilson_check_phase(device):
    """Phase 6: every Wilson kernel on every route that can hold the
    lattice against its plain version at the training shape, at 64x64,
    128x128 and 160x160 (the global route), near-equilibrium and uniform
    links, g = beta, random w; at the first two shapes each timed on its
    planned route beside its plain version and the empty-kernel floor, the
    inputs cycled through copies larger than twice the L2.  Returns
    ``{kernel: {max_abs_err (the largest over the routes), ms, plain_ms,
    bound_ms, bound_by}}`` at the main path's shape (the first)."""
    from l2hmc_tpu_torch.benchmarks import device_profile
    from l2hmc_tpu_torch.benchmarks.wilson_routes import (
        input_sets, on_route, rotated, routes_of, time_routes)
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops import wilson as W

    floor_us = empty_kernel_us(device)
    floor_txt = "not measured" if floor_us is None else f"{floor_us:.2f} us"
    log(f"[wilson] empty kernel (128 blocks of 256 threads): device time per "
        f"launch {floor_txt} (torch.profiler, {WILSON_PROFILE_REPS} launches)")
    rng = np.random.default_rng(606)
    out = {}
    for shape_no, (b, lt, lx) in enumerate(WILSON_SHAPES):
        plan = W.wilson_plan(b, lt, lx)
        log(f"[wilson] ({b}, {lt}, {lx}, 2): plan {vars(plan)}")
        for kind in ("typical", "uniform"):
            a = (typical_links(rng, b, lt, lx, sigma=0.3) if kind == "typical"
                 else rng.uniform(-np.pi, np.pi, (b, lt, lx, 2)))
            links = torch.tensor(a, dtype=torch.float32, device=device)
            g = torch.full((b,), BETA, device=device)
            w = torch.tensor(rng.standard_normal((b, lt, lx, 2)),
                             dtype=torch.float32, device=device)
            worst = {}
            for route in routes_of(b, lt, lx):
                with on_route(route):
                    errs, fails, txt = wilson_errors(W, links, g, w)
                log(f"[wilson] ({b}, {lt}, {lx}, 2) {kind}, {route} route: "
                    f"{txt}; max abs {errs}")
                if fails:
                    raise AssertionError(
                        f"wilson ({b}, {lt}, {lx}) {kind}, {route} route: "
                        f"{fails} disagree with the plain versions (rtol "
                        f"{WILSON_RTOL}, sin P atol {SINP_ATOL}, backward "
                        f"exact)")
                worst = {k: max(v, worst.get(k, 0.0))
                         for k, v in errs.items()}
            if kind != "typical" or shape_no >= WILSON_TIMED:
                continue
            sets = input_sets(b, lt, lx, device, seed=shape_no)
            runs = {
                "wilson_forward": (
                    lambda l, g, w, s: W.wilson_forward(l),
                    lambda l, g, w, s: W.wilson_forward_reference(l)),
                "wilson_action_only": (
                    lambda l, g, w, s: W.wilson_action_only(l),
                    lambda l, g, w, s: W.wilson_forward_reference(l)[0]),
                "wilson_backward": (
                    lambda l, g, w, s: W.wilson_backward(s, g),
                    lambda l, g, w, s: W.wilson_backward_reference(s, g)),
                "wilson_force": (
                    lambda l, g, w, s: W.wilson_force(l, g),
                    lambda l, g, w, s: W.wilson_force_reference(l, g)),
                "wilson_double_backward": (
                    lambda l, g, w, s: W.wilson_double_backward(l, g, w),
                    lambda l, g, w, s: W.wilson_double_backward_reference(
                        l, g, w)),
            }
            bounds = wilson_bounds(b, lt, lx)
            for name, pair in runs.items():
                kern, plain = (rotated(sets, f) for f in pair)
                ms = {}
                for tag, fn in (("plain", plain), ("kernel", kern),
                                ("kernel2", kern), ("plain2", plain)):
                    fn()
                    _, t = timed(lambda: [fn() for _ in range(WILSON_REPS)])
                    ms[tag] = t / WILSON_REPS
                call_ms = (min(ms["kernel"], ms["kernel2"]),
                           min(ms["plain"], ms["plain2"]))
                dev = [device_profile(fn, WILSON_PROFILE_REPS)
                       for fn in (kern, plain)]
                dev_txt = ", ".join(
                    f"{tag} {1e3 * d[0]:.2f} us in {d[1]:.0f} kernels"
                    if d else f"{tag} not measured (no device time)"
                    for tag, d in zip(("kernel", "plain"), dev))
                # the kernel's time on the card is its device time; a call
                # from Python costs more (the host enqueues slower than
                # the card runs these), which the host time shows
                use_dev = all(dev)
                res = {"max_abs_err": worst[name],
                       "ms": dev[0][0] if use_dev else call_ms[0],
                       "plain_ms": dev[1][0] if use_dev else call_ms[1],
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1]}
                log(f"[wilson] ({b}, {lt}, {lx}, 2) {name}: per-call host "
                    f"time {1e3 * call_ms[0]:.2f} us (runs "
                    f"{1e3 * ms['kernel']:.2f}, {1e3 * ms['kernel2']:.2f}), "
                    f"plain {1e3 * call_ms[1]:.2f} us ({WILSON_REPS} "
                    f"back-to-back calls, CUDA events, min of two runs); "
                    f"device time per call (torch.profiler, "
                    f"{WILSON_PROFILE_REPS} calls, inputs cycled through "
                    f"{len(sets)} copies): {dev_txt}; empty kernel "
                    f"{floor_txt}; bound {1e3 * res['bound_ms']:.3f} us "
                    f"({res['bound_by']}); reported: "
                    f"{'device' if use_dev else 'call'} times")
                if shape_no == 0:
                    out[name] = res
    # at the training shape, each kernel on every route, in turns
    b, lt, lx = WILSON_SHAPES[0]
    routes = time_routes(b, lt, lx, device)
    for name, us in routes["us"].items():
        log(f"[wilson] ({b}, {lt}, {lx}, 2) wilson_{name}: device us per "
            f"call by route, in turns (wilson_routes.py): " + ", ".join(
                f"{r}{' (planned)' if r == routes['planned'][name] else ''} "
                f"{v:.3f}" for r, v in us.items()))
    return out


# ---------------------------------------------------------------------------
# Phases 7 and 8: training at the README quick-start config
# ---------------------------------------------------------------------------

TRAIN_CHUNK, TRAIN_CHUNKS = 100, 3
PLAIN_TRAIN_STEPS = 10        # steps per timed turn, kernel vs plain
SERVE_THERM_N, SERVE_CALLS = 500, 2
# Train step, kernel potential vs the plain one on the same state and draws.
# The two differ by float32 rounding in the action sums and libm, which the
# K=4 trajectories carry into the accept probabilities (~1e-5, as the chain
# kernels) and so into the loss (reciprocal jump terms) and gradients.
# Adam's update is lr * mu_hat / (sqrt(nu_hat) + 1e-8), ~lr*sign(g) where
# sqrt(nu_hat) >> 1e-8: there the updated params agree to a small fraction
# of lr.  Where |g| is within a few decades of Adam's eps (sqrt(nu_hat) is
# ~0.06 |g| at the optimizer count used here) the update follows the
# rounding of g itself, so params are compared only where |g| >= 1e-5 and
# >= 1e-3 of the tensor's largest.  A gradient sign flip is allowed only
# where |g| is rounding-sized (below 1e-4 of the tensor's largest).
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_RTOL = 1e-3
TRAIN_PARAM_LR_TOL = 1e-2
GRAD_FLIP_REL = 1e-4
PARAM_G_REL, PARAM_G_ABS = 1e-3, 1e-5


def train_cfg():
    """The README quick-start training recipe (README.md, "The topological
    sampler"): 16x16, 128 chains, K=4, fixed eps 0.079, MLP h64,
    merge_v_halves, charge_reward, train_hops, beta 2 -> 5 over 12000
    steps; the rest at GaugeConfig's defaults."""
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    return GaugeConfig(
        time_size=16, space_size=16, num_chains=128, num_steps=4,
        eps_init=0.079, eps_trainable=False, network_arch="mlp",
        num_hidden=64, merge_v_halves=True, charge_reward=True,
        train_hops=True, beta_init=2.0, beta_final=5.0, train_steps=12000)


def wilson_launches_per_step(K):
    """Wilson kernel launches of one train step (x and z chains).  Per
    trajectory: K+1 fused forces (the leapfrog's ``grad_potential``) and the
    two Hamiltonians' forwards: the initial one's links carry no gradient
    (the action-only kernel), the final one's do (the forward that writes
    sin P); the loss's backward adds the final Hamiltonian's backward and
    one double backward per force that depends on the params (all but the
    first)."""
    return {"wilson_forward": 2, "wilson_action_only": 2,
            "wilson_backward": 2, "wilson_force": 2 * (K + 1),
            "wilson_double_backward": 2 * K}


def clone_state(state):
    import copy

    from l2hmc_tpu_torch.dynamics.nuts import DualAveragingState

    opt = state.opt_state
    return state._replace(
        params=copy.deepcopy(state.params),
        opt_state=opt._replace(mu={k: v.clone() for k, v in opt.mu.items()},
                               nu={k: v.clone() for k, v in opt.nu.items()}),
        x=state.x.clone(), da=DualAveragingState(*[t.clone()
                                                   for t in state.da]))


def train_check_phase(device):
    """Phase 7: one train step through the Wilson kernels against the same
    step on the plain potential, same state (nets perturbed, optimizer past
    the lr warmup, near-equilibrium links) and the same injected draws."""
    from l2hmc_tpu_torch.dynamics.topo import instanton_hop_with
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_plain_potential_fn
    from l2hmc_tpu_torch.train import gauge as tg
    from l2hmc_tpu_torch.train.schedules import beta_schedule

    cfg = train_cfg()
    b, d = cfg.num_chains, cfg.x_dim
    gen = torch.Generator(device=device).manual_seed(707)
    state = tg.init_train_state(cfg, gen, device)
    rng = np.random.default_rng(707)
    with torch.no_grad():
        for net in (state.params.xnet, state.params.vnet):
            for p in net.parameters():
                p.add_(torch.tensor(0.02 * rng.standard_normal(p.shape),
                                    dtype=torch.float32, device=device))
    count = cfg.lr_warmup_steps + 100
    x = u1.to_flat(torch.tensor(u1.typical_links(rng, b, 16, 16, sigma=0.5),
                                device=device))
    state = state._replace(x=x, step=count,
                           opt_state=state.opt_state._replace(count=count))
    draws = tg.draw_train_randomness(gen, b, d, True, device)
    beta = beta_schedule(count, cfg.train_steps, cfg.beta_init,
                         cfg.beta_final)
    res = {}
    for name, pot in (("kernel", None),
                      ("plain", make_plain_potential_fn(cfg.shape))):
        st = clone_state(state)
        _, dyn = tg.build_dynamics(cfg, pot)
        _, loss_with = tg.make_loss_fn(cfg, dyn)
        leaves = tg.named_leaves(st.params)
        wrt = [k for k, v in leaves.items() if v.requires_grad]
        loss, _ = loss_with(st.params, st.x, beta, draws)
        grads = dict(zip(wrt, torch.autograd.grad(
            loss, [leaves[k] for k in wrt])))
        with torch.no_grad():
            tr = dyn["transition_with"](st.params, st.x, beta, draws.v_x,
                                        draws.d_x, draws.u_x)
            hop = instanton_hop_with(u1.wrap(tr.x_out), beta, draws.nu,
                                     draws.u_hop, cfg.shape)
        new, m = tg.make_train_step(cfg, pot)[1](st, draws)
        res[name] = dict(loss=float(loss.detach()), grads=grads, state=new,
                         m=m,
                         prob=tr.accept_prob, hop_prob=hop.accept_prob)
    k, p = res["kernel"], res["plain"]
    tie = (((draws.u_x - p["prob"]).abs() < NEAR_TIE)
           | ((draws.u_hop - p["hop_prob"]).abs() < NEAR_TIE))
    n_ex = int(tie.sum())
    if n_ex > b // 64:
        raise AssertionError(f"train step: {n_ex} chains hit a near-tie "
                             f"accept decision")
    keep = ~tie
    lr = float(p["m"]["lr"])
    rel_loss = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    grad_rel, param_err, param_all, flips, n_small = 0.0, 0.0, 0.0, 0, 0
    pk = tg.named_leaves(k["state"].params)
    pp = tg.named_leaves(p["state"].params)
    for n, gp in p["grads"].items():
        gk = k["grads"][n]
        scale = float(gp.abs().max())
        grad_rel = max(grad_rel, float((gk - gp).abs().max()) / max(scale,
                                                                    1e-30))
        flip = torch.sign(gk) != torch.sign(gp)
        if bool((flip & (gp.abs() > GRAD_FLIP_REL * scale)).any()):
            raise AssertionError(f"train step: gradient {n} changes sign "
                                 f"where it is not rounding-sized")
        flips += int(flip.sum())
        dp = (pk[n] - pp[n]).abs()
        param_all = max(param_all, float(dp.max()) / lr)
        big = (gp.abs() >= PARAM_G_REL * scale) & (gp.abs() >= PARAM_G_ABS)
        n_small += int((~big).sum())
        if bool(big.any()):
            param_err = max(param_err, float(dp[big].max()) / lr)
    err_x = angle_err(k["state"].x[keep], p["state"].x[keep])
    m_err = {key: abs(float(k["m"][key]) - float(p["m"][key]))
             for key in ("accept_prob", "eps", "beta", "lr")}
    if n_ex == 0:
        m_err.update({key: abs(float(k["m"][key]) - float(p["m"][key]))
                      for key in ("dq", "actions", "plaqs", "charges2")})
    log(f"[train-check] kernel vs plain, one step at {b} chains 16x16 K="
        f"{cfg.num_steps} h{cfg.hidden}: loss {k['loss']:.6f} vs "
        f"{p['loss']:.6f} (rel {rel_loss:.3e}); grads max|d|/max|g| "
        f"{grad_rel:.3e}; params max|d| {param_err:.3e} lr where |g| is "
        f"not small ({param_all:.3e} lr over all, {n_small} small-|g| "
        f"elements, {flips} rounding-sized gradient sign flips); x_new "
        f"max|d| {err_x:.3e}; "
        f"metrics |d| {m_err}; excluded {n_ex}/{b}; mean prob "
        f"{float(p['prob'].mean()):.4f}")
    if not (rel_loss <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL
            and param_err <= TRAIN_PARAM_LR_TOL and err_x <= ATOL
            and m_err["accept_prob"] <= ATOL
            and all(m_err[key] == 0.0 for key in ("eps", "beta", "lr"))):
        raise AssertionError("train step: the Wilson kernels' step disagrees "
                             "with the plain potential's")
    return max(rel_loss, grad_rel, err_x)


def train_phase(device):
    """Phase 8: the training path at the quick-start config, then the
    trained params served through ``l2hmc_chain``."""
    from l2hmc_tpu_torch.benchmarks import device_profile
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
    from l2hmc_tpu_torch.lattice.u1 import u1_plaq_exact
    from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_chain
    from l2hmc_tpu_torch.ops.wilson import make_plain_potential_fn
    from l2hmc_tpu_torch.train import gauge as tg

    cfg = train_cfg()
    K = cfg.num_steps
    kernels = reset_launches()
    gen = torch.Generator(device=device).manual_seed(808)
    state = tg.init_train_state(cfg, gen, device)
    eps0 = state.params.raw_eps.detach().clone()
    w0 = {n: v.detach().clone() for n, v in tg.named_leaves(
        state.params).items() if n.startswith(("xnet/", "vnet/"))}
    chunk = tg.make_train_chunk(cfg, TRAIN_CHUNK)
    ms, metrics = [], []
    for _ in range(TRAIN_CHUNKS):
        (state, m), t = timed(lambda: chunk(state, gen))
        ms.append(t / TRAIN_CHUNK)
        metrics.append({k: v.cpu() for k, v in m.items()})
    loss = torch.cat([m["loss"] for m in metrics])
    acc_last = float(metrics[-1]["accept_prob"].mean())
    q2 = float(torch.cat([m["charges2"] for m in metrics]).mean())
    moved = max(float((tg.named_leaves(state.params)[n] - v).abs().max())
                for n, v in w0.items())
    steps = TRAIN_CHUNK * TRAIN_CHUNKS
    log(f"[train] {steps} steps at {cfg.num_chains} chains 16x16 K={K} "
        f"h{cfg.hidden}: ms/step per chunk {[round(t, 3) for t in ms]}; "
        f"loss mean first {TRAIN_CHUNK} {float(loss[:TRAIN_CHUNK].mean()):.4f}"
        f", last {TRAIN_CHUNK} {float(loss[-TRAIN_CHUNK:].mean()):.4f}; "
        f"accept last chunk {acc_last:.4f}; mean charges2 {q2:.4f}; beta "
        f"{float(metrics[-1]['beta'][-1]):.5f}; lr "
        f"{float(metrics[-1]['lr'][-1]):.3e}; net params moved up to "
        f"{moved:.3e}")
    wilson_now = {k: launch_counts(kernels)[k]
                  for k in wilson_launches_per_step(K)}
    want = {k: v * steps for k, v in wilson_launches_per_step(K).items()}
    log(f"[train] Wilson launches {wilson_now}, derived {want}")
    gates = {
        "every loss finite": bool(torch.isfinite(loss).all()),
        "raw_eps bit-unchanged": bool(torch.equal(
            state.params.raw_eps.detach(), eps0)),
        "net params moved": moved > 0.0,
        "|x| <= pi": float(state.x.abs().max()) <= np.pi,
        f"last-chunk acceptance > {MIN_ACCEPT}": acc_last > MIN_ACCEPT,
        "mean charges2 > 0": q2 > 0.0,
        "Wilson launches as derived": wilson_now == want,
    }
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"train: failed gates {failed}")

    # serve what was trained: thermalize with HMC, then the trained chain
    eps = float(get_eps(state.params, tg.build_dynamics(cfg)[0]).detach())
    links = torch.zeros((MAIN_CHAINS, 16, 16, 2), device=device)
    links, _, _, _ = hmc_chain_u1_fused(links, gen, HMC_EPS, BETA, HMC_K,
                                        SERVE_THERM_N)
    plaqs, probs = [], []
    for _ in range(SERVE_CALLS):
        links, pl, _, pr = l2hmc_chain(links, state.params, gen, eps, BETA, K,
                                       CALL_N)
        plaqs.append(pl)
        probs.append(pr)
    plaq = float(torch.cat(plaqs).double().mean())
    acc = float(torch.cat(probs).double().mean())
    launches = launch_counts(kernels)
    log(f"[train] served the trained params with l2hmc_chain at beta={BETA}"
        f": {MAIN_CHAINS} chains, {SERVE_CALLS} x {CALL_N} transitions after"
        f" {SERVE_THERM_N} HMC; plaquette {plaq:.6f} (exact "
        f"{u1_plaq_exact(BETA):.6f}), accept {acc:.4f}; launches {launches}")
    if abs(plaq - u1_plaq_exact(BETA)) > PLAQ_TOL or acc <= MIN_ACCEPT:
        raise AssertionError(f"train: served plaquette {plaq:.6f} / accept "
                             f"{acc:.4f} out of bounds")
    for k in ("hmc_chain", "l2hmc_chain"):
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the train path")

    # the kernel path against the plain potential, in turns (plain, kernel,
    # kernel, plain), each from a copy of the trained state: the step is
    # host-bound, and the host's pace drifts within a call
    chunks = {"kernel": tg.make_train_chunk(cfg, PLAIN_TRAIN_STEPS),
              "plain": tg.make_train_chunk(
                  cfg, PLAIN_TRAIN_STEPS, make_plain_potential_fn(cfg.shape))}
    chunks["plain"](clone_state(state), gen)
    turns = {"kernel": [], "plain": []}
    for tag in ("plain", "kernel", "kernel", "plain"):
        st = clone_state(state)
        _, t = timed(lambda: chunks[tag](st, gen))
        turns[tag].append(t / PLAIN_TRAIN_STEPS)
    kernel_ms = float(np.mean(ms[1:]))
    plain_ms = min(turns["plain"])
    log(f"[train] ms per train step: Wilson kernels {kernel_ms:.3f} (chunks "
        f"2-{TRAIN_CHUNKS} of the path); in turns of {PLAIN_TRAIN_STEPS} "
        f"steps (plain, kernel, kernel, plain): kernel "
        f"{[round(t, 3) for t in turns['kernel']]}, plain potential "
        f"{[round(t, 3) for t in turns['plain']]}")
    step_fn = tg.make_train_step(cfg)[0]
    prof = device_profile(lambda: step_fn(clone_state(state), gen), 3)
    if prof is None:
        log("[train] device time per step: not measured (the profiler "
            "recorded no device time)")
    else:
        log(f"[train] device time per step (torch.profiler, 3 steps): "
            f"{prof[0]:.3f} ms in {prof[1]:.0f} kernels, busy "
            f"{prof[0] / kernel_ms:.1%} of the {kernel_ms:.3f} ms step; "
            f"top kernels (ms/step): {prof[2]}")
    return launches, kernel_ms, plain_ms

# ---------------------------------------------------------------------------
# Phase 9: the cost decomposition (l2hmc_tpu_torch/benchmarks)
# ---------------------------------------------------------------------------

RATE_SHAPES = ((2048, 256), (2048, 512))
RATE_M = (8192, 32768)        # the two chain lengths of the slope
PROBE_CHECK_M = 64
# Probe kernel vs its plain chain on the same inputs, 64 steps: the kernel
# calls the libdevice routines torch's CUDA kernels call, but contracts
# x * a + b into one FFMA where torch rounds twice (cheap, floor) and divides
# where torch multiplies by a reciprocal (div); every probe map contracts, so
# a one-ulp difference per step stays below ~64 ulp: 1e-5 absolute.
PROBE_ATOL = 1e-5
CHEAP_RATE_BAND = (0.5, 1.05)   # x F32_FLOP_PER_S
DECOMP_NT, DECOMP_REPS = 200, 2
LOCAL_NT, LOCAL_REPS = 40, 2
LOCAL_VARIANTS = "c4L1,c8L1,c8L2,c4L3"
# ablated kernel vs the same kernel on zeroed nets: S = T = Q = 0 either way
# and the rest is the same code, so the two agree bit for bit (the JAX
# package's own gate is 1e-6)
ABLATE_ATOL = 1e-6
# the ablated local kernel vs its plain version at 64x64: with S = 0 the
# circle map is the identity computed in float32, which moves each of the
# 8192 links by an ulp per half-update; the plain version alone lies 2.5e-4
# from its float64 run on 16 such chains (CPU), and the kernel 1.3e-4 from
# it (NVIDIA H100, this check's inputs)
LOCAL_ABLATE_ATOL = 3e-4
# bf16 kernel vs its plain version: both round the same float32 activations
# to bf16, but the float32 sums before the rounding run in another order, so
# an activation within ~1 ulp of a rounding boundary lands one bf16 step
# (2^-8 relative) apart on the two sides.  A hidden unit feeds every head
# output, so one such step moves S, T and Q at all 512 links and the energy
# change by ~1e-3.  Gates: the median chain agrees as in float32 (ATOL), the
# largest difference stays within BF16_ATOL, and an accept decision may
# differ only where the plain version's probability lies within BF16_ATOL of
# its uniform (such chains are excluded from the rest, at most 1 in 64).
BF16_ATOL = 2e-2
BF16_CHECK_N = 2
PLAIN_DECOMP_N, PLAIN_DECOMP_REPS = 2, 3


def plain_ms(make, n, reps):
    """Median ms per transition of ``make(n)()`` over ``reps`` windows."""
    make(1)()
    times = sorted(timed(make(n))[1] / n for _ in range(reps))
    return times[reps // 2]


def check_bf16(name, kernel_out, plain_out, us):
    """The bf16 kernel against its plain version (gates at BF16_ATOL)."""
    links_k, plaq_k, chg_k, prob_k = kernel_out
    links_p, plaq_p, chg_p, prob_p = plain_out
    flip = ((us < prob_k) != (us < prob_p)).any(dim=0)
    n_flip = int(flip.sum())
    near = float((us - prob_p).abs()[:, flip].min()) if n_flip else 0.0
    keep = ~flip
    dprob = (prob_k[:, keep] - prob_p[:, keep]).abs()
    err_links = angle_err(links_k[keep], links_p[keep])
    err_plaq = float((plaq_k[:, keep] - plaq_p[:, keep]).abs().max())
    q = torch.quantile(dprob.double().flatten(),
                       torch.tensor([0.5, 0.99], dtype=torch.float64,
                                    device=dprob.device))
    same_q = bool(torch.equal(chg_k[:, keep], chg_p[:, keep]))
    log(f"[check] {name}: max|dlinks| {err_links:.3e}  |dprob| median "
        f"{float(q[0]):.3e}, 99% {float(q[1]):.3e}, max "
        f"{float(dprob.max()):.3e}  max|dplaq| {err_plaq:.3e}  charges "
        f"equal {same_q}  accept decisions differ in {n_flip}/{us.shape[1]}"
        f" chains (closest |u - prob| {near:.3e})  mean prob "
        f"{float(prob_p.mean()):.4f}")
    if not (n_flip <= us.shape[1] // 64 and near < BF16_ATOL
            and float(q[0]) <= ATOL and float(dprob.max()) <= BF16_ATOL
            and err_links <= BF16_ATOL and err_plaq <= BF16_ATOL
            and same_q):
        raise AssertionError(f"{name}: bf16 kernel disagrees with its plain "
                             f"version (median {ATOL}, max {BF16_ATOL})")
    return max(float(dprob.max()), err_links, err_plaq)


def live_mlp_params(K, device, hidden=64):
    """MLP/u1 params of the champion's shape (16x16, h64 unless ``hidden``)
    from the port's seeded init, every array perturbed by a seeded N(0,
    0.01^2) so that S, T and Q depend on the inputs (~0.06; the chain
    accepts ~0.4)."""
    from l2hmc_tpu_torch.train.gauge import GaugeConfig, init_params

    cfg = GaugeConfig(time_size=SIDE, space_size=SIDE, num_steps=K,
                      network_arch="mlp", num_hidden=hidden,
                      merge_v_halves=True,
                      eps_init=0.125, eps_trainable=False)
    gen = torch.Generator().manual_seed(939)
    params = init_params(cfg, gen, device="cpu")
    with torch.no_grad():
        for net in (params.xnet, params.vnet):
            for p in net.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen))
    return params.to(device)


def zero_nets(params):
    import copy

    z = copy.deepcopy(params)
    with torch.no_grad():
        for net in (z.xnet, z.vnet):
            for p in net.parameters():
                p.zero_()
    return z


def probe_check(device):
    """9(a): each issue-rate probe against its plain chain at (2048, 256)."""
    from l2hmc_tpu_torch.ops.issue_rates import (PROBES, probe_chain,
                                                 probe_chain_reference)

    rng = np.random.default_rng(909)
    b, d = RATE_SHAPES[0]
    x = torch.tensor(rng.uniform(0.0, 1.0, (b, d)), dtype=torch.float32,
                     device=device)
    err = 0.0
    for p in PROBES:
        k = probe_chain(x, p.name, PROBE_CHECK_M)
        r = probe_chain_reference(x, p.name, PROBE_CHECK_M)
        torch.cuda.synchronize()
        e = float((k - r).abs().max())
        log(f"[decomp] probe {p.name}: kernel vs plain, {PROBE_CHECK_M} "
            f"steps on ({b}, {d}): max|d| {e:.3e}; finite "
            f"{bool(torch.isfinite(k).all())}")
        if not (e <= PROBE_ATOL and bool(torch.isfinite(k).all())):
            raise AssertionError(f"issue_rates {p.name}: kernel disagrees "
                                 f"with its plain chain (atol {PROBE_ATOL})")
        err = max(err, e)
    return err


def decomposition_checks(params, eps_c, K_c, device):
    """9(d), 9(e): the ablated kernels against their plain versions and
    against the same kernels on zeroed nets; the bf16 kernel against its
    plain version.  Returns ``{entry: max error}``."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain,
                                                  l2hmc_chain_reference,
                                                  l2hmc_local_chain)
    from l2hmc_tpu_torch.train.gauge import init_params

    errs = {}
    rng = np.random.default_rng(919)
    b, n, d = CHECK_CHAINS, CHECK_N, SIDE * SIDE
    links = torch.tensor(typical_links(rng, b, SIDE, SIDE, sigma=0.3),
                         device=device)
    rand = injected(rng, n, b, d, device)[:4]
    abl = l2hmc_chain(links, params, None, eps_c, BETA, K_c, n,
                      rand_arrays=rand, ablate_nets=True)
    zero = l2hmc_chain(links, zero_nets(params), None, eps_c, BETA, K_c, n,
                       rand_arrays=rand)
    plain = l2hmc_chain_reference(links, params, *rand, eps_c, BETA, K_c,
                                  ablate_nets=True)
    torch.cuda.synchronize()
    e_zero = max(float((a - z).abs().max()) for a, z in zip(abl, zero))
    log(f"[decomp] l2hmc_chain ablated vs zeroed nets ({b} chains, {n} "
        f"transitions): max|d| {e_zero:.3e} (atol {ABLATE_ATOL})")
    if e_zero > ABLATE_ATOL:
        raise AssertionError("l2hmc_chain: ablated kernel differs from the "
                             "kernel on zeroed nets")
    errs["l2hmc_chain[ablate]"] = max(e_zero, check_kernel(
        "l2hmc_chain(ablate) champion", abl, plain, rand[3]))

    # the champion's VNet trunk is dead past its first layer on such links
    # (S, T, Q do not depend on the inputs), so the bf16 products are held
    # against the plain version on live weights of the champion's shape
    live = live_mlp_params(K_c, device)
    m = BF16_CHECK_N
    rand_m = tuple(r[:m] for r in rand)
    k16 = l2hmc_chain(links, live, None, eps_c, BETA, K_c, m,
                      rand_arrays=rand_m, precision="bf16")
    p16 = l2hmc_chain_reference(links, live, *rand_m, eps_c, BETA, K_c,
                                precision="bf16")
    p32 = l2hmc_chain_reference(links, live, *rand_m, eps_c, BETA, K_c)
    torch.cuda.synchronize()
    log(f"[decomp] live weights, bf16 plain vs f32 plain: max|dprob| "
        f"{float((p16[3] - p32[3]).abs().max()):.3e}, max|dlinks| "
        f"{angle_err(p16[0], p32[0]):.3e}")
    errs["l2hmc_chain[bf16]"] = check_bf16(
        f"l2hmc_chain(bf16) live h64 {SIDE}x{SIDE}", k16, p16, rand_m[3])

    rng = np.random.default_rng(929)
    b, n, d = L64_CHAINS, L64_CHECK_N, L64_SIDE * L64_SIDE
    links = torch.tensor(typical_links(rng, b, L64_SIDE, L64_SIDE,
                                       sigma=0.27), device=device)
    rand = injected(rng, n, b, d, device)[:4]
    eps = L64_CHECK_EPS
    errs["l2hmc_local_chain[ablate]"] = 0.0
    for channels in (L64_CHANNELS, 8):     # the variants phase 9 times
        lp = init_params(local_cfg(L64_LAYERS, channels),
                         torch.Generator().manual_seed(636 + channels),
                         device=device)
        abl = l2hmc_local_chain(links, lp, None, eps, BETA, L64_K, n,
                                L64_LAYERS, rand_arrays=rand,
                                ablate_nets=True)
        zero = l2hmc_local_chain(links, zero_nets(lp), None, eps, BETA,
                                 L64_K, n, L64_LAYERS, rand_arrays=rand)
        plain = l2hmc_chain_reference(links, lp, *rand, eps, BETA, L64_K,
                                      local_layers=L64_LAYERS,
                                      ablate_nets=True)
        torch.cuda.synchronize()
        e_zero = max(float((a - z).abs().max()) for a, z in zip(abl, zero))
        log(f"[decomp] l2hmc_local_chain c={channels} ablated vs zeroed nets"
            f" ({b} chains {L64_SIDE}x{L64_SIDE}, {n} transitions): max|d| "
            f"{e_zero:.3e} (atol {ABLATE_ATOL})")
        if e_zero > ABLATE_ATOL:
            raise AssertionError("l2hmc_local_chain: ablated kernel differs "
                                 "from the kernel on zeroed nets")
        errs["l2hmc_local_chain[ablate]"] = max(
            errs["l2hmc_local_chain[ablate]"], e_zero, check_kernel(
                f"l2hmc_local_chain(ablate) c={channels} {L64_SIDE}x"
                f"{L64_SIDE}", abl, plain, rand[3], atol=LOCAL_ABLATE_ATOL))
    return errs


def issue_estimates(rates):
    """Log the per-transition issue estimates of the chain kernels at the
    main paths' shapes from the port's op counts and the measured rates."""
    from l2hmc_tpu_torch.benchmarks.vpu_roofline import (issue_estimate,
                                                         op_counts)

    cases = {
        "hmc_chain 16x16 K=5": ("hmc", MAIN_CHAINS, SIDE, HMC_K, {}),
        "hmc_chain 64x64 K=8": ("hmc", L64_CHAINS, L64_SIDE, L64_HMC_K, {}),
        "l2hmc_chain champion": ("mlp", MAIN_CHAINS, SIDE, 3,
                                 {"hidden": 64}),
        "l2hmc_chain[ablate] champion": ("ablated", MAIN_CHAINS, SIDE, 3,
                                         {}),
        "l2hmc_local_chain c4L1": ("local", L64_CHAINS, L64_SIDE, L64_K,
                                   {"channels": L64_CHANNELS,
                                    "layers": L64_LAYERS}),
        "l2hmc_local_chain[ablate]": ("ablated", L64_CHAINS, L64_SIDE,
                                      L64_K, {}),
    }
    for name, (kind, b, side, K, kw) in cases.items():
        counts = op_counts(kind, b, side, side, K, **kw)
        log(f"[decomp] issue estimate {name}: "
            f"{1e6 * issue_estimate(counts, rates):.2f} us/transition from "
            f"counts {counts}")


def decomposition_phase(params, eps_c, K_c, device):
    """Phase 9: the per-class rates, the op counts and the kernels' cost
    decomposition at the champion and local64 configs, and the champion
    served with bf16 weights."""
    from l2hmc_tpu_torch.benchmarks.kernel_decomposition import (
        decomposition, time_variants)
    from l2hmc_tpu_torch.benchmarks.local_kernel_bench import (
        parse_variants, time_local)
    from l2hmc_tpu_torch.benchmarks import best_ms
    from l2hmc_tpu_torch.benchmarks.vpu_roofline import (
        issue_estimate, measure_rates_kernel, transition_op_counts)
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.u1 import u1_plaq_exact
    from l2hmc_tpu_torch.ops.issue_rates import (probe_chain,
                                                 probe_chain_reference)
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (draw_l2hmc_randomness,
                                                  l2hmc_chain,
                                                  l2hmc_chain_reference)

    t0 = time.perf_counter()
    errs = {"issue_rates": probe_check(device)}
    errs.update(decomposition_checks(params, eps_c, K_c, device))

    kernels = reset_launches()
    # (b) the per-class rates inside the kernel
    rates_at = {}
    for b, d in RATE_SHAPES:
        rates, _ = measure_rates_kernel(b, d, m_lo=RATE_M[0],
                                        m_hi=RATE_M[1], device=device)
        rates_at[(b, d)] = rates
        log(f"[decomp] kernel rates at ({b}, {d}), m {RATE_M}: " + ", ".join(
            f"{k} {v / 1e9:.1f} Gelem/s" for k, v in rates.items())
            + f"; cheap {rates['cheap'] / F32_FLOP_PER_S:.3f} x 67e12 ops/s")
        lo, hi = CHEAP_RATE_BAND
        if not lo * F32_FLOP_PER_S <= rates["cheap"] <= hi * F32_FLOP_PER_S:
            raise AssertionError(f"cheap rate {rates['cheap']:.4g} ops/s "
                                 f"outside {CHEAP_RATE_BAND} x 67e12")
        fast = [k for k, v in rates.items() if v > hi * rates["cheap"]]
        if fast:
            raise AssertionError(f"classes {fast} read faster than the "
                                 f"cheap class: a chain was folded")
    rates = rates_at[RATE_SHAPES[0]]
    b0, d0 = RATE_SHAPES[0]
    x = torch.full((b0, d0), 0.5, device=device)
    probe_ms = best_ms(lambda: probe_chain(x, "cheap", RATE_M[0]), 2, 4)
    plain_probe_ms = best_ms(
        lambda: probe_chain_reference(x, "cheap", RATE_M[0]), 1)

    # (c) op counts at the champion shape and the issue estimates
    c_abl, c_hmc = transition_op_counts(MAIN_CHAINS, SIDE, SIDE, K_c)
    delta = {k: c_abl.get(k, 0) - c_hmc.get(k, 0)
             for k in set(c_abl) | set(c_hmc)}
    log(f"[decomp] op counts per transition at {MAIN_CHAINS} chains "
        f"{SIDE}x{SIDE} K={K_c}: ablated {c_abl}; hmc {c_hmc}; machinery "
        f"{delta}")
    issue_estimates(rates)
    mach_est = issue_estimate(delta, rates)

    # (f) the four champion variants
    gen = torch.Generator(device=device).manual_seed(9090)
    links = torch.zeros((MAIN_CHAINS, SIDE, SIDE, 2), device=device)
    links = hmc_chain_u1_fused(links, gen, HMC_EPS, BETA, HMC_K, THERM_N)[0]
    t = time_variants(links, params, gen, eps_c, BETA, K_c, DECOMP_NT,
                      reps=DECOMP_REPS)
    dec = decomposition(t, K_c, MAIN_CHAINS, f"champion {SIDE}x{SIDE}, "
                        f"{MAIN_CHAINS} chains, K={K_c}")
    mach = t["ablated"] - t["hmc"]
    log(f"[decomp] champion us/transition: " + ", ".join(
        f"{k} {1e6 * v:.1f}" for k, v in t.items())
        + f"; components {dec['component_us']}; shares "
        f"{dec['component_share_pct']}; bf16_vs_f32 "
        f"{dec['bf16_vs_f32']:.4f}; trained_over_hmc_cost_sameK "
        f"{dec['trained_over_hmc_cost_sameK']:.3f}; machinery measured "
        f"{1e6 * mach:.1f} us against its issue estimate "
        f"{1e6 * mach_est:.2f} us (ratio {mach / mach_est:.2f})")
    log(f"[decomp] {dec['floor_statement']}")

    # (g) local64: c4L1, c8L1 and their ablated forms, HMC at K=4 and K=8
    shape = u1.LatticeShape(L64_SIDE, L64_SIDE)
    links64 = u1.to_links(u1.random_links(gen, L64_CHAINS, shape,
                                          device=device), shape).contiguous()
    loc = time_local(links64, gen, parse_variants(LOCAL_VARIANTS), L64_K,
                     L64_EPS, BETA, LOCAL_NT, LOCAL_REPS,
                     hmc_ks=(("hmc_fused_kT", L64_K),
                             ("hmc_fused", L64_HMC_K)),
                     hmc_eps=L64_HMC_EPS)
    c64_abl, c64_hmc = transition_op_counts(L64_CHAINS, L64_SIDE, L64_SIDE,
                                            L64_K)
    mach64_est = issue_estimate({k: c64_abl.get(k, 0) - c64_hmc.get(k, 0)
                                 for k in c64_abl}, rates)
    for name, _, _ in parse_variants(LOCAL_VARIANTS):
        full, abl, hmc = loc[name], loc[name + "_abl"], loc["hmc_fused_kT"]
        log(f"[decomp] local64 {name}: full {full:.1f}, ablated {abl:.1f}, "
            f"hmc K=4 {hmc:.1f} us/transition; conditioner "
            f"{full - abl:.1f} ({100 * (full - abl) / full:.1f}%), machinery "
            f"{abl - hmc:.1f} ({100 * (abl - hmc) / full:.1f}%), base flow "
            f"{100 * hmc / full:.1f}%; machinery against its issue "
            f"estimate {1e6 * mach64_est:.2f} us (ratio "
            f"{(abl - hmc) * 1e-6 / mach64_est:.2f})")
    log(f"[decomp] local64 hmc K={L64_HMC_K} {loc['hmc_fused']:.1f} "
        f"us/transition")

    # (h) serving the champion with bf16 weights
    served = torch.zeros((MAIN_CHAINS, SIDE, SIDE, 2), device=device)
    served = hmc_chain_u1_fused(served, gen, HMC_EPS, BETA, HMC_K,
                                SERVE_THERM_N)[0]
    plaqs, probs = [], []
    for _ in range(SERVE_CALLS):
        served, pl, _, pr = l2hmc_chain(served, params, gen, eps_c, BETA, K_c,
                                        CALL_N, precision="bf16")
        plaqs.append(pl)
        probs.append(pr)
    plaq = float(torch.cat(plaqs).double().mean())
    acc = float(torch.cat(probs).double().mean())
    log(f"[decomp] champion served with bf16 weights: {MAIN_CHAINS} chains,"
        f" {SERVE_CALLS} x {CALL_N} transitions after {SERVE_THERM_N} HMC; "
        f"plaquette {plaq:.6f} (exact {u1_plaq_exact(BETA):.6f}), accept "
        f"{acc:.4f}")
    if abs(plaq - u1_plaq_exact(BETA)) > PLAQ_TOL or acc <= MIN_ACCEPT:
        raise AssertionError(f"bf16 serving: plaquette {plaq:.6f} / accept "
                             f"{acc:.4f} out of bounds")
    launches = read_launches("decomposition", kernels, (
        "issue_rates", "l2hmc_chain[ablate]", "l2hmc_chain[bf16]",
        "l2hmc_local_chain[ablate]", "hmc_chain"))

    # plain versions of the new variants, outside the counted path
    d = SIDE * SIDE

    def l2_plain(**kw):
        def make(n):
            r = draw_l2hmc_randomness(gen, n, MAIN_CHAINS, d, False, device)
            return lambda: l2hmc_chain_reference(links, params, *r, eps_c,
                                                 BETA, K_c, **kw)
        return make

    def local_plain(n):
        from l2hmc_tpu_torch.train.gauge import init_params

        lp = init_params(local_cfg(L64_LAYERS),
                         torch.Generator().manual_seed(5), device=device)
        r = draw_l2hmc_randomness(gen, n, L64_CHAINS, L64_SIDE * L64_SIDE,
                                  False, device)
        return lambda: l2hmc_chain_reference(
            links64, lp, *r, L64_EPS, BETA, L64_K, local_layers=L64_LAYERS,
            ablate_nets=True)

    plain = {
        "l2hmc_chain[ablate]": plain_ms(l2_plain(ablate_nets=True),
                                        PLAIN_DECOMP_N, PLAIN_DECOMP_REPS),
        "l2hmc_chain[bf16]": plain_ms(l2_plain(precision="bf16"),
                                      PLAIN_DECOMP_N, PLAIN_DECOMP_REPS),
        "l2hmc_local_chain[ablate]": plain_ms(local_plain, PLAIN_DECOMP_N,
                                              PLAIN_DECOMP_REPS),
        "issue_rates": plain_probe_ms,
    }
    ms = {"l2hmc_chain[ablate]": t["ablated"] * 1e3,
          "l2hmc_chain[bf16]": t["bf16"] * 1e3,
          "l2hmc_local_chain[ablate]": loc[
              f"c{L64_CHANNELS}L{L64_LAYERS}_abl"] * 1e-3,
          "issue_rates": probe_ms}
    b64 = bound(0.0, sum(c64_abl.values()))
    nb = {"issue_rates": bound(2 * b0 * d0 * 4, 2 * b0 * d0 * RATE_M[0]),
          "l2hmc_chain[ablate]": bound(0.0, sum(c_abl.values())),
          "l2hmc_chain[bf16]": tensor_core_chain_bound(
              MAIN_CHAINS, K_c, mlp_macs(params.xnet), sum(c_abl.values()),
              "bf16")[:2],
          "l2hmc_local_chain[ablate]": b64}
    log(f"[decomp] kernel ms {ms}; plain ms {plain}; bounds {nb}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return {"errs": errs, "ms": ms, "plain": plain, "launches": launches,
            "bound": nb}


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
    errs["l2hmc_chain"] = max(errs["l2hmc_chain"],
                              wide_check(cfg.num_steps, device))
    errs64 = local_check_phase(device)
    errs["hmc_chain"] = max(errs["hmc_chain"], errs64["hmc_chain"],
                            hmc128_check(device))
    errs["l2hmc_local_chain"] = errs64["l2hmc_local_chain"]
    results, plain, launches = main_phase(cfg, params, eps_c, device)
    r64, p64, l64 = local64_phase(device)
    werrs = wilson_check_phase(device)
    train_err = train_check_phase(device)
    tl, train_ms, train_plain_ms = train_phase(device)
    dec = decomposition_phase(params, eps_c, cfg.num_steps, device)

    from l2hmc_tpu_torch.train.gauge import init_params

    from l2hmc_tpu_torch.benchmarks.vpu_roofline import transition_op_counts

    k_c = cfg.num_steps
    hmc_b = hmc_chain_bound(MAIN_CHAINS, SIDE * SIDE, HMC_K, CALL_N)
    macs = mlp_macs(params.xnet)
    rest = sum(transition_op_counts(MAIN_CHAINS, SIDE, SIDE, k_c)[0]
               .values())
    l2_old = l2hmc_chain_bound(MAIN_CHAINS, k_c, macs)
    l2_b = tensor_core_chain_bound(MAIN_CHAINS, k_c, macs, rest)
    l16_b = tensor_core_chain_bound(MAIN_CHAINS, k_c, macs, rest, "bf16")
    lib_ms = conditioner_matmul_ms(params, k_c, device)
    ms_tr = results["champion"]["us_per_transition"] * 1e-3
    stream = weight_stream_bytes(MAIN_CHAINS, SIDE, SIDE, cfg.hidden, k_c)
    trig = local_trig_per_transition(L64_CHAINS, L64_SIDE * L64_SIDE, L64_K)
    log(f"[result] l2hmc_chain champion: {1e3 * ms_tr:.1f} us/transition; "
        f"bound {1e3 * l2_b[0]:.2f} us (tensor cores {1e3 * l2_b[2]:.2f} us "
        f"for 3 TF32 passes, the rest {1e3 * l2_b[3]:.2f} us at 67 TFLOP/s; "
        f"the float32-FMA route's bound {1e3 * l2_old[0]:.2f} us); bf16 route "
        f"bound {1e3 * l16_b[0]:.2f} us; weights streamed from L2 "
        f"{stream / 1e9:.4f} GB/transition = "
        f"{stream / (ms_tr * 1e-3) / 1e12:.3f} TB/s achieved; the ten "
        f"conditioner products as torch.matmul (float32, TF32 off) "
        f"{1e3 * lib_ms:.1f} us/transition (one CUDA graph of the 30 calls)")
    log(f"[result] l2hmc_local_chain c{L64_CHANNELS}L{L64_LAYERS}: "
        f"conditioner-input sincosf per transition {trig[0]:,} "
        f"(rebuilding them at each use: {trig[1]:,})")
    local_b = l2hmc_chain_bound(
        L64_CHAINS * L64_SIDE * L64_SIDE, L64_K, stencil_macs(
            init_params(local_cfg(L64_LAYERS), device="cpu").xnet))
    kernels = [
        {"name": "hmc_chain", "route": "cuda",
         "source": "l2hmc_tpu_torch/ops/csrc/hmc_chain.cu",
         "replaces": "l2hmc_tpu/ops/leapfrog.py:310",
         "launches": launches["hmc_chain"],
         "max_abs_err": errs["hmc_chain"],
         "ms": results["hmc"]["us_per_transition"] * 1e-3,
         "plain_ms": plain["hmc"],
         "bound_ms": hmc_b[0], "bound_by": hmc_b[1], "library_ms": None},
        {"name": "l2hmc_chain", "route": "cuda",
         "source": "l2hmc_tpu_torch/ops/csrc/l2hmc_chain.cu",
         "replaces": "l2hmc_tpu/ops/l2hmc_kernel.py:672",
         "launches": launches["l2hmc_chain"],
         "max_abs_err": errs["l2hmc_chain"],
         "ms": ms_tr,
         "plain_ms": plain["champion"],
         "bound_ms": l2_b[0], "bound_by": l2_b[1], "library_ms": lib_ms},
        {"name": "l2hmc_local_chain", "route": "cuda",
         "source": "l2hmc_tpu_torch/ops/csrc/l2hmc_local_chain.cu",
         "replaces": "l2hmc_tpu/ops/l2hmc_kernel.py:925",
         "launches": l64["l2hmc_local_chain"],
         "max_abs_err": errs["l2hmc_local_chain"],
         "ms": r64["local"]["us_per_transition"] * 1e-3,
         "plain_ms": p64["local"],
         "bound_ms": local_b[0], "bound_by": local_b[1], "library_ms": None},
    ]
    for kname, w in werrs.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "l2hmc_tpu_torch/ops/csrc/wilson.cu",
            "replaces": "l2hmc_tpu/ops/wilson.py:95",
            "launches": tl[kname], "max_abs_err": w["max_abs_err"],
            "ms": w["ms"], "plain_ms": w["plain_ms"],
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "library_ms": None})
    sources = {"issue_rates": ("issue_rates.cu",
                               "benchmarks/vpu_roofline.py:208"),
               "l2hmc_chain[ablate]": ("l2hmc_chain.cu",
                                       "l2hmc_tpu/ops/l2hmc_kernel.py:672"),
               "l2hmc_chain[bf16]": ("l2hmc_chain.cu",
                                     "l2hmc_tpu/ops/l2hmc_kernel.py:672"),
               "l2hmc_local_chain[ablate]": (
                   "l2hmc_local_chain.cu",
                   "l2hmc_tpu/ops/l2hmc_kernel.py:925")}
    for kname, (src, replaces) in sources.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"l2hmc_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": dec["launches"][kname],
            "max_abs_err": dec["errs"][kname], "ms": dec["ms"][kname],
            "plain_ms": dec["plain"][kname],
            "bound_ms": dec["bound"][kname][0],
            "bound_by": dec["bound"][kname][1], "library_ms": None})
    log("[result] ms, plain_ms and bound_ms are per transition for "
        f"hmc_chain and l2hmc_chain ({MAIN_CHAINS} chains at {SIDE}x{SIDE})"
        f" and l2hmc_local_chain ({L64_CHAINS} chains at {L64_SIDE}x"
        f"{L64_SIDE}, c={L64_CHANNELS} L={L64_LAYERS} K={L64_K}) and their "
        f"[ablate]/[bf16] modes, per launch for the Wilson kernels at (128, "
        f"16, 16, 2) (device time by torch.profiler) and for issue_rates "
        f"(the cheap probe at {RATE_SHAPES[0]}, m={RATE_M[0]}); launches are"
        f" the main paths' (Wilson: the train path's; the modes and "
        f"issue_rates: the decomposition path's); library_ms: l2hmc_chain's "
        f"ten conditioner products as torch.matmul (a yardstick for part of "
        f"its work), null elsewhere: no single PyTorch call computes these "
        f"functions.  Train step {train_ms:.3f} "
        f"ms (plain potential {train_plain_ms:.3f} ms); train-step check "
        f"max rel err {train_err:.3e}; on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"[done] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
