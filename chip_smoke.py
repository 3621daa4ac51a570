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
7. One train step through the Wilson kernels against the same step on the
   plain potential: same state and injected draws; loss, metrics, every
   gradient, updated params, x; at the README quick-start config and at
   the canonical 8x8 one (conv nets, split integrator, K=3, eps 0.35
   trainable), remat on (each leapfrog step recomputed in the backward).
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
10. Main path "cli": the README's commands through
   ``l2hmc_tpu_torch.cli.train_gauge.main`` in a temporary log dir, cut in
   length (``CLI_RUNS``): the canonical 8x8 command (200 train steps with
   checkpoints, then ``--restore`` to 300 and 3000 eval transitions per
   beta), the tuned-HMC baseline (16x16, K=4, eps 0.079, beta 5,
   Metropolis warm start, 500 transitions) and the topological quick start
   (16x16 MLP h64, 100 train steps, 300 eval transitions with a hop each
   after 500 Metropolis sweeps).  Gates on the eval files the CLI wrote:
   plaquette within 1e-3 of I1/I0 at beta_final and beta_final - 1 (its
   jackknife error printed beside it), acceptance above 0.05, the
   topological run's <Q^2> within 10% of exact; the restored run logs
   step 200 and writes step 250 first; every command's Wilson launches
   equal the count derived from its train steps and eval transitions.
11. Main path "ensembles and tuning", each sub-path's launches counted
   from 0: SMC (BASELINE config 5: 16x16, 256 particles, 31 rungs beta
   1 -> 4, 5 moves K=5 per rung on the fused ``hmc_chain``, thermalized by
   500 fused transitions at beta=1; gates: log Z against the factorized
   exact value, the weighted plaquette against I1(4)/I0(4), one
   ``hmc_chain`` launch per rung plus the thermalization); replica
   exchange (``benchmarks/pt_vs_hop.py``'s ladder: 5 rungs beta 5 -> 2,
   eps 0.079 sqrt(5/beta), K=4, 512 chains per rung, 1500 Metropolis
   sweeps each (one batched run), 1000 rounds; gates: each rung's plaquette within 1e-3,
   every active pair's swap rate inside (0, 1), no off-parity swap); AIS
   (8x8, uniform links -> beta=2 on the Wilson kernels by autograd; gate:
   log Z against the exact value); multinomial HMC (16x16 beta=4, 256
   chains, dual-averaging warmup; gate: plaquette within 1e-3); the
   autotuner (``tune_hmc`` over its default grid at 16x16 beta=4, probes
   on ``hmc_chain``: gate the DA eps at K=5 near 0.0822/0.85; then
   ``tune_l2hmc`` at the quick-start config, K = 4, 100 probe-train
   steps, probes on ``l2hmc_chain``: gate eps = lambda*/K and finite
   positive scores).

12. Main path "flow" (``dynamics/flow.py``, ``cli/train_flow.py``), launches
   counted from 0: ``configs/flow_8x8.txt`` at its widths (8x8, 16 layers,
   6 mixtures, 32 channels, batch 1024) through
   ``l2hmc_tpu_torch.cli.train_flow.main``, cut in length (``FLOW_ARGV``:
   200 reverse-KL steps, 50 fKL steps on the 4096-config buffer that two
   ``hmc_chain`` launches make, the importance-weight eval and 200 MH
   steps); every Wilson action through the kernels (forward and backward
   per step, action-only in the evals), the launches checked against the
   count derived from the code (``flow_launches``).  Gates: the fKL
   chain's plaquette within 1e-3 of I1/I0(2) (the buffer's own mean
   within 5 standard errors), the loss falling, the summary's log Z at
   most the factorized value plus 3 standard errors (a lower bound in
   expectation).  Then one reverse-KL step at ``configs/flow_16x16.txt``'s
   widths (16x16, 24 layers, 8 mixtures, 64 channels, 5x5, batch 1024) on
   the Wilson kernels against the same step on the plain action: loss
   within 1e-5, every gradient within 1e-3 of its largest entry.
13. Main path "parallel" (``parallel/``), launches counted from 0: a
   one-rank NCCL group (``file://`` rendezvous) running the dry run's six
   modes (``parallel/dryrun.run_modes``; the Wilson kernels in modes 1 and
   4, their slab route in mode 3 (dp x sp under ``lattice_sharding``),
   ``hmc_chain`` in mode 5, launches as derived), each held against the
   same run with no group and to the JAX dry run's assertions, modes 1, 3,
   4 and 5 on the kernels against their plain versions; then 10
   quick-start train steps per turn on the group and alone, and the same
   steps under ``lattice_sharding`` on the group (every Wilson call on the
   slab route, its halos wrapped on the one rank; launches as derived,
   none of the whole-lattice route) against the unsharded steps (x within
   1e-4), and one such step on the slab route's kernels against the same
   step on its plain versions (phase 7's gates); then each slab kernel
   against its plain version at the main path's extended slab (128, 18,
   16, 2) (S and the rest to 1e-5 relative, sin P to 1e-6, the backward
   exactly; the kernels line's ``max_abs_err``), and the slab route on a
   16x16 lattice of 2048 chains cut into 4
   slabs on the card (halo rows from the neighbours): the slab actions'
   sum, the slab forces, and the backward and double backward with their
   halo rows added into their owners against the whole lattice's kernels,
   and each slab against its plain versions (1e-5; the backward from the
   same sin P exactly), launches as derived.  NCCL cannot put two ranks on
   one card: the multi-rank checks are the CPU tests and a four-card call.
14. Main path "h2h and targets", each script's launches counted from 0:
   ``l2hmc_tpu_torch.benchmarks.trained_vs_hmc.main`` on the shipped
   champion at 2048 chains, 300 transitions, both tiers (``TVH_ARGV``: the
   eager harness on the Wilson kernels, the fused tier on ``l2hmc_chain``
   and ``hmc_chain``); ``hmc_ess_sweep.main`` on (K=5, eps 0.08) and (5,
   0.10) at 2048 chains; ``h2h_seeds.main`` with 1 seed of 50 train
   steps and 500 interleaved transitions at 512 chains; and
   ``l2hmc_tpu_torch.cli.train_sampler.main`` on ``configs/scg_2d.txt``
   and ``configs/mog_2d.txt``, cut in length (``SAMPLER_ARGV``), which
   launch no kernel and are host-bound, so they run in a child process
   from the end of phase 9 on, beside phases 10-13 (``targets_child``).
   Gates:
   every plaquette within 1e-3 of I1(4)/I0(4); every acceptance above 0.05;
   one sampler's eager and fused acceptances within 5 standard errors
   (``ACCEPT_TAU_FACTOR``); launches as derived from the transitions and
   train steps run (``wilson_launches_per_transition``,
   ``wilson_launches_per_step``; two calls of each chain kernel per fused
   sampler, two of ``hmc_chain`` per sweep point; none on the analytic
   path); the JSON keys, ``summary.json``'s and ``metrics.jsonl``'s, equal
   to the JAX scripts' (listed here from their sources); each target's
   eval moments within 5 standard errors of its exact mean and standard
   deviation (``moment_errors``; for the mixture, of the offset from the
   nearest mode, ``exact_moments``).

15. Main path "vae and sun", launches counted from 0 (the path runs no
   kernel: the JAX package's VAE and SU(N) modules reach no Pallas call):
   ``l2hmc_tpu_torch.cli.train_vae.main`` on ``configs/vae_digits.txt`` as
   written (20 epochs, batch 256, latent 8, hidden 256/256/64, K=5, MH=2,
   then AIS with 100 rungs on 256 held-out digits and the 200-transition
   autocovariance eval) and the AIS linear-Gaussian oracle of
   ``tests/test_vae.py``; ``train_sun.main`` at its defaults (8x8, 32
   chains, K=3, hidden 32, eps 0.15, 1000 eval transitions;
   ``SUN_RUNS``): SU(2) at beta 2 and SU(3) at beta 4 with ``--hmc``,
   SU(2) at beta 2 after 200 train steps (cut from 1000); ``train_sun
   --dims 3 3 3 3`` SU(2) at beta 0.5 (``SUN_4D_ARGV``, 200 transitions);
   and ``benchmarks.sun_nd_bench`` at its defaults (SU(3) 8^4, batch 8,
   K=4, eps 0.32/L) with ``--chunks 2``.  Eager and host-bound, it runs
   in a child process from the end of phase 9 on, beside phases 10-14
   (``vae_sun_phase``).  Gates: the final logged ELBO above the first by more
   than 5 nats, a finite summary, acceptance in (0.05, 1], AIS log p(x)
   inside the JAX CLI's range over seeds 42-44 (``VAE_JAX_AIS``) widened
   by 5 of the run's standard errors, the oracle within 0.25 nats; each
   2-D plaquette within 5 jackknife errors (over chains) and 0.02 of the
   Weyl-measure value (0.43313, 0.27930); 4-D within 0.012 of strong
   coupling with acceptance above 0.6; the JSON keys of the JAX scripts.

16. Main path "topological and volume drivers", each driver's launches
   counted from 0: ``l2hmc_tpu_torch.benchmarks.<name>.main`` at the
   widths of its defaults, cut in length (the ``*_ARGV`` constants).  In
   the main process the fused ones: ``fused_hop --champion`` (16x16, 2048
   chains, beta 4: ``hmc_chain`` and the champion's ``l2hmc_chain``, plain
   and with the fused hop), ``local64_h2h --seeds 1`` without the eager
   tier (a 2-step local_flat c4L1 training on the Wilson kernels, then
   ``l2hmc_local_chain`` against ``hmc_chain`` at 64x64, 512 chains) and
   ``scaling`` on a one-rank NCCL group.  In a child process from the end
   of phase 9 on, beside phases 10-15 (``drivers_child``), the host-bound
   ones on the eager harness: ``topo_ensemble`` (HMC, HMC+hop and
   champion+hop at 2048 chains), ``charge_mixing`` (50 of 5000 conv
   train steps), ``pt_vs_hop`` (the 5-rung ladder at beta 5),
   ``freeze_line`` at 16:5.0 (``tune_hmc`` then topo_ensemble),
   ``beta_campaign`` at 16x16, beta 3 (both tuners, HMC's K grid cut to
   (4, 5) and the probe trainings to 50 steps, then ``h2h_seeds``), ``local_cost_sweep`` (nine
   samplers at 64x64, 1024 chains) and ``volume_sweep`` (L = 8-64).
   Gates: every plaquette within 1e-3 of I1/I0 at its beta, or within 5 of
   the run's own standard errors (from the trace's ESS) where that is
   larger; the hop samplers' <Q^2> within 10% of exact; fused_hop's hop
   tunneling per step at least 10x the plain chain's, for HMC and the
   champion; every acceptance above 0.05, but local64's barely trained
   sampler, held to its plain version's on the same warm-start links
   within 5 standard errors, and charge_mixing's 50-step conv sampler,
   which accepts ~0 (not gated); launches as derived from the code
   (charge_mixing's and volume_sweep's conv evals also ``conv_stack``'s,
   one a conditioner call: ``conv_stack_launches_per_transition``); the
   JSON keys of the JAX scripts (listed from their sources); PT's swap
   rates in (0, 1); the sweeps' rates and volume_sweep's fit finite and
   positive; scaling's two topology checks on the group.
17. The conv conditioner's conv stacks (``csrc/conv_stack.cu``), run after
   phase 9, before the child processes share the card: both slots (4 and
   2 channels) at ``sample.conv16``'s shapes, 8192 chains of 16x16, one
   launch against the plain version and the eager stacks (cuDNN, TF32 off)
   within 1e-5 (``tests/test_torch_conv_stack.py``); the kernel's, the
   plain version's and the eager stacks' (``library_ms``) time per call
   (the least of 3 CUDA-event timings of back-to-back calls), beside the
   bound (2.886 GFLOP at 67 TFLOP/s, 43.1 us; ``bench_h100/counts/
   conv_stack.py``).  Its launches in the kernels line are a main path's:
   phase 10's canonical command resumed by ``--restore`` (its eval, 4K a
   transition), gated there, and in phase 16 on charge_mixing and
   volume_sweep (L = 8-32; 64x64 takes the eager stacks).

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
``torch.matmul``, of ``l2hmc_local_chain`` its 13 conditioner calls per
transition as float32 ``conv2d`` (a 3x3 convolution per stencil layer and
the 1x1 head), yardsticks the port never calls) and the
``{"ok": true, "device": ...}`` line.  The script needs a CUDA device; it
never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
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
    from l2hmc_tpu_torch._device import float32_matmuls

    float32_matmuls()
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
    from l2hmc_tpu_torch.ops.conv_stack import conv_stack
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
               "wilson_slab_forward": (W.wilson_slab_forward, "launches"),
               "wilson_slab_action_only": (W.wilson_slab_action_only,
                                           "launches"),
               "wilson_slab_backward": (W.wilson_slab_backward, "launches"),
               "wilson_slab_force": (W.wilson_slab_force, "launches"),
               "wilson_slab_double_backward": (
                   W.wilson_slab_double_backward, "launches"),
               "issue_rates": (probe_chain, "launches"),
               "conv_stack": (conv_stack, "launches")}
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


def conditioner_conv_ms(params, K, device, reps=5):
    """Yardstick for ``l2hmc_local_chain`` (library_ms; never called by the
    port): ms of one transition's conditioner calls (K+1 VNet and 2K XNet)
    as float32 ``torch.nn.functional.conv2d`` (TF32 off) at L64_CHAINS
    chains of L64_SIDE x L64_SIDE: per call each stencil layer as a 3x3
    convolution (the 5-point cross's support) with ReLU and the 1x1 head,
    the channels of each net's own weights.  Captured in a CUDA graph, its
    replay timed (median of ``reps``, CUDA events), as
    :func:`conditioner_matmul_ms`."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(12)
    layers = {}
    for name in ("v", "x"):
        net = getattr(params, name + "net")
        ws = [torch.randn((s.w.shape[2], s.w.shape[1], 3, 3), generator=gen,
                          device=device) for s in net.stencils()]
        head = torch.randn((6, net.head.w.shape[0], 1, 1), generator=gen,
                           device=device)
        inp = torch.randn((L64_CHAINS, ws[0].shape[1], L64_SIDE, L64_SIDE),
                          generator=gen, device=device)
        layers[name] = (inp, ws, head)
    nets = ["v" if i % 3 == 0 else "x" for i in range(3 * K + 1)]

    def run():
        for n in nets:
            y, ws, head = layers[n]
            for w in ws:
                y = torch.relu(F.conv2d(y, w, padding=1))
            F.conv2d(y, head)

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
    """Bytes the chain kernel streams from L2 per transition, on the route
    ``chain_route_plan`` picks with the H100's defaults: every block (or
    every CTA of a cluster) reads its net's packed chunks (its slab's share
    on the cluster route) once per MLP call."""
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (CHUNK_BYTES,
                                                  chain_route_plan)

    plan = chain_route_plan(lt, lx, h, precision, b)
    geo = plan.geo
    blocks = -(-b // plan.chains) * plan.cl
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
    """The README quick-start training recipe
    (``train.gauge.quickstart_config``)."""
    from l2hmc_tpu_torch.train.gauge import quickstart_config

    return quickstart_config()


def wilson_launches_per_step(K, remat=True):
    """Wilson kernel launches of one train step (x and z chains), split or
    merged integrator alike.  Per trajectory: K+1 fused forces (the
    leapfrog's ``grad_potential``: the start's and one per step) and the
    two Hamiltonians' forwards: the initial one's links carry no gradient
    (the action-only kernel), the final one's do (the forward that writes
    sin P); the loss's backward adds the final Hamiltonian's backward and
    one double backward per force that depends on the params (all but the
    first).  With ``remat`` (the default) the backward recomputes each
    checkpointed leapfrog step, its force included: K more forces."""
    return {"wilson_forward": 2, "wilson_action_only": 2,
            "wilson_backward": 2,
            "wilson_force": 2 * (K + 1 + (K if remat else 0)),
            "wilson_double_backward": 2 * K}


def wilson_launches_per_transition(K):
    """Wilson kernel launches of one sampling transition without gradients
    (``make_eval_chunk``): K+1 forces and the two Hamiltonians' action-only
    forwards."""
    return {"wilson_forward": 0, "wilson_action_only": 2,
            "wilson_backward": 0, "wilson_force": K + 1,
            "wilson_double_backward": 0}


def conv_stack_launches_per_transition(cfg):
    """``conv_stack`` launches of one eval transition of ``cfg`` on the
    card (``make_eval_chunk``, no grad): one a conditioner call (the split
    integrator's 4K, ``merge_v_halves``' 3K + 1, twice with
    ``both_directions``) where the conv nets take the kernel
    (``networks/nets.py conv_kernel_route``), else none."""
    from l2hmc_tpu_torch.networks.nets import ConvNetSpec, conv_kernel_route

    if cfg.hmc or cfg.network_arch != "conv":
        return 0
    spec = ConvNetSpec(cfg.time_size, cfg.space_size,
                       num_filters=cfg.num_filters, use_bf16=cfg.use_bf16,
                       x_channels=4 if cfg.group == "u1" else 2)
    if not conv_kernel_route(spec, True, True, False):
        return 0
    k = cfg.num_steps
    calls = 3 * k + 1 if cfg.merge_v_halves else 4 * k
    return calls * (2 if cfg.both_directions else 1)


def slab_launches_per_step(K, remat=True):
    """Slab-route launches of one dp x sp train step
    (``lattice_sharding``): :func:`wilson_launches_per_step`, every Wilson
    call of the step on its slab form."""
    return {k.replace("wilson_", "wilson_slab_"): v
            for k, v in wilson_launches_per_step(K, remat).items()}


def train_check_phase(device):
    """Phase 7: one train step through the Wilson kernels against the same
    step on the plain potential, at the quick-start config and at the
    canonical 8x8 one (conv nets, split integrator, trainable eps), both
    with remat on; the largest relative error of the two."""
    return max(train_check(train_cfg(), device, "16x16 mlp merged", 0.02),
               train_check(canonical_cfg(), device, "8x8 conv split", 0.002))


def canonical_cfg():
    """The README's canonical 8x8 command (README.md, "Quick start"):
    128 chains, K=3, eps 0.35 trainable, conv nets with hidden 2 x_dim =
    256, split integrator, beta 2 -> 4 over 5000 steps."""
    from l2hmc_tpu_torch.cli.train_gauge import build_parser, flags_to_config

    return flags_to_config(build_parser().parse_args(
        README_CANONICAL + ["--device", "cuda"]))


def train_check(cfg, device, label, bump, sharding=None):
    """One train step of ``cfg`` through the Wilson kernels against the same
    step on the plain potential, same state (nets perturbed by N(0,
    bump^2), optimizer past the lr warmup, near-equilibrium links) and the
    same injected draws.  The conv nets' heads start ~0.003 wide, so they
    take a smaller bump than the MLP's to keep the sampler accepting.
    With a ``sharding`` (``lattice_sharding`` of a one-rank mesh), the dp
    x sp step on the slab route's kernels against the same step on the
    slab route's plain versions."""
    from l2hmc_tpu_torch.dynamics.topo import instanton_hop_with
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import (make_plain_potential_fn,
                                            make_slab_potential_fn)
    from l2hmc_tpu_torch.parallel.mesh import shard_train_state
    from l2hmc_tpu_torch.train import gauge as tg
    from l2hmc_tpu_torch.train.schedules import beta_schedule

    b, d = cfg.num_chains, cfg.x_dim
    lt, lx = cfg.time_size, cfg.space_size
    gen = torch.Generator(device=device).manual_seed(707)
    state = tg.init_train_state(cfg, gen, device)
    rng = np.random.default_rng(707)
    with torch.no_grad():
        for net in (state.params.xnet, state.params.vnet):
            for p in net.parameters():
                p.add_(torch.tensor(bump * rng.standard_normal(p.shape),
                                    dtype=torch.float32, device=device))
    count = cfg.lr_warmup_steps + 100
    x = u1.to_flat(torch.tensor(u1.typical_links(rng, b, lt, lx, sigma=0.5),
                                device=device))
    state = state._replace(x=x, step=count,
                           opt_state=state.opt_state._replace(count=count))
    state = shard_train_state(state, None, sharding)
    draws = tg.draw_train_randomness(gen, b, d, cfg.train_hops, device,
                                     sharding=sharding)
    beta = beta_schedule(count, cfg.train_steps, cfg.beta_init,
                         cfg.beta_final)
    plain_pot = (make_plain_potential_fn(cfg.shape) if sharding is None
                 else make_slab_potential_fn(cfg.shape, sharding, plain=True))
    res = {}
    for name, pot in (("kernel", None), ("plain", plain_pot)):
        st = tg.clone_train_state(state)
        _, dyn = tg.build_dynamics(cfg, pot, sharding=sharding)
        _, loss_with = tg.make_loss_fn(cfg, dyn, sharding)
        leaves = tg.named_leaves(st.params)
        wrt = [k for k, v in leaves.items() if v.requires_grad]
        loss, _ = loss_with(st.params, st.x, beta, draws)
        grads = dict(zip(wrt, torch.autograd.grad(
            loss, [leaves[k] for k in wrt])))
        with torch.no_grad():
            tr = dyn["transition_with"](st.params, st.x, beta, draws.v_x,
                                        draws.d_x, draws.u_x)
            hop_prob = (instanton_hop_with(
                u1.wrap(tr.x_out), beta, draws.nu, draws.u_hop,
                cfg.shape, sharding).accept_prob if cfg.train_hops
                else None)
        new, m = tg.make_train_step(cfg, pot, sharding=sharding)[1](st,
                                                                     draws)
        if sharding is not None:
            new = new._replace(x=sharding.gather(new.x))
        res[name] = dict(loss=float(loss.detach()), grads=grads, state=new,
                         m=m, prob=tr.accept_prob, hop_prob=hop_prob)
    k, p = res["kernel"], res["plain"]
    tie = (draws.u_x - p["prob"]).abs() < NEAR_TIE
    if cfg.train_hops:
        tie = tie | ((draws.u_hop - p["hop_prob"]).abs() < NEAR_TIE)
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
        dp = (pk[n] - pp[n]).detach().abs()
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
    # trainable eps: one Adam step of ~lr from gradients that agree to
    # TRAIN_GRAD_RTOL, compared like the params
    eps_gate = (m_err["eps"] <= TRAIN_PARAM_LR_TOL * lr if cfg.eps_trainable
                else m_err["eps"] == 0.0)
    log(f"[train-check] {label}: kernel vs plain, one step at {b} chains "
        f"{lt}x{lx} K={cfg.num_steps} h{cfg.hidden}: loss {k['loss']:.6f} vs "
        f"{p['loss']:.6f} (rel {rel_loss:.3e}); grads max|d|/max|g| "
        f"{grad_rel:.3e}; params max|d| {param_err:.3e} lr where |g| is "
        f"not small ({param_all:.3e} lr over all, {n_small} small-|g| "
        f"elements, {flips} rounding-sized gradient sign flips); x_new "
        f"max|d| {err_x:.3e}; "
        f"metrics |d| {m_err}; excluded {n_ex}/{b}; mean prob "
        f"{float(p['prob'].mean()):.4f}")
    if not (rel_loss <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL
            and param_err <= TRAIN_PARAM_LR_TOL and err_x <= ATOL
            and m_err["accept_prob"] <= ATOL and eps_gate
            and all(m_err[key] == 0.0 for key in ("beta", "lr"))):
        raise AssertionError(f"train step ({label}): the Wilson kernels' "
                             f"step disagrees with the plain potential's")
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
    chunks["plain"](tg.clone_train_state(state), gen)
    turns = {"kernel": [], "plain": []}
    for tag in ("plain", "kernel", "kernel", "plain"):
        st = tg.clone_train_state(state)
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
    prof = device_profile(
        lambda: step_fn(tg.clone_train_state(state), gen), 3)
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
# Phase 10: the README quick start through the port's CLI
# ---------------------------------------------------------------------------

# the README's commands (README.md, "Quick start" and "The topological
# sampler"), as python -m l2hmc_tpu_torch.cli.train_gauge takes them
README_CANONICAL = ["--space_size", "8", "--time_size", "8",
                    "--num_samples", "128", "--num_steps", "3", "--eps",
                    "0.35", "--beta_init", "2", "--beta_final", "4",
                    "--train_steps", "5000"]
README_HMC = ["--hmc", "--eps", "0.2921", "--space_size", "16",
              "--time_size", "16"]
README_TOPO = ["--time_size", "16", "--space_size", "16", "--num_samples",
               "128", "--num_steps", "4", "--eps", "0.079", "--eps_fixed",
               "--network_arch", "mlp", "--num_hidden", "64",
               "--merge_v_halves", "--charge_reward", "--train_hops",
               "--beta_final", "5.0"]
README_HMC_BASELINE = ["--time_size", "16", "--space_size", "16",
                       "--num_samples", "128", "--num_steps", "4", "--eps",
                       "0.079", "--eps_fixed", "--hmc", "--beta_init", "5.0",
                       "--beta_final", "5.0", "--train_steps", "0",
                       "--eval_init", "metropolis"]
# Each command cut in length.  The canonical one trains 200 steps with
# checkpoints and no eval, then resumes to 300 and evaluates 3000
# transitions per beta, so that the plaquette's jackknife error comes near
# 2e-4 (the 1e-3 gate at ~5 sigma): at 128 chains of 8x8 it was 4.2-6.2e-4
# after 500 transitions, 1.9e-4 (beta=4) / 2.3e-4 (beta=3) after 4000 and
# 2.2e-4 / 1.6e-4 after 8000 (NVIDIA H100 80GB HBM3, 700.00 W): 300 train
# steps leave a slowly mixing sampler (acceptance ~0.35 at beta=4), whose
# error no affordable length takes reliably below 2e-4, so 8000 bought
# nothing over 4000 but ~170 s of the script's time limit (and 4000 nothing
# measurable over 3000, which phase 16's time took).  The HMC line is the
# README's tuned baseline (K=4, eps 0.079 fixed, beta 5, Metropolis warm
# start): its plain-HMC line (README_HMC, eps 0.2921 trainable) accepts
# ~0.01 at beta=4 on 16x16 and ESJD training raises eps further.  The
# topological one runs without --retrain_acc (its detector would retrain a
# 200-step training up to 3 times).
CLI_RUNS = {
    "canonical": README_CANONICAL + ["--train_steps", "200", "--save_steps",
                                     "100", "--run_steps", "0"],
    "canonical-restore": README_CANONICAL + [
        "--restore", "--train_steps", "300", "--save_steps", "100",
        "--run_steps", "3000"],
    "hmc": README_HMC_BASELINE + ["--run_steps", "500",
                                  "--eval_therm_sweeps", "500"],
    "topo": README_TOPO + ["--train_steps", "100", "--eval_hops", "1",
                           "--run_steps", "300", "--eval_init", "metropolis",
                           "--eval_therm_sweeps", "500"],
}


class _Tee:
    """A stdout that also keeps what is written (the CLI's log lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def cli_run(name, argv, log_dir, kernels, device):
    """One CLI command in-process on the card; ``(run dir, log text, Wilson
    launches, conv_stack launches, seconds)``."""
    import contextlib

    from l2hmc_tpu_torch.cli import train_gauge

    reset_launches()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = train_gauge.main(argv + ["--log_dir", str(log_dir),
                                      "--device", str(device)])
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {name}: exit code {rc}")
    # the whole-lattice route; the CLI runs unsharded, so its slab-route
    # counts (wilson_slab_*) stay 0 and are checked so
    counts = launch_counts(kernels)
    wilson = {k: v for k, v in counts.items()
              if k.startswith("wilson_") and not k.startswith("wilson_slab")}
    slab = {k: v for k, v in counts.items()
            if k.startswith("wilson_slab") and v}
    if slab:
        raise AssertionError(f"cli {name}: slab-route launches {slab} on "
                             f"an unsharded run")
    runs = sorted(log_dir.glob("run_*"), key=lambda p: int(p.name[4:]))
    log(f"[cli] {name}: {secs:.1f} s; Wilson launches {wilson}, "
        f"conv_stack {counts['conv_stack']}")
    return runs[-1], tee.text(), wilson, counts["conv_stack"], secs


def cli_phase(device):
    """Phase 10: the README's three commands through
    ``l2hmc_tpu_torch.cli.train_gauge.main``, cut in length, the canonical
    one resumed by ``--restore``; gates on the eval files the CLI wrote."""
    import re
    import tempfile
    from pathlib import Path

    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.cli.train_gauge import build_parser, flags_to_config

    kernels = reset_launches()
    out = {}
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        for name, argv in CLI_RUNS.items():
            log_dir = Path(tmp) / name.split("-")[0]
            run_dir, text, wilson, conv, secs = cli_run(
                name, argv, log_dir, kernels, device)
            args = build_parser().parse_args(argv)
            cfg = flags_to_config(args)
            mfile = run_dir / "metrics.jsonl"
            recs = ([json.loads(line) for line in
                     mfile.read_text().splitlines()] if mfile.exists()
                    else [])
            start = 0
            if "--restore" in argv:
                m = re.search(r"restored step (\d+)", text)
                start = int(m.group(1)) if m else -1
                if start != 200 or recs[0]["step"] != 250:
                    failed.append(f"{name}: restored step {start}, first "
                                  f"record step {recs[0]['step']}")
            steps = cfg.train_steps - start
            n_eval = max(min(args.run_steps, 1000), 1)
            n_tr = 2 * n_eval * -(-args.run_steps // n_eval)
            per_step = wilson_launches_per_step(cfg.num_steps)
            per_tr = wilson_launches_per_transition(cfg.num_steps)
            want = {k: steps * per_step[k] + n_tr * per_tr[k]
                    for k in per_step}
            if wilson != want:
                failed.append(f"{name}: Wilson launches {wilson}, derived "
                              f"{want}")
            conv_want = n_tr * conv_stack_launches_per_transition(cfg)
            if conv != conv_want:
                failed.append(f"{name}: conv_stack launches {conv}, derived "
                              f"{conv_want}")
            ms_step = (float(np.mean([r["dt"] for r in recs[1:]])) * 1e3
                       if len(recs) > 1 else float("nan"))
            tps = [float(x) for x in re.findall(
                r"\(([0-9.]+) transitions/s\)", text)]
            line = {"ms_per_train_step": ms_step, "transitions_per_s": tps,
                    "seconds": secs, "train_steps": steps,
                    "conv_stack_launches": conv}
            for beta in ((cfg.beta_final, cfg.beta_final - 1.0)
                         if args.run_steps else ()):
                ev = json.loads((run_dir / f"eval_beta{beta:g}.json")
                                .read_text())
                with np.load(run_dir / f"eval_beta{beta:g}.npz") as z:
                    plaq_trace = stats.therm_cut(z["plaqs"]).mean(axis=1)
                _, jk = stats.jackknife(plaq_trace)
                plaq, exact = ev["plaqs"]["mean"], ev["plaq_exact"]
                acc = ev["accept_prob"]["mean"]
                q2, q2x = (ev["charges"]["susceptibility"],
                           ev.get("q2_exact", float("nan")))
                line[f"beta{beta:g}"] = dict(
                    plaq=plaq, plaq_exact=exact, plaq_jackknife_err=jk,
                    accept=acc, q2=q2, q2_exact=q2x)
                if abs(plaq - exact) > PLAQ_TOL:
                    failed.append(f"{name} beta={beta:g}: plaquette {plaq:.6f}"
                                  f" +- {jk:.2e} against {exact:.6f}")
                if acc <= MIN_ACCEPT:
                    failed.append(f"{name} beta={beta:g}: acceptance {acc}")
                if name == "topo" and abs(q2 / q2x - 1.0) > Q2_RTOL:
                    failed.append(f"{name} beta={beta:g}: <Q^2> {q2:.4f} "
                                  f"against {q2x:.4f}")
            log(f"[cli] {name}: {json.dumps(line)}")
            out[name] = line
    if failed:
        raise AssertionError(f"cli: failed gates {failed}")
    return out


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


@contextlib.contextmanager
def block_route():
    """``l2hmc_chain`` held to its block route (``csrc/l2hmc_chain.cu``, the
    route of the ablated mode) whatever ``chain_route_plan`` would pick."""
    from l2hmc_tpu_torch.ops import l2hmc_kernel as lk

    plan = lk.chain_route_plan

    def block_plan(*a, **k):
        k["cluster"] = False
        return plan(*a, **k)

    lk.chain_route_plan = block_plan
    try:
        yield
    finally:
        lk.chain_route_plan = plan


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
    against the same kernels on zeroed nets (the MLP chain's block route,
    which runs the ablated mode; its cluster route on zeroed nets against
    the plain version); the bf16 kernel against its plain version.  Returns
    ``{entry: max error}``."""
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
    with block_route():
        zero = l2hmc_chain(links, zero_nets(params), None, eps_c, BETA, K_c,
                           n, rand_arrays=rand)
    zero_cluster = l2hmc_chain(links, zero_nets(params), None, eps_c, BETA,
                               K_c, n, rand_arrays=rand)
    plain = l2hmc_chain_reference(links, params, *rand, eps_c, BETA, K_c,
                                  ablate_nets=True)
    torch.cuda.synchronize()
    check_kernel("l2hmc_chain(zeroed nets, cluster route) champion",
                 zero_cluster, plain, rand[3])
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


# ---------------------------------------------------------------------------
# Phase 17: the conv stacks' kernel at the conv sampler's cell shapes
# ---------------------------------------------------------------------------

CONV_CHAINS = 8192
CONV_SIDE = 16
CONV_REPS = 50
CONV_TOL = 1e-5               # float32 sums in other orders (the test's)


def conv_stack_phase(device):
    """``csrc/conv_stack.cu`` at ``sample.conv16``'s shapes (the position
    net's slots; weights He-normal, biases and inputs seeded): one launch
    against the plain version and the eager stacks, and each one's time
    per call."""
    from bench_h100.counts.conv_stack import chain_bytes, chain_macs
    from l2hmc_tpu_torch.benchmarks import best_ms
    from l2hmc_tpu_torch.networks.nets import ConvNetSpec, make_conv_net
    from l2hmc_tpu_torch.ops import conv_stack as cs

    t0 = time.perf_counter()
    b, side = CONV_CHAINS, CONV_SIDE
    d = side * side
    g = torch.Generator().manual_seed(20)
    spec = ConvNetSpec(side, side, num_hidden=16, x_channels=4)
    net = make_conv_net(spec, g)
    convs = (net.conv_x1, net.conv_x2, net.conv_v1, net.conv_v2)
    with torch.no_grad():
        for c in convs:
            c.b.copy_(0.1 * torch.randn(c.b.shape, generator=g))
    net = net.to(device)
    gen = torch.Generator(device=device).manual_seed(21)
    x = torch.rand((b, 4 * d), generator=gen, device=device) * 2 - 1
    v = torch.randn((b, 2 * d), generator=gen, device=device)
    slots = [(x, net.conv_x1.w, net.conv_x1.b, net.conv_x2.w, net.conv_x2.b),
             (v, net.conv_v1.w, net.conv_v1.b, net.conv_v2.w, net.conv_v2.b)]

    def kernel():
        return cs.conv_stack(slots, side, side)

    def plain():
        return [cs.conv_stack_reference(*s, side, side) for s in slots]

    def eager():
        return (net._stack(net.conv_x1, net.conv_x2, x),
                net._stack(net.conv_v1, net.conv_v2, v))

    with torch.no_grad():
        before = cs.conv_stack.launches
        got, want, lib = kernel(), plain(), eager()
        torch.cuda.synchronize()
        launches = cs.conv_stack.launches - before
        err = max(float((k - r).abs().max())
                  for k, r in zip(got, list(want) + list(lib)))
        scale = max(float(r.abs().max()) for r in want)
        ms = {"kernel": best_ms(kernel, 3, CONV_REPS),
              "plain": best_ms(plain, 3, CONV_REPS // 10),
              "eager": best_ms(eager, 3, CONV_REPS)}
    # the position's slot takes the cos/sin features: the u1 sampler's
    sampler = {"group": "u1", "num_filters": spec.num_filters,
               "filter_size1": spec.filter_size1,
               "filter_size2": spec.filter_size2}
    bnd = bound(b * chain_bytes(d, sampler),
                2.0 * b * chain_macs(d, sampler))
    log(f"[conv_stack] {b} chains of {side}x{side}, both slots: kernel "
        f"{1e3 * ms['kernel']:.1f} us per call ({launches} launch), bound "
        f"{1e3 * bnd[0]:.1f} us ({bnd[1]}; {100 * bnd[0] / ms['kernel']:.1f}"
        f"% of it), plain {1e3 * ms['plain']:.1f} us, eager stacks (cuDNN, "
        f"library_ms) {1e3 * ms['eager']:.1f} us; max|kernel - plain, "
        f"eager| {err:.3e} (outputs up to {scale:.3f}); phase "
        f"{time.perf_counter() - t0:.1f} s")
    if launches != 1 or not err <= CONV_TOL * max(1.0, scale):
        raise RuntimeError(f"conv_stack: {launches} launches, max|d| "
                           f"{err:.3e} against {CONV_TOL} x {scale:.3f}")
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["eager"], "bound_ms": bnd[0],
            "bound_by": bnd[1], "launches": launches}


# ---------------------------------------------------------------------------
# Phase 11: ensembles and tuning
# ---------------------------------------------------------------------------

# SMC: BASELINE config 5's 16x16 setup (benchmarks/smc_u1.py defaults)
SMC_PARTICLES = 256
SMC_RUNGS = 31
SMC_BETAS = (1.0, 4.0)
SMC_MOVES = 5
SMC_K = 5
SMC_THERM_N = 500
# Bounds ~5 sd of the seed-to-seed spread at these settings, from
# `python -m l2hmc_tpu_torch.benchmarks.ensemble_spread --device cpu
# --seeds 10` (the plain versions, the HMC move): log Z -206.79 .. -208.78
# against -207.60 (sd 0.56), the weighted plaquette 0.86175 .. 0.86587
# against 0.86352 (sd 1.3e-3)
SMC_LOGZ_TOL = 3.0
SMC_PLAQ_TOL = 7e-3
# replica exchange: benchmarks/pt_vs_hop.py's ladder
PT_BETAS = tuple(float(b) for b in np.linspace(5.0, 2.0, 5))
PT_EPS = tuple(round(0.079 * float(np.sqrt(5.0 / b)), 5) for b in PT_BETAS)
PT_K = 4
PT_CHAINS = 512
PT_THERM_SWEEPS = 1500
PT_ROUNDS = 1000
PT_BURN = 200
# AIS: 8x8, uniform links (exact samples of E = 0) -> beta * S at beta = 2,
# the JAX defaults (100 rungs, eps 0.1, K=10); ensemble_spread.py (as
# above): -75.17 .. -75.35 against -75.26 (sd 0.059); the bound ~8 sd
AIS_SIDE = 8
AIS_CHAINS = 1024
AIS_BETA = 2.0
AIS_LOGZ_TOL = 0.5
# multinomial HMC (nuts_chain) at 16x16
NUTS_CHAINS = 256
NUTS_SAMPLES = 400
NUTS_ADAPT = 100
NUTS_BURN = 200
NUTS_EPS0 = 0.08
NUTS_STEPS = 16
# autotune at 16x16, beta=4: benchmarks/autotune_gauge.py's base config
TUNE_THERM_SWEEPS = 1500
TUNE_PROBE_CHAINS = 512
# the JAX tuner's cold DA eps at K=5: 0.0822 / 0.85 (RESULTS.md, the
# K=5 eps=0.0822 cell is the 0.85 multiple of the DA point);
# ensemble_spread.py (as above): 0.09574 .. 0.09745 (mean 0.09678, sd
# 5.7e-4); the bound 7 sd
TUNE_DA_EPS_K5 = 0.0822 / 0.85
TUNE_DA_TOL = 0.004
TUNE_L2_K = (4,)
TUNE_L2_TRAIN_STEPS = 250
TUNE_L2_TRAIN_CHUNK = 100      # the probe training's steps (250 in JAX)


@contextlib.contextmanager
def train_chunks_of(n):
    """``train.gauge.make_train_chunk`` building chunks of ``n`` steps
    whatever its caller asks: cuts the tuner's probe trainings (chunks of
    250) in length."""
    from l2hmc_tpu_torch.train import gauge

    make = gauge.make_train_chunk
    gauge.make_train_chunk = lambda cfg, _, *a, **k: make(cfg, n, *a, **k)
    try:
        yield
    finally:
        gauge.make_train_chunk = make


def phase_launches(path, kernels, needed):
    """Read a sub-path's launch counts (set to 0 before it) and fail if a
    kernel it runs was not launched; reset them for the next one."""
    launches = read_launches(path, kernels, needed)
    reset_launches()
    return launches


def smc_check(device, kernels):
    """SMC on the fused move: thermalize, anneal beta 1 -> 4, gate log Z
    and the weighted plaquette."""
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.dynamics.smc import (
        _eps, make_u1_fused_move, smc_beta_ladder, u1_log_z_exact_factorized,
        weighted_mean)
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn

    shape = u1.LatticeShape(SIDE, SIDE)
    gen = torch.Generator(device=device).manual_seed(1101)
    x0 = u1.random_links(gen, SMC_PARTICLES, shape, device=device)
    (links, _, _, pr), ms_th = timed(lambda: hmc_chain_u1_fused(
        u1.to_links(x0, shape), gen, _eps(shape.num_plaquettes,
                                          SMC_BETAS[0]),
        SMC_BETAS[0], SMC_K, SMC_THERM_N))
    move = make_u1_fused_move(shape, SMC_K, SMC_MOVES)
    betas = np.linspace(*SMC_BETAS, SMC_RUNGS)
    (final, ess), ms = timed(lambda: smc_beta_ladder(
        gen, u1.to_flat(links), make_potential_fn(shape), betas, move))
    launches = phase_launches("ensembles: smc", kernels, ("hmc_chain",))
    log_z = float(final.log_z)
    exact = u1_log_z_exact_factorized(shape.num_plaquettes, *SMC_BETAS)
    plaq = float(weighted_mean(final.log_w,
                               u1.observables(final.x, shape)["plaqs"]))
    plaq_x = u1.u1_plaq_exact(SMC_BETAS[1])
    line = {"log_z": log_z, "log_z_exact": exact, "plaq": plaq,
            "plaq_exact": plaq_x,
            "min_ess_frac": float(ess.min()) / SMC_PARTICLES,
            "therm_ms": ms_th, "ladder_ms": ms,
            "hmc_chain_launches": launches["hmc_chain"]}
    log(f"[ensembles] smc {SIDE}x{SIDE}, {SMC_PARTICLES} particles, "
        f"{SMC_RUNGS} rungs, {SMC_MOVES} moves K={SMC_K} (fused, one "
        f"hmc_chain launch per rung; thermalized {SMC_THERM_N} transitions "
        f"at beta={SMC_BETAS[0]:g}, accept {float(pr.mean()):.4f}): "
        f"{json.dumps(line)}")
    failed = []
    if abs(log_z - exact) > SMC_LOGZ_TOL:
        failed.append(f"smc log Z {log_z:.3f} against {exact:.3f}")
    if abs(plaq - plaq_x) > SMC_PLAQ_TOL:
        failed.append(f"smc plaquette {plaq:.5f} against {plaq_x:.5f}")
    if launches["hmc_chain"] != SMC_RUNGS:
        failed.append(f"smc: {launches['hmc_chain']} hmc_chain launches, "
                      f"not {SMC_RUNGS - 1} rungs + 1 thermalization")
    return line, failed


def pt_check(device, kernels):
    """Replica exchange on pt_vs_hop.py's ladder, every rung warm-started
    by Metropolis; gate each rung's plaquette and the swaps."""
    from l2hmc_tpu_torch.dynamics.tempering import PTConfig, pt_transition
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn

    shape = u1.LatticeShape(SIDE, SIDE)
    cfg = PTConfig(betas=PT_BETAS, eps=PT_EPS, num_steps=PT_K)
    gen = torch.Generator(device=device).manual_seed(1102)
    # every rung warm-started by one batched Metropolis run, each chain at
    # its rung's beta
    r = len(PT_BETAS)
    betas = torch.tensor(PT_BETAS, device=device).repeat_interleave(
        PT_CHAINS)[:, None, None]
    x, ms_th = timed(lambda: thermalize(
        gen, u1.random_links(gen, r * PT_CHAINS, shape, device=device), shape,
        betas, PT_THERM_SWEEPS).reshape(r, PT_CHAINS, -1))
    reset_launches()
    pot = make_potential_fn(shape)
    plaqs, q0, acc = [], [], []
    swaps = torch.zeros((2, r - 1), dtype=torch.float64, device=device)
    tries = torch.zeros_like(swaps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(PT_ROUNDS):
        out = pt_transition(pot, x, cfg, gen, i % 2)
        x = u1.wrap(out.x)
        if i >= PT_BURN:
            links = u1.to_links(x, shape)
            plaqs.append(u1.avg_plaquette(links).mean(dim=1))
            q0.append(torch.round(u1.topological_charge(links[0])))
            acc.append(out.accept_prob.mean(dim=1))
        swaps[i % 2] += out.swap_mask.sum(dim=1)
        tries[i % 2] += (out.swap_prob > 0).sum(dim=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = phase_launches("ensembles: pt", kernels, ("wilson_force",))
    plaq = torch.stack(plaqs).double().mean(dim=0).cpu().numpy()
    exact = np.array([u1.u1_plaq_exact(b) for b in PT_BETAS])
    active = np.array([[i % 2 == p for i in range(r - 1)] for p in (0, 1)])
    rate = (swaps.sum(dim=0) / tries.sum(dim=0).clamp(min=1)).cpu().numpy()
    off = float(swaps.cpu().numpy()[~active].sum())
    q2 = float((torch.stack(q0).double() ** 2).mean())
    line = {"plaq": plaq.round(6).tolist(), "plaq_exact": exact.round(6)
            .tolist(), "swap_rate": rate.round(4).tolist(),
            "accept": torch.stack(acc).double().mean(dim=0).cpu().numpy()
            .round(4).tolist(), "q2_rung0": q2,
            "q2_exact_rung0": u1.topological_susceptibility_exact(
                PT_BETAS[0], shape.num_plaquettes),
            "rounds_per_s": PT_ROUNDS / secs, "warm_start_ms": ms_th,
            "wilson_force_launches": launches["wilson_force"]}
    log(f"[ensembles] pt {SIDE}x{SIDE}, betas {PT_BETAS}, eps {PT_EPS}, "
        f"K={PT_K}, {PT_CHAINS} chains per rung, {PT_ROUNDS} rounds "
        f"(plaquettes from round {PT_BURN}; <Q^2> not gated: beta=5 "
        f"freezes): {json.dumps(line)}")
    failed = []
    for b, p, e in zip(PT_BETAS, plaq, exact):
        if abs(p - e) > PLAQ_TOL:
            failed.append(f"pt rung beta={b:g}: plaquette {p:.6f} against "
                          f"{e:.6f}")
    if not ((rate > 0) & (rate < 1)).all():
        failed.append(f"pt swap rates {rate} not strictly inside (0, 1)")
    if off != 0.0:
        failed.append(f"pt: {off:g} swaps of off-parity pairs")
    return line, failed


def ais_check(device, kernels):
    """AIS from uniform links to the Wilson action at beta=2 (every force
    by autograd through the Wilson kernels); gate log Z."""
    from l2hmc_tpu_torch.dynamics.ais import ais_log_weights, log_mean_exp
    from l2hmc_tpu_torch.dynamics.smc import u1_log_z_exact_factorized
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn

    shape = u1.LatticeShape(AIS_SIDE, AIS_SIDE)
    pot = make_potential_fn(shape)
    gen = torch.Generator(device=device).manual_seed(1103)
    x0 = u1.random_links(gen, AIS_CHAINS, shape, device=device)
    logw, ms = timed(lambda: ais_log_weights(
        gen, x0, lambda y: torch.zeros(y.shape[0], device=y.device),
        lambda y: AIS_BETA * pot(y)))
    launches = phase_launches("ensembles: ais", kernels,
                              ("wilson_forward", "wilson_backward"))
    log_z = float(log_mean_exp(logw))
    exact = u1_log_z_exact_factorized(shape.num_plaquettes, 0.0, AIS_BETA)
    line = {"log_z": log_z, "log_z_exact": exact, "ms": ms,
            "wilson_forward_launches": launches["wilson_forward"],
            "wilson_backward_launches": launches["wilson_backward"]}
    log(f"[ensembles] ais {AIS_SIDE}x{AIS_SIDE}, {AIS_CHAINS} chains, "
        f"uniform -> beta={AIS_BETA:g} (100 rungs, eps 0.1, K=10): "
        f"{json.dumps(line)}")
    if abs(log_z - exact) > AIS_LOGZ_TOL:
        return line, [f"ais log Z {log_z:.4f} against {exact:.4f}"]
    return line, []


def nuts_check(device, kernels):
    """Multinomial HMC at 16x16 beta=4 with dual-averaging warmup, from
    fused-HMC-thermalized links; gate the plaquette."""
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.dynamics.nuts import nuts_chain
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn

    shape = u1.LatticeShape(SIDE, SIDE)
    gen = torch.Generator(device=device).manual_seed(1104)
    links = torch.zeros((NUTS_CHAINS, SIDE, SIDE, 2), device=device)
    links, _, _, _ = hmc_chain_u1_fused(links, gen, HMC_EPS, BETA, HMC_K,
                                        THERM_N)
    reset_launches()
    (xs, acc, uturn), ms = timed(lambda: nuts_chain(
        make_potential_fn(shape), u1.to_flat(links), BETA, gen,
        NUTS_SAMPLES, eps0=NUTS_EPS0, max_steps=NUTS_STEPS,
        adapt_steps=NUTS_ADAPT))
    launches = phase_launches("ensembles: nuts", kernels, ("wilson_force",))
    kept = xs[NUTS_BURN:]
    plaq = float(u1.avg_plaquette(u1.to_links(kept, shape)).double().mean())
    line = {"plaq": plaq, "plaq_exact": u1.u1_plaq_exact(BETA),
            "accept_stat": float(acc[NUTS_BURN:].double().mean()),
            "uturn_frac": float(uturn[NUTS_BURN:].double().mean()),
            "ms_per_transition": ms / NUTS_SAMPLES,
            "wilson_force_launches": launches["wilson_force"]}
    log(f"[ensembles] multinomial HMC {SIDE}x{SIDE} beta={BETA:g}, "
        f"{NUTS_CHAINS} chains, L={NUTS_STEPS}, {NUTS_SAMPLES} transitions "
        f"({NUTS_ADAPT} adapting from eps {NUTS_EPS0}; plaquette from "
        f"{NUTS_BURN}): {json.dumps(line)}")
    if abs(plaq - u1.u1_plaq_exact(BETA)) > PLAQ_TOL:
        return line, [f"multinomial HMC plaquette {plaq:.6f}"]
    return line, []


def tune_check(device, kernels):
    """tune_hmc over its full default grid (probes on hmc_chain), then
    tune_l2hmc at the quick-start config (probes on l2hmc_chain); gate the
    DA eps at K=5, the l2hmc eps grid and finite positive scores."""
    import dataclasses

    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train.autotune import tune_hmc, tune_l2hmc
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    base = GaugeConfig(time_size=SIDE, space_size=SIDE, num_chains=128,
                       network_arch="mlp", num_hidden=64, merge_v_halves=True,
                       eps_init=0.35 * (64.0 / (SIDE * SIDE)) ** 0.25,
                       beta_init=2.0, beta_final=BETA)
    gen = torch.Generator(device=device).manual_seed(1105)
    x0 = u1.random_links(gen, base.num_chains, base.shape, device=device)
    x0 = thermalize(gen, x0, base.shape, BETA, TUNE_THERM_SWEEPS)
    reset_launches()
    t0 = time.perf_counter()
    hmc_opt = tune_hmc(base, x0, BETA, gen, probe_chains=TUNE_PROBE_CHAINS)
    secs_hmc = time.perf_counter() - t0
    l_hmc = phase_launches("tune: hmc", kernels,
                           ("hmc_chain", "wilson_force"))
    cfg_l2 = dataclasses.replace(train_cfg(), beta_final=BETA)
    t0 = time.perf_counter()
    with train_chunks_of(TUNE_L2_TRAIN_CHUNK):
        l2_opt = tune_l2hmc(cfg_l2, gen, hmc_opt, k_grid=TUNE_L2_K,
                            probe_train_steps=TUNE_L2_TRAIN_STEPS,
                            eps_grid=(1.0,), probe_chains=TUNE_PROBE_CHAINS,
                            device=device)
    secs_l2 = time.perf_counter() - t0
    l_l2 = phase_launches("tune: l2hmc", kernels,
                          ("l2hmc_chain", "wilson_force"))
    for c in hmc_opt.cells + l2_opt.cells:
        log(f"[tune] cell {json.dumps(c)}")
    da5 = next(c["eps_da"] for c in hmc_opt.cells if c["K"] == 5)
    lam = hmc_opt.num_steps * hmc_opt.eps
    line = {"hmc_winner": [hmc_opt.num_steps, hmc_opt.eps, hmc_opt.accept,
                           hmc_opt.score],
            "l2hmc_winner": [l2_opt.num_steps, l2_opt.eps, l2_opt.accept,
                             l2_opt.score],
            "da_eps_k5": da5, "tune_hmc_s": secs_hmc, "tune_l2hmc_s": secs_l2,
            "hmc_chain_launches": l_hmc["hmc_chain"],
            "l2hmc_chain_launches": l_l2["l2hmc_chain"]}
    log(f"[tune] {SIDE}x{SIDE} beta={BETA:g}: {json.dumps(line)}")
    failed = []
    if abs(da5 - TUNE_DA_EPS_K5) > TUNE_DA_TOL:
        failed.append(f"tune: DA eps at K=5 {da5:.5f} against "
                      f"{TUNE_DA_EPS_K5:.5f}")
    want = [round(lam / k, 5) for k in TUNE_L2_K]
    if [c["eps"] for c in l2_opt.cells] != want:
        failed.append(f"tune_l2hmc eps {[c['eps'] for c in l2_opt.cells]} "
                      f"against lambda*/K {want}")
    for c in hmc_opt.cells + l2_opt.cells:
        if not (np.isfinite(c["score"]) and c["score"] > 0):
            failed.append(f"tune cell {c}: score not finite and positive")
    routes = ({c["route"] for c in hmc_opt.cells},
              {c["route"] for c in l2_opt.cells})
    if routes != ({"hmc_chain"}, {"l2hmc_chain"}):
        failed.append(f"tune: probe routes {routes}")
    return line, failed


def ensembles_phase(device):
    """Phase 11: SMC, replica exchange, AIS, multinomial HMC and the
    autotuner, each sub-path's launches counted from 0."""
    kernels = reset_launches()
    t0 = time.perf_counter()
    out, failed = {}, []
    for name, check in (("smc", smc_check), ("pt", pt_check),
                        ("ais", ais_check), ("nuts", nuts_check),
                        ("tune", tune_check)):
        t1 = time.perf_counter()
        out[name], f = check(device, kernels)
        out[name]["seconds"] = time.perf_counter() - t1
        failed += f
    log(f"[ensembles] phase {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"ensembles: failed gates {failed}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the flow sampler
# ---------------------------------------------------------------------------

# configs/flow_8x8.txt at its widths, cut in length only
FLOW_ARGV = ["@configs/flow_8x8.txt", "--train_steps", "200",
             "--logging_steps", "50", "--fkl_steps", "50",
             "--mh_steps", "200"]
FLOW_PLAQ_TOL = 1e-3          # the fKL chain's plaquette against I1/I0(2)
FLOW_BUFFER_SE = 5.0          # the buffer's mean: within 5 standard errors
FLOW_LOGZ_SE = 3.0            # log Z: a lower bound up to 3 standard errors
# configs/flow_16x16.txt's widths for one reverse-KL step, kernel vs plain
FLOW16 = dict(time_size=16, space_size=16, num_layers=24, n_mix=8,
              hidden_channels=64, kernel_size=5)
FLOW16_BATCH = 1024
FLOW_LOSS_RTOL = 1e-5
FLOW_GRAD_RTOL = 1e-3         # max|d| over max|g|, per tensor
FLOW_ACTION_RTOL = 1e-5       # the action-only forward, per sample
FKL_CHECK_N = 8               # transitions of the fKL buffer's chain check


def flow_launches(train_steps, fkl_steps, mh_steps):
    """Kernel launches of a ``train_flow`` run: each train and fKL step's
    reverse-KL loss runs the Wilson forward (sin P kept) and, in its
    backward, the Wilson backward; the importance weights and the MH chain
    (its start and each proposal) the action-only forward; the fKL buffer
    two ``hmc_chain`` launches (600 and 100 transitions)."""
    steps = train_steps + fkl_steps
    return {"wilson_forward": steps, "wilson_backward": steps,
            "wilson_action_only": 1 + (1 + mh_steps if mh_steps else 0),
            "wilson_force": 0, "wilson_double_backward": 0,
            "hmc_chain": 2 if fkl_steps else 0}


def flow_cli_check(device, kernels):
    """The canonical 8x8 flow command through ``train_flow.main``, cut in
    length; gates on its log, metrics and summary."""
    import contextlib
    import re
    import tempfile
    from pathlib import Path

    from l2hmc_tpu_torch.cli import train_flow
    from l2hmc_tpu_torch.lattice import u1

    failed = []
    with tempfile.TemporaryDirectory() as td:
        reset_launches()
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = train_flow.main(FLOW_ARGV + ["--log_dir", td, "--device",
                                              str(device)])
        secs = time.perf_counter() - t0
        launches = launch_counts(kernels)
        run = Path(td) / "run_1"
        recs = [json.loads(line) for line in
                (run / "metrics.jsonl").read_text().splitlines()]
        summary = json.loads((run / "summary.json").read_text())
    if rc != 0:
        raise AssertionError(f"flow cli: exit code {rc}")
    args = train_flow.build_parser().parse_args(FLOW_ARGV)
    want = flow_launches(args.train_steps, args.fkl_steps, args.mh_steps)
    got = {k: launches[k] for k in want}
    if got != want:
        failed.append(f"flow cli launches {got}, derived {want}")
    train = [r for r in recs if "fkl" not in r]
    ms_step = [1e3 * r["dt"] for r in train[1:]]
    m = re.search(r"mean plaquette ([0-9.]+) \+- ([0-9.]+), chain "
                  r"([0-9.]+)", tee.text())
    buf, buf_se, chain = (float(m.group(i)) for i in (1, 2, 3))
    exact = u1.u1_plaq_exact(args.beta)
    if abs(chain - exact) > FLOW_PLAQ_TOL:
        failed.append(f"flow fKL chain plaquette {chain:.5f} against "
                      f"{exact:.5f}")
    if abs(buf - exact) > FLOW_BUFFER_SE * buf_se:
        failed.append(f"flow fKL buffer plaquette {buf:.5f} +- {buf_se} "
                      f"against {exact:.5f}")
    if not train[-1]["loss"] < train[0]["loss"]:
        failed.append(f"flow loss did not fall: {train[0]['loss']:.3f} -> "
                      f"{train[-1]['loss']:.3f}")
    ess = max(summary["weight_ess_frac"], 1e-4)
    se = float(np.sqrt(max(1.0 / ess - 1.0, 0.0) / args.eval_batch))
    bound = summary["log_z_exact_factorized"] + FLOW_LOGZ_SE * se + 0.01
    if not summary["log_z_flow"] <= bound:
        failed.append(f"flow log Z {summary['log_z_flow']} above "
                      f"{summary['log_z_exact_factorized']} + "
                      f"{FLOW_LOGZ_SE} x {se:.3f}")
    line = {"seconds": secs, "ms_per_train_step": ms_step,
            "loss_first_last": [train[0]["loss"], train[-1]["loss"]],
            "buffer_plaq": [buf, buf_se], "chain_plaq": chain,
            "plaq_exact": exact, "summary": summary, "launches": got}
    log(f"[flow] cli {' '.join(FLOW_ARGV)}: {json.dumps(line)}")
    return line, failed


def flow_cli_cfg():
    """``(FlowConfig, args)`` of FLOW_ARGV, built as ``train_flow.main``
    builds them."""
    from l2hmc_tpu_torch.cli import train_flow
    from l2hmc_tpu_torch.dynamics import flow as F

    args = train_flow.build_parser().parse_args(FLOW_ARGV)
    return F.FlowConfig(time_size=args.time_size or args.size,
                        space_size=args.size, num_layers=args.num_layers,
                        n_mix=args.n_mix, hidden_channels=args.hidden_channels,
                        kernel_size=args.kernel_size,
                        conditioner_depth=args.conditioner_depth), args


def flow_step_check(device, cfg, batch, beta, seed, eval_batches=()):
    """One reverse-KL step of ``cfg`` at ``batch`` on the Wilson kernels
    against the same step on the plain action: same parameters (the port's
    init with the output convs moved off zero), same base samples; loss
    and every gradient.  ``eval_batches``: the action-only forward of the
    evals (importance weights, MH) on as many flow samples, against the
    plain forward."""
    from l2hmc_tpu_torch.dynamics import flow as F
    from l2hmc_tpu_torch.ops import wilson as W

    gen = torch.Generator(device=device).manual_seed(seed)
    params = F.init_flow(gen, cfg, device)
    with torch.no_grad():
        for layer in params:
            layer.c2.w.copy_(0.01 * torch.randn(
                layer.c2.w.shape, generator=gen, device=device))
    z = F.draw_base(gen, batch, cfg, device)
    named = dict(params.named_parameters())

    def step(action_fn):
        loss, _ = F.reverse_kl_loss_with(params, z, beta, cfg, action_fn)
        return loss.detach(), torch.autograd.grad(loss, list(named.values()))

    out, ms = {}, {}
    for name, fn in (("kernel", F.wilson_action), ("plain", W.wilson_action),
                     ("plain", W.wilson_action), ("kernel", F.wilson_action)):
        step(fn)
        out[name], t = timed(lambda: step(fn))
        ms.setdefault(name, []).append(t)
    loss_err = abs(float(out["kernel"][0] - out["plain"][0])) / abs(
        float(out["plain"][0]))
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
                   for a, b in zip(out["kernel"][1], out["plain"][1]))
    action_err = 0.0
    with torch.no_grad():
        for b in eval_batches:
            x, _ = F.sample_and_logq(params, gen, b, cfg)
            want = W.wilson_action(x)
            action_err = max(action_err, float(
                ((F.wilson_action(x) - want).abs() / want.abs()).max()))
    failed = []
    label = f"flow {cfg.time_size}x{cfg.space_size}"
    if loss_err > FLOW_LOSS_RTOL:
        failed.append(f"{label} loss rel err {loss_err:.3e}")
    if grad_err > FLOW_GRAD_RTOL:
        failed.append(f"{label} grad rel err {grad_err:.3e}")
    if action_err > FLOW_ACTION_RTOL:
        failed.append(f"{label} action-only rel err {action_err:.3e}")
    line = {"loss": float(out["kernel"][0]), "loss_rel_err": loss_err,
            "grad_max_rel_err": grad_err, "ms_kernel": ms["kernel"],
            "ms_plain": ms["plain"]}
    if eval_batches:
        line["action_only_rel_err"] = action_err
    log(f"[flow] reverse-KL step at {cfg}, batch {batch}, beta {beta}"
        + (f", action-only at batches {list(eval_batches)}"
           if eval_batches else "") + f": {json.dumps(line)}")
    return line, failed


def fkl_hmc_check(device):
    """``hmc_chain`` at the fKL buffer's shapes (``train_flow``: 2048 chains
    of the flow lattice, K=5, its eps and beta) on injected draws against
    its plain version, from the buffer's cold start and from
    near-equilibrium links.  Returns the largest error."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain, hmc_chain_reference

    cfg, args = flow_cli_cfg()
    lt, lx = cfg.time_size, cfg.space_size
    b, n, d = args.fkl_buffer // 2, FKL_CHECK_N, lt * lx
    rng = np.random.default_rng(1202)
    v0s, v1s, _, us, _, _ = injected(rng, n, b, d, device)
    err = 0.0
    # <cos P> = exp(-2 sigma^2) ~ 0.70, beta=2's plaquette
    for tag, links in (
            ("cold", torch.zeros((b, lt, lx, 2), device=device)),
            ("typical", torch.tensor(typical_links(rng, b, lt, lx,
                                                   sigma=0.42),
                                     device=device))):
        out_k = hmc_chain(links, None, args.fkl_hmc_eps, args.beta, 5, n,
                          rand_arrays=(v0s, v1s, us))
        out_p = hmc_chain_reference(links, v0s, v1s, us, args.fkl_hmc_eps,
                                    args.beta, 5)
        torch.cuda.synchronize()
        err = max(err, check_kernel(
            f"hmc_chain {lt}x{lx} {b} ch K=5 eps={args.fkl_hmc_eps} "
            f"beta={args.beta} ({tag} links, the fKL buffer)", out_k, out_p,
            us))
    return err


def flow_phase(device):
    """Phase 12: the flow CLI (launches counted from 0); its kernels at its
    shapes against their plain versions (a reverse-KL step and the evals'
    action-only forward at FLOW_ARGV's widths, the fKL buffer's
    ``hmc_chain``); the step at flow_16x16's widths kernel vs plain."""
    from l2hmc_tpu_torch.dynamics import flow as F

    kernels = reset_launches()
    t0 = time.perf_counter()
    cli, failed = flow_cli_check(device, kernels)
    cfg8, args = flow_cli_cfg()
    step8, f8 = flow_step_check(device, cfg8, args.batch, args.beta, 1203,
                                (args.eval_batch, args.eval_batch // 4))
    hmc_err = fkl_hmc_check(device)
    step16, f16 = flow_step_check(device, F.FlowConfig(**FLOW16),
                                  FLOW16_BATCH, 4.0, 1201)
    log(f"[flow] phase {time.perf_counter() - t0:.1f} s")
    failed += f8 + f16
    if failed:
        raise AssertionError(f"flow: failed gates {failed}")
    return {"cli": cli, "step8": step8, "step16": step16,
            "hmc_chain_err": hmc_err}


# ---------------------------------------------------------------------------
# Phase 13: the multi-device path on a one-rank NCCL group
# ---------------------------------------------------------------------------

PAR_STEPS = 10                 # train steps per timed turn, group vs none


def parallel_launches():
    """Launches of ``run_modes(1)``: mode 1 one train step at K=2
    (``wilson_launches_per_step``), mode 3 the same step on the slab route
    (``slab_launches_per_step``), mode 4 one reverse-KL loss and gradient
    (forward, backward), mode 5 five rungs of one fused move each and one
    action-only forward each (the reweighting)."""
    want = wilson_launches_per_step(2)
    want.update(slab_launches_per_step(2))
    want["wilson_forward"] += 1
    want["wilson_backward"] += 1
    want["wilson_action_only"] += 5
    want["hmc_chain"] = 5
    return want


def modes_kernel_err(kernel, plain):
    """``{mode: (error, tolerance)}`` of the dry run's modes 1, 4 and 5 on
    the kernels against the same modes on the plain versions
    (``run_modes(moves="injected")`` against ``moves="plain"``): the train
    steps' links, acceptance, loss and updated parameters (mode 1's and
    mode 3's, on the slab route); the flow step's
    loss and gradient; the SMC ladder's particles, log Z and ESS."""
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))

    def step_err(tr, tp):
        return max(angle_err(tr["x"], tp["x"]),
                   abs(tr["accept_prob"] - tp["accept_prob"]),
                   abs(tr["loss"] - tp["loss"]) / abs(tp["loss"]),
                   rel(tr["params"], tp["params"]))

    fk, fp = kernel["flow"], plain["flow"]
    sk, sp = kernel["smc"], plain["smc"]
    return {
        "train_step": (step_err(kernel["train_step"], plain["train_step"]),
                       ATOL),
        "lattice_step": (step_err(kernel["lattice_step"],
                                  plain["lattice_step"]), ATOL),
        "flow": (max(abs(fk["loss"] - fp["loss"]) / abs(fp["loss"]),
                     rel(fk["grads"], fp["grads"])), FLOW_GRAD_RTOL),
        "smc": (max(angle_err(sk["x"], sp["x"]),
                    abs(sk["log_z"] - sp["log_z"]),
                    float((sk["ess"] - sp["ess"]).abs().max())), ATOL),
    }


SLAB_SHAPE = (2048, 16, 16)     # chains, Lt, Lx of the slab route check
SLAB_CUTS = 4                   # slabs cut from one lattice on the card
# the slab route against the whole lattice's kernels and the slab's plain
# versions: S and dg to 1e-5 of the sum of their terms' magnitudes (the
# slabs' partial sums added in another order), forces and gradients to
# 1e-5 of their largest entry (a halo row's gradient added into its owner's
# is a sum in another order), the backward from the same sin P exactly
SLAB_RTOL = 1e-5


def slab_bounds(b, e, lx):
    """``{kernel: (bound_ms, bound_by)}`` of the slab route on extended
    slabs ``(b, e, lx, 2)`` (``e - 2`` owned rows): the forward reads the
    slab and writes sin P and S (7 operations per owned site), the
    action-only forward reads the slab and writes S (6), the backward reads
    sin P and g and writes the gradient on the extended slab (4 per site),
    the force reads the slab and g and writes the owned force (8 per owned
    site), the double backward (the force's) reads the slab, g and the
    owned cotangent and writes the extended gradient and dg (14 per
    site)."""
    s, own = b * e * lx, b * (e - 2) * lx
    return {"wilson_slab_forward": bound(s * 8 + s * 4 + b * 4, 7 * own),
            "wilson_slab_action_only": bound(s * 8 + b * 4, 6 * own),
            "wilson_slab_backward": bound(s * 4 + b * 4 + s * 8, 4 * s),
            "wilson_slab_force": bound(s * 8 + b * 4 + own * 8, 8 * own),
            "wilson_slab_double_backward": bound(
                s * 8 + b * 8 + own * 8 + s * 8, 14 * s)}


def slab_errors(W, links, g, w, n):
    """The slab route on ``n`` slabs cut from ``links`` (halo rows from the
    neighbours) against the whole lattice's kernels and against the slab
    plain versions: ``({kernel: max abs error}, failures, text)``."""
    lt = links.shape[1]
    k = lt // n
    exts = W.cut_slabs(links, n)
    wext = W.cut_slabs(w, n)
    s_w, sinp_w = W.wilson_forward(links)
    force_w = W.wilson_force(links, g)
    bwd_w = W.wilson_backward(sinp_w, g)
    dl_w, dg_w = W.wilson_double_backward(links, g, w)
    got = {"S": [], "S_only": [], "sinp": [], "bwd": [], "force": [],
           "dext": [], "dg": [], "adext": [], "adg": []}
    plain = {key: [] for key in got}
    for c, (e, we) in enumerate(zip(exts, wext)):
        w_own = w[:, c * k:(c + 1) * k].contiguous()
        sk, sinpk = W.wilson_slab_forward(e)
        sp, sinpp = W.wilson_slab_forward_reference(e)
        for dst, fns in ((got, (W.wilson_slab_backward,
                                W.wilson_slab_force,
                                W.wilson_slab_double_backward)),
                         (plain, (W.wilson_slab_backward_reference,
                                  W.wilson_slab_force_reference,
                                  W.wilson_slab_double_backward_reference))):
            bwd, force, dbl = fns
            dst["bwd"].append(bwd(sinpp, g))
            dst["force"].append(force(e, g))
            dext, dg = dbl(e, g, w_own, 0, 1)
            dst["dext"].append(dext)
            dst["dg"].append(dg)
            adext, adg = dbl(e, g, we, 1, 0)
            dst["adext"].append(adext)
            dst["adg"].append(adg)
        got["S"].append(sk)
        got["S_only"].append(W.wilson_slab_action_only(e))
        got["sinp"].append(sinpk)
        plain["S"].append(sp)
        plain["S_only"].append(sp)
        plain["sinp"].append(sinpp)
    torch.cuda.synchronize()
    p = W._plaq_sums(links[..., 0], links[..., 1])
    s_scale = torch.sum(1.0 - torch.cos(p), dim=(1, 2))
    r = (w[..., 0] - torch.roll(w[..., 0], -1, -1) - w[..., 1]
         + torch.roll(w[..., 1], -1, -2))
    dg_scale = torch.sum(torch.abs(r * torch.sin(p)), dim=(1, 2))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def rel_sum(a, b, scale):
        return float(((a - b).abs() / scale).max())

    whole = {
        "S": rel_sum(sum(got["S"]), s_w, s_scale),
        "S_only": rel_sum(sum(got["S_only"]), s_w, s_scale),
        "force": rel(torch.cat(got["force"], dim=1), force_w),
        "bwd": rel(W.join_slab_grads(got["bwd"], lt), bwd_w),
        "dext": rel(W.join_slab_grads(got["dext"], lt), dl_w),
        "dg": rel_sum(sum(got["dg"]), dg_w, dg_scale),
    }
    vs_plain = {key: max(rel(a, b) for a, b in zip(got[key], plain[key]))
                for key in ("force", "dext", "adext")}
    vs_plain["S"] = max(rel_sum(a, b, s_scale)
                        for a, b in zip(got["S"], plain["S"]))
    vs_plain["S_only"] = max(rel_sum(a, b, s_scale)
                             for a, b in zip(got["S_only"], plain["S"]))
    vs_plain["dg"] = max(rel_sum(a, b, dg_scale)
                         for a, b in zip(got["dg"], plain["dg"]))
    vs_plain["adg"] = max(rel(a, b) for a, b in zip(got["adg"],
                                                    plain["adg"]))
    bwd_exact = max(float((a - b).abs().max())
                    for a, b in zip(got["bwd"], plain["bwd"]))
    sin_err = max(float((a - b).abs().max())
                  for a, b in zip(got["sinp"], plain["sinp"]))
    fails = [f"{key} vs whole" for key, v in whole.items()
             if not v <= SLAB_RTOL]
    fails += [f"{key} vs plain" for key, v in vs_plain.items()
              if not v <= SLAB_RTOL]
    if bwd_exact != 0.0:
        fails.append("backward vs plain (exact)")
    if not sin_err <= SINP_ATOL:
        fails.append("sin P vs plain")

    def abs_err(key):
        return max(float((a - b).abs().max())
                   for a, b in zip(got[key], plain[key]))

    errs = {"wilson_slab_forward": max(abs_err("S"), sin_err),
            "wilson_slab_action_only": abs_err("S_only"),
            "wilson_slab_backward": bwd_exact,
            "wilson_slab_force": abs_err("force"),
            "wilson_slab_double_backward": max(abs_err("dext"),
                                               abs_err("dg"),
                                               abs_err("adext"),
                                               abs_err("adg"))}
    txt = (f"vs the whole lattice's kernels (rel) "
           + ", ".join(f"{k} {v:.3e}" for k, v in whole.items())
           + "; vs the slab plain versions (rel) "
           + ", ".join(f"{k} {v:.3e}" for k, v in vs_plain.items())
           + f", sin P max|d| {sin_err:.3e}, backward max|d| "
           f"{bwd_exact:.3e}")
    return errs, fails, txt


def slab_check(device, kernels):
    """(c) The slab route of the Wilson kernel: one 16x16 lattice of 2048
    chains cut into 4 slabs on the card, each slab's kernels against the
    whole lattice's kernels (the slab sums added, the halo rows' gradients
    added into their owners) and against the slab plain versions, uniform
    and near-equilibrium links; the launches of the check against the
    derived count."""
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops import wilson as W

    b, lt, lx = SLAB_SHAPE
    rng = np.random.default_rng(1314)
    worst, fails = {}, []
    reset_launches()
    for kind in ("typical", "uniform"):
        a = (typical_links(rng, b, lt, lx, sigma=0.3) if kind == "typical"
             else rng.uniform(-np.pi, np.pi, (b, lt, lx, 2)))
        links = torch.tensor(a, dtype=torch.float32, device=device)
        g = torch.full((b,), BETA, device=device)
        w = torch.tensor(rng.standard_normal((b, lt, lx, 2)),
                         dtype=torch.float32, device=device)
        errs, f, txt = slab_errors(W, links, g, w, SLAB_CUTS)
        log(f"[parallel] slab route ({b}, {lt}, {lx}, 2) in {SLAB_CUTS} "
            f"slabs, {kind} links: {txt}")
        fails += [f"{kind} {x}" for x in f]
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in errs.items()}
    got = {k: v for k, v in launch_counts(kernels).items()
           if k.startswith("wilson_slab")}
    per = {"wilson_slab_forward": 1, "wilson_slab_action_only": 1,
           "wilson_slab_backward": 1, "wilson_slab_force": 1,
           "wilson_slab_double_backward": 2}
    want = {k: 2 * SLAB_CUTS * v for k, v in per.items()}
    if got != want:
        fails.append(f"slab check launches {got}, derived {want}")
    reset_launches()
    return worst, fails


def slab_vs_plain(W, ext, g, w, sinp):
    """Each slab-route kernel against its plain version on the same
    extended slab ``ext (b, e, lx, 2)``, owned-row cotangent ``w`` and
    plain ``sinp``: ``({kernel: max abs error}, failures, text)``.  S to
    SLAB_RTOL of itself (a sum of non-negative terms), sin P to SINP_ATOL,
    the backward from the same sin P exactly, the forces, gradients and dg
    to SLAB_RTOL of their largest entry."""
    b = ext.shape[0]
    w_ext = torch.cat([torch.zeros_like(ext[:, :1]), w,
                       torch.zeros_like(ext[:, :1])], dim=1)
    s_k, sinp_k = W.wilson_slab_forward(ext)
    s_p, sinp_p = W.wilson_slab_forward_reference(ext)
    pairs = {
        "S": (s_k, s_p), "sinp": (sinp_k, sinp_p),
        "S_only": (W.wilson_slab_action_only(ext), s_p),
        "bwd": (W.wilson_slab_backward(sinp, g),
                W.wilson_slab_backward_reference(sinp, g)),
        "force": (W.wilson_slab_force(ext, g),
                  W.wilson_slab_force_reference(ext, g)),
    }
    for tag, cot, a, c in (("", w, 0, 1), ("a", w_ext, 1, 0)):
        dk = W.wilson_slab_double_backward(ext, g, cot, a, c)
        dp = W.wilson_slab_double_backward_reference(ext, g, cot, a, c)
        pairs[tag + "dext"] = (dk[0], dp[0])
        pairs[tag + "dg"] = (dk[1], dp[1])
    torch.cuda.synchronize()
    absd = {k: float((a - p).abs().max()) for k, (a, p) in pairs.items()}
    rel = {k: absd[k] / max(float(p.abs().max()), 1e-30)
           for k, (a, p) in pairs.items()}
    rel["S"] = float(((s_k - s_p).abs() / s_p).max())
    rel["S_only"] = float(((pairs["S_only"][0] - s_p).abs() / s_p).max())
    fails = [k for k, v in rel.items()
             if k not in ("sinp", "bwd") and not v <= SLAB_RTOL]
    if not absd["sinp"] <= SINP_ATOL:
        fails.append("sinp")
    if absd["bwd"] != 0.0:
        fails.append("bwd (exact)")
    errs = {"wilson_slab_forward": max(absd["S"], absd["sinp"]),
            "wilson_slab_action_only": absd["S_only"],
            "wilson_slab_backward": absd["bwd"],
            "wilson_slab_force": absd["force"],
            "wilson_slab_double_backward": max(
                absd[k] for k in ("dext", "dg", "adext", "adg"))}
    txt = (f"({b}, {ext.shape[1]}, {ext.shape[2]}, 2) kernels vs plain "
           f"(rel) " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
           + f"; max|d| {errs}")
    return errs, fails, txt


def slab_times(device, b, e, lx):
    """Each slab-route kernel against its plain version on extended slabs
    ``(b, e, lx, 2)`` (:func:`slab_vs_plain`), then the device time per
    launch of each and of its plain version (torch.profiler, inputs cycled
    through copies larger than twice the L2)."""
    from l2hmc_tpu_torch.benchmarks import device_profile
    from l2hmc_tpu_torch.ops import wilson as W

    gen = torch.Generator(device=device).manual_seed(1315)
    copies = max(2, int(2 * 50e6 // (b * e * lx * 8 * 3)) + 1)
    sets = []
    for _ in range(copies):
        ext = (torch.rand((b, e, lx, 2), generator=gen, device=device)
               * 2 * np.pi - np.pi)
        w = torch.randn((b, e - 2, lx, 2), generator=gen, device=device)
        sinp = W.wilson_slab_forward_reference(ext)[1]
        sets.append((ext, torch.full((b,), BETA, device=device), w, sinp))
    errs, fails, txt = slab_vs_plain(W, *sets[0])
    log(f"[parallel] slab route at the main path's shape: {txt}")
    runs = {
        "wilson_slab_forward": (
            lambda x, g, w, s: W.wilson_slab_forward(x),
            lambda x, g, w, s: W.wilson_slab_forward_reference(x)),
        "wilson_slab_action_only": (
            lambda x, g, w, s: W.wilson_slab_action_only(x),
            lambda x, g, w, s: W.wilson_slab_forward_reference(x)[0]),
        "wilson_slab_backward": (
            lambda x, g, w, s: W.wilson_slab_backward(s, g),
            lambda x, g, w, s: W.wilson_slab_backward_reference(s, g)),
        "wilson_slab_force": (
            lambda x, g, w, s: W.wilson_slab_force(x, g),
            lambda x, g, w, s: W.wilson_slab_force_reference(x, g)),
        "wilson_slab_double_backward": (
            lambda x, g, w, s: W.wilson_slab_double_backward(x, g, w, 0, 1),
            lambda x, g, w, s: W.wilson_slab_double_backward_reference(
                x, g, w, 0, 1)),
    }
    out = {}
    for name, pair in runs.items():
        ms = []
        for fn in pair:
            it = iter(range(1 << 30))

            def call(fn=fn, it=it):
                fn(*sets[next(it) % len(sets)])

            call()
            # the profiler occasionally drops a window's kernels: up to
            # four windows before the host-timed fallback (reported so)
            prof = device_profile(call, WILSON_PROFILE_REPS, tries=4)
            if prof is None:
                _, t = timed(lambda: [call() for _ in range(WILSON_REPS)])
                ms.append((t / WILSON_REPS, "call"))
            else:
                ms.append((prof[0], "device"))
        out[name] = {"ms": ms[0][0], "plain_ms": ms[1][0],
                     "timed_by": f"{ms[0][1]}, plain {ms[1][1]}"}
    return out, errs, fails


def parallel_phase(device):
    """Phase 13: the dry run's six modes on a one-rank NCCL group
    (``file://`` rendezvous), held against the same run with no group;
    modes 1, 3, 4 and 5 with no group on the kernels (mode 5's chain on
    injected draws) against their plain versions; a quick-start train step
    on the group against the same step alone; the same step under
    ``lattice_sharding`` (the slab route of the Wilson kernel, every halo
    wrapped on the one rank) against the step with no sharding; the slab
    route on four slabs cut from one lattice against the whole lattice's
    kernels and its plain versions."""
    import tempfile

    import torch.distributed as dist

    from l2hmc_tpu_torch.parallel import dryrun
    from l2hmc_tpu_torch.parallel.mesh import (get_mesh, lattice_sharding,
                                               shard_train_state)
    from l2hmc_tpu_torch.train.gauge import (init_train_state,
                                             make_train_step)

    kernels = reset_launches()
    t0 = time.perf_counter()
    failed = []
    cfg = train_cfg()
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo",
            init_method=f"file://{td}/rdv", rank=0, world_size=1)
        try:
            grouped = dryrun.run_modes(1, device, td)
            launches = phase_launches("parallel", kernels,
                                      ("wilson_force", "wilson_slab_force",
                                       "hmc_chain"))
            mesh = get_mesh(device=device)

            def steps(m, sharded=False):
                gen = torch.Generator(device=device).manual_seed(1301)
                sp = lattice_sharding(m, cfg.shape) if sharded else None
                state = shard_train_state(init_train_state(cfg, gen, device),
                                          m, sp)
                step, _ = make_train_step(cfg, mesh=m, sharding=sp)
                state, _ = step(state, gen)
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                for _ in range(PAR_STEPS):
                    state, metrics = step(state, gen)
                torch.cuda.synchronize(device)
                x = state.x if sp is None else sp.gather(state.x)
                return 1e3 * (time.perf_counter() - t) / PAR_STEPS, x

            turns = [(name, steps(m)) for name, m in (
                ("nccl", mesh), ("alone", None), ("alone", None),
                ("nccl", mesh))]
            # the main path of the slab route: the quick-start step under
            # lattice_sharding, launches counted from 0
            reset_launches()
            sharded = steps(mesh, sharded=True)
            slab_path = phase_launches("parallel lattice_sharding", kernels,
                                       ("wilson_slab_force",))
            # the same step on the slab route's plain versions, phase 7's
            # gates
            sharded_vs_plain = train_check(
                cfg, device, "16x16 mlp merged, lattice_sharding", 0.02,
                lattice_sharding(mesh, cfg.shape))
        finally:
            dist.destroy_process_group()
    alone = dryrun.run_modes(1, device)
    # the kernels against their plain versions: the one run launches what
    # the path launches, the other nothing
    reset_launches()
    injected = dryrun.run_modes(1, device, moves="injected")
    inj_launches = launch_counts(kernels)
    reset_launches()
    plain = dryrun.run_modes(1, device, moves="plain")
    plain_launches = {k: v for k, v in launch_counts(kernels).items() if v}
    reset_launches()
    dryrun.check_modes(grouped, 1)
    errs = modes_kernel_err(injected, plain)
    for mode, (err, tol) in errs.items():
        if not err <= tol:
            failed.append(f"parallel mode {mode} kernel vs plain {err:.3e} "
                          f"(tolerance {tol})")
    want = parallel_launches()
    got = {k: launches[k] for k in want}
    if got != want:
        failed.append(f"parallel launches {got}, derived {want}")
    if {k: inj_launches[k] for k in want} != want or plain_launches:
        failed.append(f"parallel kernel vs plain: launches {inj_launches} "
                      f"and {plain_launches}, derived {want} and none")
    diff = dryrun.modes_diff(grouped, alone)
    # one rank: every collective is the identity; the flow's convolutions
    # may pick other cuDNN algorithms from one call to the next
    if max(diff.values()) > 1e-4:
        failed.append(f"parallel modes against no group: {diff}")
    x_diff = float((turns[0][1][1] - turns[1][1][1]).abs().max())
    if x_diff > 1e-4:
        failed.append(f"parallel train step, group vs alone: x {x_diff}")
    sharded_x_diff = float((sharded[1] - turns[1][1][1]).abs().max())
    if sharded_x_diff > 1e-4:
        failed.append(f"parallel lattice_sharding step vs no sharding: x "
                      f"{sharded_x_diff}")
    want_slab = {k: v * (PAR_STEPS + 1)
                 for k, v in slab_launches_per_step(cfg.num_steps).items()}
    got_slab = {k: slab_path[k] for k in want_slab}
    whole_in_slab = {k: v for k, v in slab_path.items()
                     if v and k not in want_slab}
    if got_slab != want_slab or whole_in_slab:
        failed.append(f"parallel lattice_sharding launches {got_slab} and "
                      f"{whole_in_slab}, derived {want_slab} and none")
    slab_err, slab_fails = slab_check(device, kernels)
    failed += [f"slab route {f}" for f in slab_fails]
    e = cfg.time_size + 2
    times, main_err, main_fails = slab_times(device, cfg.num_chains, e,
                                             cfg.space_size)
    failed += [f"slab route at the main path's shape: {f}"
               for f in main_fails]
    bounds = slab_bounds(cfg.num_chains, e, cfg.space_size)
    # max_abs_err: kernel against plain on the main path's extended slabs
    slab = {name: {"launches": got_slab[name],
                   "max_abs_err": main_err[name],
                   "max_abs_err_4_slabs": slab_err[name],
                   "ms": times[name]["ms"],
                   "plain_ms": times[name]["plain_ms"],
                   "timed_by": times[name]["timed_by"],
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
            for name in want_slab}
    line = {"modes_seconds_nccl": {k: v["seconds"]
                                   for k, v in grouped.items()},
            "modes_seconds_alone": {k: v["seconds"]
                                    for k, v in alone.items()},
            "max_diff": diff, "launches": got,
            "max_abs_err": {k: v[0] for k, v in errs.items()},
            "train_step_ms": [(name, r[0]) for name, r in turns],
            "train_step_x_diff": x_diff,
            "lattice_sharding_step_ms": sharded[0],
            "lattice_sharding_x_diff": sharded_x_diff,
            "lattice_sharding_vs_plain": sharded_vs_plain,
            "slab_route": slab,
            "smc_log_z": [grouped["smc"]["log_z"],
                          grouped["smc"]["log_z_exact"]]}
    log(f"[parallel] one-rank NCCL group, the six modes, {PAR_STEPS} "
        f"quick-start train steps per turn, and the same under "
        f"lattice_sharding; the slab route timed at ({cfg.num_chains}, "
        f"{e}, {cfg.space_size}, 2) (device time per launch by "
        f"torch.profiler, inputs cycled): {json.dumps(line)}")
    log(f"[parallel] phase {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"parallel: failed gates {failed}")
    return line


# ---------------------------------------------------------------------------
# Phase 14: the head-to-head scripts and the analytic targets
# ---------------------------------------------------------------------------

# the README headline's commands at full width, cut in length
TVH_ARGV = ["--arch", "mlp", "--num_hidden", "64", "--num_steps", "3",
            "--merge_v", "--eps_init", "0.125", "--eps_fixed",
            "--charge_reward", "--params_from",
            "benchmarks/champion_16x16.npz", "--eval_chains", "2048",
            "--tier", "both", "--eval_steps", "300"]
SWEEP_GRID = {5: (0.08, 0.10)}         # HMC's optimum and one neighbour
SWEEP_ARGV = ["--record", "1000"]
H2H_ARGV = ["--seeds", "1", "--train_steps", "50", "--eval_steps", "500",
            "--eval_chains", "512"]
SAMPLER_ARGV = {
    "scg": ["@configs/scg_2d.txt", "--train_steps", "100",
            "--eval_steps", "300"],
    "mog": ["@configs/mog_2d.txt", "--train_steps", "100",
            "--eval_steps", "300"],
}
# the JSON keys the JAX scripts print (benchmarks/trained_vs_hmc.py
# :339-380 and :392-427, benchmarks/h2h_seeds.py :202-271,
# benchmarks/hmc_ess_sweep.py :84-104) and cli/train_sampler.py's
# summary.json (:190-217)
STATS_KEYS = {"ess_ratio", "tau_int", "tau_reliable_frac",
              "eff_samples_per_s", "steps_per_s"}
TVH_SAMPLER_KEYS = {"sampler", "accept_prob", "plaq", "charge",
                    "tunneling_rate_per_step", "plaq_mean", "q2", "wall_s"}
TVH_KEYS = {"benchmark", "label", "config", "plaq_exact", "q2_exact",
            "l2hmc", "hmc", "plaq_ess_per_s_ratio",
            "plaq_ess_per_step_ratio", "q_ess_per_s_ratio",
            "tunneling_per_s_ratio", "train_wall_s", "fused_tier"}
TVH_CONFIG_KEYS = {"size", "beta", "eval_chains", "eval_steps", "arch",
                   "num_filters", "num_hidden", "K", "merge_v",
                   "charge_reward", "charge_weight", "train_steps",
                   "eps_init", "eps_fixed", "metric", "hmc_K", "hmc_eps"}
TVH_FUSED_KEYS = {"l2hmc", "hmc", "plaq_ess_per_s_ratio",
                  "q_ess_per_s_ratio", "l2hmc_fused_vs_xla_speedup"}
SWEEP_ROW_KEYS = {"num_leapfrog", "eps", "accept", "ess_ratio",
                  "transitions_per_s", "ess_per_s"}
H2H_KEYS = {"benchmark", "config", "plaq_exact", "per_seed", "summary"}
H2H_CONFIG_KEYS = {"size", "beta", "seeds", "train_steps", "eval_steps",
                   "eval_chains", "trained", "hmc"}
H2H_SEED_KEYS = {"seed", "train_attempts", "trained", "hmc",
                 "ratio_ess_per_s", "ratio_ess_per_step",
                 "ratio_q_ess_per_s", "ratio_tunneling_per_s"}
H2H_SAMPLER_KEYS = {"accept", "plaq", "charge", "plaq_mean"}
H2H_SUMMARY_KEYS = {"ratio_ess_per_s", "ratio_ess_per_step",
                    "ratio_q_ess_per_s", "ratio_tunneling_per_s"}
SUMMARY_KEYS = {"l2hmc": {"ess_per_step", "accept", "mean", "std"},
                "hmc": {"ess_per_step", "accept"}}
METRICS_KEYS = {"step", "dt", "loss", "accept_prob", "eps", "temperature"}
# the accept-probability means of one sampler on the eager and the fused
# tier: standard errors from the 64 traced chains x T transitions, with
# p (1 - p) bounding the per-transition variance and a factor 3 for
# their autocorrelation (integrated times of a few transitions)
ACCEPT_TAU_FACTOR = 3.0
# the analytic targets' eval moments: within 5 standard errors of the
# exact ones (the mean's from the spread of the per-chain means, the
# standard deviation's by a jackknife over 20 blocks of chains).  For a
# mixture, the moments of the offset from the nearest mode (exact: 0 and
# each component's standard deviation): a cut training does not mix the
# modes (~5e-4 hops per transition), so which mode a chain holds follows
# its first transitions from x = 0 and the nets' asymmetry, not the
# target's weights
MOMENT_NSE = 5.0


def _json_lines(text):
    """The one-line JSON objects among ``text``'s lines."""
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and line.endswith("}")]


def run_main(main_fn, argv):
    """``main_fn(argv)`` with its stdout kept: ``(JSON lines, seconds)``."""
    import contextlib

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = main_fn(argv)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__}: exit code {rc}")
    return _json_lines(tee.text()), time.perf_counter() - t0


def key_gate(failed, what, got, want):
    if set(got) != set(want):
        failed.append(f"{what} keys {sorted(set(got) ^ set(want))} differ "
                      "from the JAX script's")


def accept_se(p, steps):
    return ACCEPT_TAU_FACTOR * np.sqrt(max(p * (1 - p), 1e-6)
                                       / (64 * steps))


def tvh_check(device, kernels, failed):
    """trained_vs_hmc on the champion, both tiers."""
    from l2hmc_tpu_torch.benchmarks import trained_vs_hmc

    (res,), secs = run_main(trained_vs_hmc.main,
                            TVH_ARGV + ["--device", str(device)])
    launches = phase_launches("h2h trained_vs_hmc", kernels,
                              ("l2hmc_chain", "hmc_chain", "wilson_force",
                               "wilson_action_only"))
    key_gate(failed, "trained_vs_hmc", res, TVH_KEYS)
    key_gate(failed, "trained_vs_hmc config", res["config"],
             TVH_CONFIG_KEYS)
    fused = res["fused_tier"]
    key_gate(failed, "trained_vs_hmc fused_tier", fused, TVH_FUSED_KEYS)
    steps = int(TVH_ARGV[TVH_ARGV.index("--eval_steps") + 1])
    exact = res["plaq_exact"]
    tiers = {"eager l2hmc": (res["l2hmc"], steps),
             "eager hmc": (res["hmc"], steps),
             "fused l2hmc": (fused["l2hmc"], 600),
             "fused hmc": (fused["hmc"], 1500)}
    for name, (r, _) in tiers.items():
        key_gate(failed, f"trained_vs_hmc {name}", r, TVH_SAMPLER_KEYS)
        for obs in ("plaq", "charge"):
            key_gate(failed, f"trained_vs_hmc {name} {obs}", r[obs],
                     STATS_KEYS)
        if not abs(r["plaq_mean"] - exact) < PLAQ_TOL:
            failed.append(f"trained_vs_hmc {name} plaquette "
                          f"{r['plaq_mean']} vs {exact}")
        if not r["accept_prob"] > MIN_ACCEPT:
            failed.append(f"trained_vs_hmc {name} acceptance "
                          f"{r['accept_prob']}")
    for s in ("l2hmc", "hmc"):
        (re_, te), (rf, tf) = tiers[f"eager {s}"], tiers[f"fused {s}"]
        pe, pf = re_["accept_prob"], rf["accept_prob"]
        se = np.hypot(accept_se(pe, te), accept_se(pf, tf))
        if not abs(pe - pf) <= ACCEPT_NSE * se:
            failed.append(f"trained_vs_hmc {s} acceptance eager {pe} vs "
                          f"fused {pf} (se {se:.2e})")
    # the champion (K=3) and HMC (K=5) on the eager harness: a warm and a
    # timed chunk of min(1000, eval_steps) transitions each; the fused tier
    # a warm and a timed call per sampler
    n_eager = 2 * min(1000, steps)
    want = {"l2hmc_chain": 2, "hmc_chain": 2}
    for k in ("wilson_forward", "wilson_action_only", "wilson_backward",
              "wilson_force", "wilson_double_backward"):
        want[k] = n_eager * (wilson_launches_per_transition(3)[k]
                             + wilson_launches_per_transition(5)[k])
    got = {k: launches[k] for k in want}
    if got != want:
        failed.append(f"trained_vs_hmc launches {got}, derived {want}")
    log(f"[h2h] trained_vs_hmc {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


def sweep_check(device, kernels, failed):
    """hmc_ess_sweep on (K=5, eps 0.08) and one neighbour."""
    from l2hmc_tpu_torch.benchmarks import hmc_ess_sweep

    full = hmc_ess_sweep.GRID
    hmc_ess_sweep.GRID = SWEEP_GRID
    try:
        rows, secs = run_main(hmc_ess_sweep.main,
                              SWEEP_ARGV + ["--device", str(device)])
    finally:
        hmc_ess_sweep.GRID = full
    launches = phase_launches("h2h hmc_ess_sweep", kernels, ("hmc_chain",))
    points = [(k, e) for k, eps in SWEEP_GRID.items() for e in eps]
    if [(r["num_leapfrog"], r["eps"]) for r in rows[:-1]] != points:
        failed.append(f"hmc_ess_sweep rows {rows[:-1]}")
    for r in rows[:-1]:
        key_gate(failed, "hmc_ess_sweep row", set(r) - {"frozen"},
                 SWEEP_ROW_KEYS)
        if not r["accept"] > MIN_ACCEPT:
            failed.append(f"hmc_ess_sweep acceptance {r}")
    key_gate(failed, "hmc_ess_sweep best", rows[-1], {"best"})
    # a thermalization call and a timed call per point
    if launches["hmc_chain"] != 2 * len(points):
        failed.append(f"hmc_ess_sweep hmc_chain launches "
                      f"{launches['hmc_chain']}, derived {2 * len(points)}")
    log(f"[h2h] hmc_ess_sweep {secs:.1f} s: {json.dumps(rows)}")
    return {"seconds": secs, "rows": rows,
            "launches": {"hmc_chain": launches["hmc_chain"]}}


def h2h_seeds_check(device, kernels, failed):
    """h2h_seeds: two trainings of the champion recipe, interleaved evals."""
    from l2hmc_tpu_torch.benchmarks import h2h_seeds

    (res,), secs = run_main(h2h_seeds.main,
                            H2H_ARGV + ["--device", str(device)])
    launches = phase_launches("h2h h2h_seeds", kernels,
                              ("wilson_force", "wilson_double_backward"))
    key_gate(failed, "h2h_seeds", res, H2H_KEYS)
    key_gate(failed, "h2h_seeds config", res["config"], H2H_CONFIG_KEYS)
    key_gate(failed, "h2h_seeds summary", res["summary"], H2H_SUMMARY_KEYS)
    for rec in res["per_seed"]:
        key_gate(failed, "h2h_seeds per_seed", rec, H2H_SEED_KEYS)
        for s in ("trained", "hmc"):
            key_gate(failed, f"h2h_seeds {s}", rec[s], H2H_SAMPLER_KEYS)
            if not abs(rec[s]["plaq_mean"] - res["plaq_exact"]) < PLAQ_TOL:
                failed.append(f"h2h_seeds seed {rec['seed']} {s} plaquette "
                              f"{rec[s]['plaq_mean']}")
            if not rec[s]["accept"] > MIN_ACCEPT:
                failed.append(f"h2h_seeds seed {rec['seed']} {s} "
                              f"acceptance {rec[s]['accept']}")
    seeds = int(H2H_ARGV[H2H_ARGV.index("--seeds") + 1])
    train = int(H2H_ARGV[H2H_ARGV.index("--train_steps") + 1])
    evals = 2 * int(H2H_ARGV[H2H_ARGV.index("--eval_steps") + 1])
    want = {k: seeds * (train * wilson_launches_per_step(3)[k]
                        + evals * (wilson_launches_per_transition(3)[k]
                                   + wilson_launches_per_transition(5)[k]))
            for k in wilson_launches_per_step(3)}
    got = {k: launches[k] for k in want}
    if got != want:
        failed.append(f"h2h_seeds launches {got}, derived {want}")
    log(f"[h2h] h2h_seeds {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


def exact_moments(target, xs):
    """``(samples, exact mean, exact standard deviation)`` per coordinate:
    a Gaussian's samples ``xs (T, chains, d)`` and its moments; a
    mixture's offsets from each sample's nearest mode and the components'
    moments (equal components: zero mean, the diagonal of sigma)."""
    if not hasattr(target, "mus"):
        return (xs, target.mu.double().cpu().numpy(),
                np.sqrt(np.diag(target.sigma.double().cpu().numpy())))
    mus = target.mus.double().cpu().numpy()
    sd = np.sqrt(np.diagonal(target.sigmas.double().cpu().numpy(),
                             axis1=1, axis2=2))
    if not np.allclose(sd, sd[0]):
        raise ValueError("moment gate: components of unequal widths")
    near = np.argmin(((xs[..., None, :] - mus) ** 2).sum(-1), axis=-1)
    return xs - mus[near], np.zeros(mus.shape[1]), sd[0]


def moment_errors(xs, mean, sd, blocks=20):
    """``(|mean error| / se, |sd error| / se)`` per coordinate of the
    samples ``xs (T, chains, d)`` past the first quarter: the mean's
    standard error from the spread of the per-chain means, the standard
    deviation's by a jackknife over blocks of chains."""
    kept = xs[xs.shape[0] // 4:].astype(np.float64)
    chains = kept.shape[1]
    chain_means = kept.mean(axis=0)
    se_mean = chain_means.std(axis=0, ddof=1) / np.sqrt(chains)
    groups = np.array_split(np.arange(chains), blocks)
    loo = np.array([np.delete(kept, g, axis=1).reshape(-1, kept.shape[2])
                    .std(axis=0) for g in groups])
    se_sd = np.sqrt((blocks - 1) / blocks
                    * ((loo - loo.mean(axis=0)) ** 2).sum(axis=0))
    got_sd = kept.reshape(-1, kept.shape[2]).std(axis=0)
    return (np.abs(kept.mean(axis=(0, 1)) - mean) / se_mean,
            np.abs(got_sd - sd) / se_sd)


def sampler_check(device, kernels, failed):
    """train_sampler on configs/scg_2d.txt and configs/mog_2d.txt, cut in
    length; the eval samples kept by wrapping the CLI's sample chain."""
    import tempfile
    from pathlib import Path

    from l2hmc_tpu_torch.cli import train_sampler
    from l2hmc_tpu_torch.train import sampler as S

    out = {}
    make = S.make_sample_chain
    for name, argv in SAMPLER_ARGV.items():
        kept = []

        def recording(cfg, energy_fn):
            sample = make(cfg, energy_fn)

            def run(*args, **kw):
                xs, probs = sample(*args, **kw)
                kept.append(xs)
                return xs, probs

            return run

        S.make_sample_chain = recording
        try:
            with tempfile.TemporaryDirectory() as td:
                _, secs = run_main(train_sampler.main, argv + [
                    "--log_dir", td, "--device", str(device)])
                run_dir = Path(td) / "run_1"
                summary = json.loads((run_dir / "summary.json").read_text())
                records = [json.loads(line) for line in
                           (run_dir / "metrics.jsonl").read_text()
                           .splitlines()]
        finally:
            S.make_sample_chain = make
        launches = phase_launches(f"targets {name}", kernels, ())
        if any(launches.values()):
            failed.append(f"targets {name}: launches {launches} (the "
                          "analytic path runs no kernel)")
        args = train_sampler.build_parser().parse_args(argv)
        target, modes = train_sampler.make_target(args, device)
        want_summary = {k: set(v) | ({"tunneling_rate"} if modes is not None
                                     else set())
                        for k, v in SUMMARY_KEYS.items()}
        key_gate(failed, f"targets {name} summary", summary, want_summary)
        for k, v in want_summary.items():
            key_gate(failed, f"targets {name} summary {k}", summary[k], v)
        for rec in records:
            want = METRICS_KEYS | ({"tunneling_rate"} if "tunneling_rate"
                                   in rec else set())
            key_gate(failed, f"targets {name} metrics.jsonl", rec, want)
        xs, mean, sd = exact_moments(target, kept[-1].cpu().numpy())
        err_mean, err_sd = moment_errors(xs, mean, sd)
        if not (np.all(err_mean <= MOMENT_NSE)
                and np.all(err_sd <= MOMENT_NSE)):
            failed.append(f"targets {name}: eval moments off by "
                          f"{err_mean.tolist()} / {err_sd.tolist()} "
                          "standard errors")
        if not summary["l2hmc"]["accept"] > MIN_ACCEPT:
            failed.append(f"targets {name} acceptance "
                          f"{summary['l2hmc']['accept']}")
        ms = [r["dt"] * 1e3 for r in records]
        out[name] = {"seconds": secs, "ms_per_train_step": ms,
                     "summary": summary,
                     "moment_errors_in_se": [err_mean.tolist(),
                                             err_sd.tolist()],
                     "exact": [mean.tolist(), sd.tolist()]}
        log(f"[targets] {name} {secs:.1f} s: {json.dumps(out[name])}")
    return out


CHILD_TAG = "[child] result "


def start_child(call, device):
    """Run ``chip_smoke.<call>(device)`` in a child process that imports
    chip_smoke afresh, its output in a temporary file: ``(process, file,
    call)``."""
    import os
    import tempfile

    code = ("import json, sys, torch, chip_smoke as C\n"
            f"out = C.{call}(torch.device(sys.argv[1]))\n"
            f"print({CHILD_TAG!r} + json.dumps(out), flush=True)\n")
    here = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code, str(device)],
                            cwd=here, stdout=out, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, call


def join_child(child, timeout=900):
    """Wait for a child of :func:`start_child`, print its log and return
    its result; a child that failed raises."""
    proc, out, call = child
    rc = proc.wait(timeout=timeout)
    out.seek(0)
    text = out.read()
    out.close()
    print(text, end="", flush=True)
    lines = [ln for ln in text.splitlines() if ln.startswith(CHILD_TAG)]
    if rc != 0 or not lines:
        raise AssertionError(f"{call} child: exit code {rc}, no result")
    return json.loads(lines[-1][len(CHILD_TAG):])


def stop_child(child):
    if child[0].poll() is None:
        child[0].kill()
        child[0].wait()


def targets_child(device):
    """Phase 14's analytic-target runs (``sampler_check``), run in a child
    process (:func:`start_child`) from the end of phase 9 on."""
    failed = []
    out = sampler_check(device, reset_launches(), failed)
    return {"out": out, "failed": failed}


def join_targets(targets, failed, timeout=900):
    """The target runs' result (their failed gates added to ``failed``)."""
    res = join_child(targets, timeout)
    failed += res["failed"]
    return res["out"]


def h2h_phase(device, targets):
    """Phase 14: the head-to-head scripts and the analytic-target workload,
    each entry point's ``main`` at full width, cut in length, launches
    counted from 0 per script; the target runs' child (``targets``,
    :func:`targets_child`) joined at the end."""
    kernels = reset_launches()
    t0 = time.perf_counter()
    failed, out = [], {}
    for name, check in (("trained_vs_hmc", tvh_check),
                        ("hmc_ess_sweep", sweep_check),
                        ("h2h_seeds", h2h_seeds_check)):
        out[name] = check(device, kernels, failed)
    out["targets"] = join_targets(targets, failed)
    log(f"[h2h] phase {time.perf_counter() - t0:.1f} s (the target runs "
        "beside phases 10-13)")
    if failed:
        raise AssertionError(f"h2h and targets: failed gates {failed}")
    return out


# Phase 15: the VAE workload and the SU(N) family (no kernel on this path)
VAE_ARGV = ["@configs/vae_digits.txt"]      # as written
VAE_ELBO_GAIN = 5.0           # nats, the final ELBO over the first logged
VAE_ORACLE_TOL = 0.25         # AIS against the exact linear-Gaussian p(x)
VAE_SUMMARY_KEYS = {"ais_log_likelihood_mean", "ais_log_likelihood_sem",
                    "sampler_ess_per_step", "sampler_accept_prob",
                    "final_elbo"}
VAE_METRICS_KEYS = {"step", "epoch", "dt", "elbo", "sampler_loss",
                    "decoder_nll", "accept_prob", "loss"}
# the JAX CLI's AIS log p(x) for VAE_ARGV at seeds 42, 43 and 44 (its
# summary.json, CPU); the gate is their range widened by VAE_AIS_NSE of the
# port run's own standard error
VAE_JAX_AIS = (-20.895936965942383, -20.80035400390625, -20.535968780517578)
VAE_AIS_NSE = 5.0
# 2-D SU(N) at train_sun's defaults (8x8, 32 chains, K=3, hidden 32, eps
# 0.15, 1000 eval transitions, the first quarter dropped), training cut
# from 1000 steps to 200
SUN_RUNS = {
    "su2_b2_hmc": ["--n", "2", "--beta", "2.0", "--hmc"],
    "su3_b4_hmc": ["--n", "3", "--beta", "4.0", "--hmc"],
    "su2_b2_trained": ["--n", "2", "--beta", "2.0", "--train_steps", "200"],
}
SUN_EXACT = {"su2_b2_hmc": 0.43313, "su3_b4_hmc": 0.27930,
             "su2_b2_trained": 0.43313}
SUN_PLAQ_NSE, SUN_PLAQ_TOL = 5.0, 0.02
SUN_EVAL_KEYS = {"n", "beta", "plaq", "plaq_exact", "plaq_err",
                 "accept_prob", "esjd_plaq_trace", "mode"}
# 4-D SU(2) at beta 0.5 (tests/test_sun_nd.py:61-77: 200 transitions, K=4,
# eps 0.25, the first 80 dropped) with train_sun's 32 chains
SUN_4D_ARGV = ["--dims", "3", "3", "3", "3", "--n", "2", "--beta", "0.5",
               "--run_steps", "200", "--num_steps", "4", "--eps", "0.25",
               "--therm_frac", "0.4"]
SUN_4D_TOL, SUN_4D_MIN_ACCEPT = 0.012, 0.6
SUN_4D_KEYS = {"n", "beta", "dims", "rect_c1", "plaq",
               "plaq_strong_coupling_lo", "accept_prob", "mode"}
# SU(3) 8^4, batch 8, K=4, eps 0.32/L; a warm and 2 timed chunks of 50
SUN_BENCH_ARGV = ["--chunks", "2"]
SUN_BENCH_KEYS = {"metric", "value", "config", "plaq",
                  "plaq_strong_coupling_lo", "accept_prob",
                  "ms_per_transition", "compile_s", "platform"}


def ais_oracle(device):
    """``ais_log_likelihood`` on a linear-Gaussian decoder, p(x|z) = N(x; W
    z, sigma^2 I), z ~ N(0, I) (``tests/test_vae.py:75-120``): ``(AIS mean,
    exact mean)`` of log p(x) over 64 points, 300 rungs."""
    from l2hmc_tpu_torch.train.vae import VAEConfig, ais_log_likelihood

    d_lat, d_obs, sigma = 2, 3, 0.8
    rng = np.random.default_rng(0)
    w = rng.normal(size=(d_lat, d_obs)).astype(np.float32)
    x = (rng.normal(size=(64, d_obs)) * 1.5).astype(np.float32)

    def posterior_energy(dec, x_batch):
        def energy(z):
            resid = x_batch - z @ dec
            loglik = (-0.5 * torch.sum(resid * resid, dim=-1) / sigma ** 2
                      - 0.5 * d_obs * np.log(2 * np.pi * sigma ** 2))
            return -loglik + 0.5 * torch.sum(z * z, dim=-1)
        return energy

    class Params:
        decoder = torch.tensor(w, device=device)

    logw = ais_log_likelihood(
        VAEConfig(data_dim=d_obs, latent_dim=d_lat),
        {"posterior_energy": posterior_energy}, Params,
        torch.tensor(x, device=device),
        torch.Generator(device=device).manual_seed(0), num_betas=300,
        eps=0.25).cpu().numpy()
    cov = w.T @ w + sigma ** 2 * np.eye(d_obs)
    _, logdet = np.linalg.slogdet(cov)
    exact = (-0.5 * np.einsum("bi,ij,bj->b", x, np.linalg.inv(cov), x)
             - 0.5 * logdet - 0.5 * d_obs * np.log(2 * np.pi))
    return float(logw.mean()), float(exact.mean())


def vae_check(device, kernels, failed):
    """train_vae on configs/vae_digits.txt as written, and the AIS oracle."""
    import tempfile
    from pathlib import Path

    from l2hmc_tpu_torch.cli import train_vae

    with tempfile.TemporaryDirectory() as td:
        _, secs = run_main(train_vae.main, VAE_ARGV + [
            "--log_dir", td, "--device", str(device)])
        run_dir = Path(td) / "run_1"
        summary = json.loads((run_dir / "summary.json").read_text())
        records = [json.loads(line) for line in
                   (run_dir / "metrics.jsonl").read_text().splitlines()]
    launches = phase_launches("vae train_vae", kernels, ())
    if any(launches.values()):
        failed.append(f"vae: launches {launches} (the path runs no kernel)")
    key_gate(failed, "vae summary.json", summary, VAE_SUMMARY_KEYS)
    for rec in records:
        key_gate(failed, "vae metrics.jsonl", rec, VAE_METRICS_KEYS)
    gain = records[-1]["elbo"] - records[0]["elbo"]
    if not gain > VAE_ELBO_GAIN:
        failed.append(f"vae: ELBO {records[0]['elbo']} -> "
                      f"{records[-1]['elbo']} (gain {gain})")
    if not all(np.isfinite(v) for v in summary.values()):
        failed.append(f"vae: non-finite summary {summary}")
    if not 0.05 < summary["sampler_accept_prob"] <= 1.0:
        failed.append(f"vae: acceptance {summary['sampler_accept_prob']}")
    sem = summary["ais_log_likelihood_sem"]
    band = (min(VAE_JAX_AIS) - VAE_AIS_NSE * sem,
            max(VAE_JAX_AIS) + VAE_AIS_NSE * sem)
    ll = summary["ais_log_likelihood_mean"]
    if not band[0] <= ll <= band[1]:
        failed.append(f"vae: AIS log p(x) {ll} outside {band}")
    t0 = time.perf_counter()
    got, exact = ais_oracle(device)
    oracle_s = time.perf_counter() - t0
    if not abs(got - exact) < VAE_ORACLE_TOL:
        failed.append(f"vae: AIS oracle {got} vs exact {exact}")
    launches = phase_launches("vae AIS oracle", kernels, ())
    if any(launches.values()):
        failed.append(f"vae oracle: launches {launches}")
    ms = [r["dt"] * 1e3 for r in records]
    out = {"seconds": secs, "ms_per_train_step": ms,
           "steps": records[-1]["step"], "elbo": [records[0]["elbo"],
                                                  records[-1]["elbo"]],
           "summary": summary, "ais_band": band,
           "oracle": {"ais": got, "exact": exact, "seconds": oracle_s}}
    log(f"[vae] {secs:.1f} s: {json.dumps(out)}")
    return out


MS_RE = r"\(([0-9.]+) ms/transition\)"


def sun_cli(argv, device):
    """``train_sun.main`` in a temporary log dir: ``(eval.json, metrics
    records, the eval plaquette trace or None, ms per eval transition,
    seconds)``."""
    import contextlib
    import re
    import tempfile
    from pathlib import Path

    from l2hmc_tpu_torch.cli import train_sun

    tee = _Tee(sys.stdout)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = train_sun.main(argv + ["--log_dir", td,
                                        "--device", str(device)])
        secs = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"train_sun {argv}: exit code {rc}")
        run_dir = Path(td) / "run_1"
        ev = json.loads((run_dir / "eval.json").read_text())
        metrics = run_dir / "metrics.jsonl"
        records = ([json.loads(line) for line in
                    metrics.read_text().splitlines()]
                   if metrics.exists() else [])
        trace = run_dir / "eval_plaq.npy"
        trace = np.load(trace) if trace.exists() else None
    ms = float(re.findall(MS_RE, tee.text())[-1])
    return ev, records, trace, ms, secs


def chain_mean_err(trace, therm_frac=0.25):
    """The plaquette's mean and its jackknife error over chains (each
    chain's mean after the thermalization cut; chains are independent)."""
    from l2hmc_tpu_torch.analysis import stats

    kept = trace[int(therm_frac * trace.shape[0]):]
    means = kept.mean(axis=0)
    return stats.jackknife(means, num_blocks=len(means))


def sun_check(device, kernels, failed):
    """train_sun: 2-D SU(2)/SU(3) HMC and trained SU(2) against the Weyl
    quadrature; 4-D SU(2) against strong coupling; sun_nd_bench."""
    from l2hmc_tpu_torch.benchmarks import sun_nd_bench

    out = {}
    for name, argv in SUN_RUNS.items():
        ev, records, trace, ms, secs = sun_cli(argv, device)
        key_gate(failed, f"sun {name} eval.json", ev, SUN_EVAL_KEYS)
        mean, err = chain_mean_err(trace)
        exact = SUN_EXACT[name]
        if round(ev["plaq_exact"], 5) != exact:
            failed.append(f"sun {name}: plaq_exact {ev['plaq_exact']}")
        dev = abs(mean - ev["plaq_exact"])
        if not (dev < SUN_PLAQ_NSE * err and dev < SUN_PLAQ_TOL):
            failed.append(f"sun {name}: plaquette {mean} +- {err} vs "
                          f"{ev['plaq_exact']}")
        if not ev["accept_prob"] > MIN_ACCEPT:
            failed.append(f"sun {name}: acceptance {ev['accept_prob']}")
        train_ms = (1e3 * records[-1]["wall_s"] / records[-1]["step"]
                    if records else None)
        out[name] = {"seconds": secs, "eval": ev, "plaq_jk": [mean, err],
                     "ms_per_eval_transition": ms,
                     "ms_per_train_step": train_ms}
        log(f"[sun] {name} {secs:.1f} s: {json.dumps(out[name])}")
    ev, _, _, ms, secs = sun_cli(SUN_4D_ARGV, device)
    key_gate(failed, "sun 4-D eval.json", ev, SUN_4D_KEYS)
    if not (abs(ev["plaq"] - ev["plaq_strong_coupling_lo"]) < SUN_4D_TOL
            and ev["accept_prob"] > SUN_4D_MIN_ACCEPT):
        failed.append(f"sun 4-D: plaq {ev['plaq']} vs "
                      f"{ev['plaq_strong_coupling_lo']}, acceptance "
                      f"{ev['accept_prob']}")
    out["su2_4d_b05"] = {"seconds": secs, "eval": ev,
                         "ms_per_eval_transition": ms}
    log(f"[sun] su2_4d_b05 {secs:.1f} s: {json.dumps(out['su2_4d_b05'])}")
    t0 = time.perf_counter()
    res = sun_nd_bench.main(SUN_BENCH_ARGV + ["--device", str(device)])
    secs = time.perf_counter() - t0
    key_gate(failed, "sun_nd_bench", res, SUN_BENCH_KEYS)
    if not (np.isfinite(res["plaq"]) and res["accept_prob"] > MIN_ACCEPT):
        failed.append(f"sun_nd_bench: {res}")
    out["sun_nd_bench"] = {"seconds": secs, "result": res}
    launches = phase_launches("sun", kernels, ())
    if any(launches.values()):
        failed.append(f"sun: launches {launches} (the path runs no kernel)")
    return out


def vae_sun_phase(device):
    """Phase 15: the VAE workload and the SU(N) family through their
    entry points at full width, counts of every kernel set to 0 before
    each and read after (the path runs none).  Host-bound eager torch
    (~160 s alone), so ``main`` runs it in a child process
    (:func:`start_child`) from the end of phase 9 on, beside phases
    10-14."""
    kernels = reset_launches()
    t0 = time.perf_counter()
    failed = []
    out = {"vae": vae_check(device, kernels, failed),
           "sun": sun_check(device, kernels, failed)}
    out["seconds"] = time.perf_counter() - t0
    log(f"[vae-sun] phase {out['seconds']:.1f} s")
    if failed:
        raise AssertionError(f"vae and sun: failed gates {failed}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the topological and volume drivers
# ---------------------------------------------------------------------------

# Each driver's main at the widths of its defaults (lattice, chains, nets,
# rungs), cut in length only.  The fused drivers run in the main process:
FHOP_ARGV = ["--champion", "--calls", "1"]
L64H_ARGV = ["--seeds", "1", "--train_steps", "2", "--eval_steps", "500",
             "--no_xla_tier"]
SCALING_ARGV = ["--repeats", "2", "--chunk", "20"]
# the host-bound ones in a child process (drivers_child), beside phases
# 10-15
TOPO_ARGV = ["--reps", "1", "--eval_steps", "400", "--chunk_size", "200"]
CM_ARGV = ["--train_steps", "50", "--eval_steps", "100"]
PTH_ARGV = ["--reps", "1", "--eval_steps", "400", "--chunk_size", "200"]
FREEZE_ARGV = ["--points", "16:5.0", "--reps", "1", "--eval_steps", "1000"]
BETA_ARGV = ["--seeds", "1", "--train_steps", "100", "--eval_steps", "200",
             "--probe_train_steps", "250", "--probe_seeds", "1",
             "--hmc_k_grid", "4,5", "--l2hmc_k_grid", "3"]
BETA_TRAIN_CHUNK = 50          # tune_l2hmc's probe trainings (250 in JAX)
LCS_ARGV = ["--steps", "3"]
VOL_ARGV = ["--chunk", "5"]
PLAQ_NSE = 5.0
L64H_ACCEPT_N = 200            # transitions of the kernel-vs-plain acceptance
# the JSON keys of the JAX scripts (benchmarks/<name>.py), from their
# sources: topo_ensemble :242-304, fused_hop :95-169, charge_mixing
# :67-170, pt_vs_hop :205-270, freeze_line :125-150, beta_campaign
# :178-195, local64_h2h :209-262, local_cost_sweep :114-135,
# volume_sweep :78-109, scaling :80-85 and :163-175
TOPO_KEYS = {"benchmark", "config", "plaq_exact", "q2_exact", "per_rep",
             "summary"}
TOPO_CONFIG_KEYS = {"size", "beta", "reps", "eval_steps", "eval_chains",
                    "hmc", "n_hops", "nu_max"}
TOPO_REC_KEYS = {"plaq", "charge", "steps_per_s", "tunneling_per_s",
                 "tunneling_per_step", "accept", "plaq_mean", "q2_mean",
                 "ratio_plaq_ess_per_s", "ratio_q_ess_per_s",
                 "ratio_q_ess_per_s_pooled", "ratio_tunneling_per_s"}
TOPO_CHARGE_KEYS = STATS_KEYS | {"tau_pooled", "tau_pooled_reliable",
                                 "eff_samples_per_s_pooled"}
TOPO_SUMMARY_KEYS = {"ratio_plaq_ess_per_s", "ratio_q_ess_per_s",
                     "ratio_q_ess_per_s_pooled", "ratio_tunneling_per_s",
                     "q2_mean", "q2_err", "plaq_mean"}
FHOP_RES_KEYS = {"lf_steps_per_s", "us_per_transition", "tunneling_per_step",
                 "tunneling_per_s", "q_tau_pooled", "q_tau_reliable",
                 "q_ess_per_s_pooled", "plaq_mean", "q2_mean"}
FHOP_KEYS = ({"benchmark", "config", "plaq_exact", "q2_exact",
              "hop_cost_pct", "tunneling_ratio", "q_ess_ratio_pooled",
              "champ_hop_tunneling_vs_hmc", "champ_hop_q_ess_vs_hmc_pooled",
              "champ_hop_cost_pct"}
             | {f"{k}_{t}" for k in FHOP_RES_KEYS
                for t in ("plain", "hop", "champ", "champ_hop")})
FHOP_CONFIG_KEYS = {"size", "beta", "chains", "hmc", "transitions"}
CM_KEYS = {"benchmark", "config", "q2_exact", "l2hmc", "hmc",
           "tunneling_speedup_per_step", "Q_ess_per_s_speedup"}
CM_SAMPLER_KEYS = {"sampler", "tunneling_rate_per_step", "tau_int_Q",
                   "tau_int_reliable_frac", "Q_ess_ratio", "Q_ess_per_s",
                   "steps_per_s", "susceptibility", "accept_prob"}
PTH_CONFIG_KEYS = {"size", "beta", "reps", "ladder", "hmc", "eval_steps"}
PTH_LADDER_KEYS = {"betas", "eps", "K", "chains_per_rung"}
PTH_REC_KEYS = {"plaq", "plaq_mean", "q2_mean", "q_tau_pooled",
                "q_tau_pooled_reliable", "q_ess_per_s_pooled",
                "tunneling_per_s_per_chain", "tunneling_per_step",
                "usable_chains", "ratio_q_ess_per_s_pooled",
                "ratio_plaq_ess_per_s"}
PTH_SUMMARY_KEYS = {"ratio_q_ess_per_s_pooled", "ratio_plaq_ess_per_s",
                    "q_tau_pooled", "q2_mean"}
FREEZE_KEYS = {"benchmark", "protocol", "rows"}
FREEZE_ROW_KEYS = {"size", "beta", "hmc", "hop_accept",
                   "ratio_tunneling_per_s", "ratio_q_ess_per_s_pooled",
                   "ratio_plaq_ess_per_s", "hmc_tunneling_per_step",
                   "hop_tunneling_per_step", "q2_hop", "q2_hmc", "q2_exact",
                   "detail"}
BETA_KEYS = {"benchmark", "size", "beta", "arch", "train_hops",
             "retrain_acc", "lr_init", "hmc_opt", "trained_cell",
             "h2h_summary", "h2h_per_seed", "plaq_exact"}
BETA_CELL_KEYS = {"K", "eps", "accept", "accept_train_end", "score",
                  "seed_scores"}
L64H_KEYS = {"benchmark", "config", "plaq_exact", "per_seed", "summary"}
L64H_CONFIG_KEYS = {"size", "beta", "seeds", "trained", "hmc",
                    "train_steps", "eval_steps", "eval_chains"}
L64H_SEED_KEYS = {"seed", "end_accept", "eps", "train_s", "trained_fused",
                  "hmc_fused", "vs_fused"}
L64H_SAMPLER_KEYS = {"plaq", "plaq_mean", "accept", "q_tau_pooled",
                     "q_tau_pooled_reliable", "q_ess_per_s_pooled",
                     "tunneling_per_s", "us_per_transition"}
L64H_TIER_KEYS = {"ratio_plaq_ess_per_s", "ratio_ess_per_step",
                  "ratio_q_ess_per_s_pooled"}
LCS_KEYS = {"benchmark", "config", "variants", "note"}
LCS_TAGS = {"hmc_K8", "mlp_h64", "local_c8_L2_k3", "local_c8_L1_k3",
            "local_c4_L1_k3", "local_c8_L1_k5", "local_c16_L1_k3",
            "localflat_c8_L2", "localflat_c8_L1"}
LCS_ROW_KEYS = {"steps_per_s", "us_per_transition", "thr_vs_hmc"}
VOL_KEYS = {"metric", "exponent_b", "coeff_a_ms", "rows", "platform"}
VOL_ROW_KEYS = {"l", "x_dim", "ms_per_transition", "accept"}
SCALING_TOPO_KEYS = {"psum_topology_ok", "devices_checked", "processes"}
SCALING_RATE_KEYS = {"devices", "chains", "processes", "transitions_per_s"}


def flag(argv, name, parser):
    """The value of ``--name`` that ``parser`` parses from ``argv``."""
    return getattr(parser.parse_args(argv), name)


def plaq_gate(failed, what, plaq, beta, side, ess_ratio=None, samples=0):
    """``plaq`` within PLAQ_TOL of I1/I0(beta), or within PLAQ_NSE of the
    run's own standard errors where that error is larger: the
    one-plaquette variance 1 - p/beta - p^2 (p = I1/I0) over the side^2
    plaquettes of a config, over ``ess_ratio x samples`` effective
    samples."""
    from l2hmc_tpu_torch.lattice.u1 import u1_plaq_exact

    p = u1_plaq_exact(beta)
    se = 0.0
    if ess_ratio is not None:
        var = (1.0 - p / beta - p * p) / (side * side)
        se = float(np.sqrt(var / max(ess_ratio * samples, 1.0)))
    tol = max(PLAQ_TOL, PLAQ_NSE * se)
    if not abs(plaq - p) < tol:
        failed.append(f"{what} plaquette {plaq} against {p:.6f} (tolerance "
                      f"{tol:.2e})")


def q2_gate(failed, what, q2, q2_exact):
    if not abs(q2 - q2_exact) <= Q2_RTOL * q2_exact:
        failed.append(f"{what} <Q^2> {q2} not within {Q2_RTOL:.0%} of "
                      f"{q2_exact}")


def accept_gate(failed, what, acc):
    if not acc > MIN_ACCEPT:
        failed.append(f"{what} acceptance {acc}")


def launch_gate(failed, what, launches, want):
    got = {k: launches[k] for k in want}
    if got != want:
        failed.append(f"{what} launches {got}, derived {want}")
    return got


def wilson_launches(transitions, steps=()):
    """Wilson launches of eager transitions ``[(n, K)]`` and train steps
    ``[(n, K)]`` (``wilson_launches_per_transition``,
    ``wilson_launches_per_step``)."""
    out = dict.fromkeys(wilson_launches_per_transition(1), 0)
    for n, k in transitions:
        for name, v in wilson_launches_per_transition(k).items():
            out[name] += n * v
    for n, k in steps:
        for name, v in wilson_launches_per_step(k).items():
            out[name] += n * v
    return out


def chunked(steps, chunk):
    """Transitions of a warm chunk and ``steps // chunk`` timed ones."""
    return chunk + (steps // chunk) * chunk


def fused_hop_check(device, kernels, failed):
    """fused_hop --champion: HMC (#2) and the champion (#3), plain and with
    the fused hop, at 16x16, 2048 chains."""
    from l2hmc_tpu_torch.benchmarks import fused_hop

    p = fused_hop.build_parser()
    (res,), secs = run_main(fused_hop.main,
                            FHOP_ARGV + ["--device", str(device)])
    launches = phase_launches("drivers fused_hop", kernels,
                              ("hmc_chain", "l2hmc_chain"))
    key_gate(failed, "fused_hop", res, FHOP_KEYS)
    key_gate(failed, "fused_hop config", res["config"], FHOP_CONFIG_KEYS)
    beta, side = flag(FHOP_ARGV, "beta", p), flag(FHOP_ARGV, "size", p)
    for tag in ("plain", "hop", "champ", "champ_hop"):
        plaq_gate(failed, f"fused_hop {tag}", res[f"plaq_mean_{tag}"], beta,
                  side)
    for tag in ("hop", "champ_hop"):
        q2_gate(failed, f"fused_hop {tag}", res[f"q2_mean_{tag}"],
                res["q2_exact"])
    for hop, plain in (("hop", "plain"), ("champ_hop", "champ")):
        a, b = (res[f"tunneling_per_step_{hop}"],
                res[f"tunneling_per_step_{plain}"])
        if not a >= Q_HOP_RATIO * b:
            failed.append(f"fused_hop {hop} tunneling/step {a} under "
                          f"{Q_HOP_RATIO}x {plain}'s {b}")
    nt, calls = flag(FHOP_ARGV, "nt", p), flag(FHOP_ARGV, "calls", p)
    calls_c = fused_hop.champion_calls(nt, calls)[1]
    # a warm and `calls` timed calls per variant
    got = launch_gate(failed, "fused_hop", launches, {
        "hmc_chain": 2 * (1 + calls), "l2hmc_chain": 2 * (1 + calls_c),
        **wilson_launches([])})
    log(f"[drivers] fused_hop {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


def local64_h2h_check(device, kernels, failed):
    """local64_h2h --seeds 1, the fused tiers: a local_flat c4L1 training
    (eager, the Wilson kernels), then the stencil chain (#4) against HMC
    (#2) at 64x64, 512 chains.  The cut training leaves the sampler near
    its init, which accepts ~0.002 (250 steps take it to 0.54, too long
    for the time limit), so its acceptance is held to its plain version's
    on the same warm-start links (phase 5's rule), over L64H_ACCEPT_N
    transitions: enough that the band of 5 standard errors stays well
    clear of 0."""
    from l2hmc_tpu_torch.benchmarks import local64_h2h
    from l2hmc_tpu_torch.lattice import metropolis
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (
        draw_l2hmc_randomness, l2hmc_chain_reference, l2hmc_local_chain)
    from l2hmc_tpu_torch.train import gauge

    p = local64_h2h.build_parser()
    seen = {}
    train, therm = gauge.train_to_convergence, metropolis.thermalize

    def recording_train(*a, **k):
        out = train(*a, **k)
        seen["params"] = out[0].params
        return out

    def recording_therm(*a, **k):
        out = therm(*a, **k)
        seen["x0"] = out
        return out

    gauge.train_to_convergence = recording_train
    metropolis.thermalize = recording_therm
    try:
        (res,), secs = run_main(local64_h2h.main,
                                L64H_ARGV + ["--device", str(device)])
    finally:
        gauge.train_to_convergence, metropolis.thermalize = train, therm
    launches = phase_launches("drivers local64_h2h", kernels,
                              ("l2hmc_local_chain", "hmc_chain",
                               "wilson_force"))
    key_gate(failed, "local64_h2h", res, L64H_KEYS)
    key_gate(failed, "local64_h2h config", res["config"], L64H_CONFIG_KEYS)
    key_gate(failed, "local64_h2h summary", res["summary"], {"vs_fused"})
    key_gate(failed, "local64_h2h summary vs_fused",
             res["summary"]["vs_fused"], L64H_TIER_KEYS)
    beta, side = flag(L64H_ARGV, "beta", p), flag(L64H_ARGV, "size", p)
    chunk, steps = flag(L64H_ARGV, "chunk", p), flag(L64H_ARGV, "eval_steps",
                                                      p)
    n_rounds = steps // chunk
    n_tr = flag(L64H_ARGV, "trace_chains", p)
    for rec in res["per_seed"]:
        key_gate(failed, "local64_h2h per_seed", rec, L64H_SEED_KEYS)
        key_gate(failed, "local64_h2h vs_fused", rec["vs_fused"],
                 L64H_TIER_KEYS)
        for s in ("trained_fused", "hmc_fused"):
            key_gate(failed, f"local64_h2h {s}", rec[s], L64H_SAMPLER_KEYS)
            key_gate(failed, f"local64_h2h {s} plaq", rec[s]["plaq"],
                     STATS_KEYS)
            plaq_gate(failed, f"local64_h2h {s}", rec[s]["plaq_mean"], beta,
                      side, rec[s]["plaq"]["ess_ratio"],
                      n_rounds * chunk * n_tr)
        accept_gate(failed, "local64_h2h hmc_fused",
                    rec["hmc_fused"]["accept"])
    seeds = flag(L64H_ARGV, "seeds", p)
    k = flag(L64H_ARGV, "k", p)
    train_steps = flag(L64H_ARGV, "train_steps", p)
    got = launch_gate(failed, "local64_h2h", launches, {
        "l2hmc_local_chain": seeds * (1 + n_rounds),
        "hmc_chain": seeds * (1 + n_rounds),
        **wilson_launches([], [(seeds * train_steps, k)])})
    # the trained sampler's acceptance, kernel against plain, on the
    # Metropolis warm-start links (launches not counted: read above)
    from l2hmc_tpu_torch.lattice import u1

    params, layers = seen["params"], flag(L64H_ARGV, "layers", p)
    eps = res["per_seed"][-1]["eps"]
    links = u1.to_links(seen["x0"], u1.LatticeShape(side, side)).contiguous()
    gen = torch.Generator(device=device).manual_seed(16064)
    n, b, d = L64H_ACCEPT_N, links.shape[0], side * side
    with torch.no_grad():
        out_k = l2hmc_local_chain(links, params, gen, eps, beta, k, n, layers)
        r = draw_l2hmc_randomness(gen, n, b, d, False, device)
        out_p = l2hmc_chain_reference(links, params, *r[:4], eps, beta, k,
                                      local_layers=layers)
    acc_k, acc_p = accept_stats(out_k[3]), accept_stats(out_p[3])
    try:
        accept_vs_plain("drivers local64_h2h", {"trained_fused": {
            "accept": acc_k[0], "accept_se": acc_k[1]}},
            {"trained_fused": acc_p}, ("trained_fused",))
    except AssertionError as e:
        failed.append(str(e))
    log(f"[drivers] local64_h2h {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res,
            "accept_kernel_plain": [acc_k, acc_p]}


def scaling_check(device, kernels, failed):
    """scaling on a one-rank NCCL group (file:// rendezvous): the topology
    checks and the rate line."""
    import tempfile

    import torch.distributed as dist

    from l2hmc_tpu_torch.benchmarks import scaling

    p = scaling.build_parser()
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo",
            init_method=f"file://{td}/rdv", rank=0, world_size=1)
        try:
            lines, secs = run_main(scaling.main,
                                   SCALING_ARGV + ["--device", str(device)])
        finally:
            dist.destroy_process_group()
    launches = phase_launches("drivers scaling", kernels, ("wilson_force",))
    topo, rate = lines
    key_gate(failed, "scaling topology", topo, SCALING_TOPO_KEYS)
    key_gate(failed, "scaling rate", rate, SCALING_RATE_KEYS)
    if topo != {"psum_topology_ok": True, "devices_checked": 1,
                "processes": 1}:
        failed.append(f"scaling topology checks {topo}")
    if not (np.isfinite(rate["transitions_per_s"])
            and rate["transitions_per_s"] > 0):
        failed.append(f"scaling rate {rate}")
    runs = 1 + flag(SCALING_ARGV, "repeats", p)
    got = launch_gate(failed, "scaling", launches, wilson_launches(
        [(runs * flag(SCALING_ARGV, "chunk", p),
          flag(SCALING_ARGV, "num_steps", p))]))
    log(f"[drivers] scaling {secs:.1f} s: {json.dumps(lines)}")
    return {"seconds": secs, "launches": got, "result": lines}


def topo_ensemble_check(device, kernels, failed):
    """topo_ensemble: HMC, HMC+hop and the champion+hop on the eager
    harness at 16x16, 2048 chains, beta 4."""
    from l2hmc_tpu_torch.benchmarks import topo_ensemble

    p = topo_ensemble.build_parser()
    (res,), secs = run_main(topo_ensemble.main,
                            TOPO_ARGV + ["--device", str(device)])
    launches = phase_launches("drivers topo_ensemble", kernels,
                              ("wilson_force", "wilson_action_only"))
    key_gate(failed, "topo_ensemble", res, TOPO_KEYS)
    key_gate(failed, "topo_ensemble config", res["config"], TOPO_CONFIG_KEYS)
    beta, side = flag(TOPO_ARGV, "beta", p), flag(TOPO_ARGV, "size", p)
    steps, chunk = (flag(TOPO_ARGV, "eval_steps", p),
                    flag(TOPO_ARGV, "chunk_size", p))
    n_tr = flag(TOPO_ARGV, "trace_chains", p)
    tags = ("hmc", "hmc+hop", "champ+hop")
    key_gate(failed, "topo_ensemble summary", res["summary"], tags)
    for tag in tags:
        key_gate(failed, f"topo_ensemble summary {tag}", res["summary"][tag],
                 TOPO_SUMMARY_KEYS)
        for rep in res["per_rep"]:
            r = rep[tag]
            key_gate(failed, f"topo_ensemble {tag}", r, TOPO_REC_KEYS | (
                {"hop_accept"} if "hop" in tag else set()))
            key_gate(failed, f"topo_ensemble {tag} plaq", r["plaq"],
                     STATS_KEYS)
            key_gate(failed, f"topo_ensemble {tag} charge", r["charge"],
                     TOPO_CHARGE_KEYS)
            plaq_gate(failed, f"topo_ensemble {tag}", r["plaq_mean"], beta,
                      side, r["plaq"]["ess_ratio"],
                      (steps // chunk) * chunk * n_tr)
            accept_gate(failed, f"topo_ensemble {tag}", r["accept"])
            if "hop" in tag:
                q2_gate(failed, f"topo_ensemble {tag}", r["q2_mean"],
                        res["q2_exact"])
    reps = flag(TOPO_ARGV, "reps", p)
    n = reps * chunked(steps, chunk)
    k_h = flag(TOPO_ARGV, "hmc_num_steps", p)
    got = launch_gate(failed, "topo_ensemble", launches, wilson_launches(
        [(2 * n, k_h), (n, 3)]))
    log(f"[drivers] topo_ensemble {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


def charge_mixing_check(device, kernels, failed):
    """charge_mixing: the conv sampler's annealed training (beta 2 -> 4),
    then charge statistics of it and of HMC at 16x16, 128 chains."""
    from l2hmc_tpu_torch.benchmarks import charge_mixing
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    p = charge_mixing.build_parser()
    (res,), secs = run_main(charge_mixing.main,
                            CM_ARGV + ["--device", str(device)])
    launches = phase_launches("drivers charge_mixing", kernels,
                              ("wilson_force", "wilson_double_backward"))
    key_gate(failed, "charge_mixing", res, CM_KEYS)
    for s in ("l2hmc", "hmc"):
        key_gate(failed, f"charge_mixing {s}", res[s], CM_SAMPLER_KEYS)
        if not 0.0 <= res[s]["accept_prob"] <= 1.0:
            failed.append(f"charge_mixing {s} acceptance {res[s]}")
    accept_gate(failed, "charge_mixing hmc", res["hmc"]["accept_prob"])
    train, steps = (flag(CM_ARGV, "train_steps", p),
                    flag(CM_ARGV, "eval_steps", p))
    k = flag(CM_ARGV, "num_steps", p)
    tc, ec = min(250, train), min(500, steps)
    n = ec + -(-steps // ec) * ec
    cfg = GaugeConfig(time_size=flag(CM_ARGV, "size", p),
                      space_size=flag(CM_ARGV, "size", p), num_steps=k,
                      network_arch="conv")
    got = launch_gate(failed, "charge_mixing", launches, {
        **wilson_launches([(2 * n, k)], [((train // tc) * tc, k)]),
        "conv_stack": n * conv_stack_launches_per_transition(cfg)})
    log(f"[drivers] charge_mixing {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


def pt_vs_hop_check(device, kernels, failed):
    """pt_vs_hop: HMC, HMC+hop and the 5-rung PT ladder (one flat batch on
    the Wilson force) at 16x16, beta 5."""
    from l2hmc_tpu_torch.benchmarks import pt_vs_hop

    p = pt_vs_hop.build_parser()
    (res,), secs = run_main(pt_vs_hop.main,
                            PTH_ARGV + ["--device", str(device)])
    launches = phase_launches("drivers pt_vs_hop", kernels,
                              ("wilson_force", "wilson_action_only"))
    key_gate(failed, "pt_vs_hop", res, TOPO_KEYS)
    key_gate(failed, "pt_vs_hop config", res["config"], PTH_CONFIG_KEYS)
    key_gate(failed, "pt_vs_hop ladder", res["config"]["ladder"],
             PTH_LADDER_KEYS)
    beta, side = flag(PTH_ARGV, "beta", p), flag(PTH_ARGV, "size", p)
    steps, chunk = (flag(PTH_ARGV, "eval_steps", p),
                    flag(PTH_ARGV, "chunk_size", p))
    n_tr = flag(PTH_ARGV, "trace_chains", p)
    extra = {"hmc": set(), "hmc+hop": {"hop_accept"},
             "pt": {"swap_rate_per_pair"}}
    key_gate(failed, "pt_vs_hop summary", res["summary"], extra)
    for tag in extra:
        key_gate(failed, f"pt_vs_hop summary {tag}", res["summary"][tag],
                 PTH_SUMMARY_KEYS)
        for rep in res["per_rep"]:
            r = rep[tag]
            key_gate(failed, f"pt_vs_hop {tag}", r, PTH_REC_KEYS | extra[tag])
            key_gate(failed, f"pt_vs_hop {tag} plaq", r["plaq"], STATS_KEYS)
            plaq_gate(failed, f"pt_vs_hop {tag}", r["plaq_mean"], beta, side,
                      r["plaq"]["ess_ratio"],
                      (steps // chunk) * chunk * n_tr)
    for rep in res["per_rep"]:
        q2_gate(failed, "pt_vs_hop hmc+hop", rep["hmc+hop"]["q2_mean"],
                res["q2_exact"])
        sw = rep["pt"]["swap_rate_per_pair"]
        if not all(0.0 < s < 1.0 for s in sw):
            failed.append(f"pt_vs_hop swap rates {sw}")
    reps, k = flag(PTH_ARGV, "reps", p), flag(PTH_ARGV, "hmc_num_steps", p)
    n = reps * chunked(steps, chunk)
    want = wilson_launches([(2 * n, k)])
    # a PT round: one flat HMC transition of all rungs (K+1 forces, two
    # action-only Hamiltonians) and the swap phase's action-only pass
    want["wilson_force"] += n * (k + 1)
    want["wilson_action_only"] += n * 3
    got = launch_gate(failed, "pt_vs_hop", launches, want)
    log(f"[drivers] pt_vs_hop {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


def freeze_line_check(device, kernels, failed):
    """freeze_line at the single point 16:5.0: tune_hmc (probes on
    hmc_chain), then topo_ensemble at the tuned point."""
    import tempfile
    from pathlib import Path

    from l2hmc_tpu_torch.benchmarks import freeze_line, topo_ensemble

    p = freeze_line.build_parser()
    with tempfile.TemporaryDirectory() as td:
        lines, secs = run_main(freeze_line.main, FREEZE_ARGV + [
            "--out_dir", td, "--device", str(device)])
        files = sorted(x.name for x in Path(td).iterdir())
    launches = phase_launches("drivers freeze_line", kernels,
                              ("hmc_chain", "wilson_force"))
    res = lines[-1]
    key_gate(failed, "freeze_line", res, FREEZE_KEYS)
    (size, beta), = freeze_line.parse_points(flag(FREEZE_ARGV, "points", p))
    if files != [f"freeze_{size}_{beta:g}.json", "freeze_line.json"]:
        failed.append(f"freeze_line files {files}")
    steps = flag(FREEZE_ARGV, "eval_steps", p)
    chunk = topo_ensemble.build_parser().get_default("chunk_size")
    n_tr = flag(FREEZE_ARGV, "trace_chains", p)
    point = lines[0]
    for row in res["rows"]:
        key_gate(failed, "freeze_line row", row, FREEZE_ROW_KEYS)
        q2_gate(failed, "freeze_line hmc+hop", row["q2_hop"],
                row["q2_exact"])
        if not 0.0 < row["hop_accept"] <= 1.0:
            failed.append(f"freeze_line hop acceptance {row['hop_accept']}")
    for tag in ("hmc", "hmc+hop"):
        for rep in point["per_rep"]:
            plaq_gate(failed, f"freeze_line {tag}", rep[tag]["plaq_mean"],
                      beta, size, rep[tag]["plaq"]["ess_ratio"],
                      (steps // chunk) * chunk * n_tr)
            accept_gate(failed, f"freeze_line {tag}", rep[tag]["accept"])
    k_t = int(res["rows"][0]["hmc"].split()[0][2:])
    # tune_hmc's default grid: 300 dual-averaging transitions per K, then 3
    # eps cells per K of a warm and 5 timed hmc_chain calls
    grid = (3, 4, 5, 6, 8)
    reps = flag(FREEZE_ARGV, "reps", p)
    want = wilson_launches([(300, kk) for kk in grid]
                           + [(2 * reps * chunked(steps, chunk), k_t)])
    got = launch_gate(failed, "freeze_line", launches, {
        "hmc_chain": len(grid) * 3 * 6, **want})
    log(f"[drivers] freeze_line {secs:.1f} s: {json.dumps(lines)}")
    return {"seconds": secs, "launches": got, "result": res}


def beta_campaign_check(device, kernels, failed):
    """beta_campaign at 16x16, beta 3: tune_hmc and tune_l2hmc (its probe
    trainings cut to BETA_TRAIN_CHUNK steps), then h2h_seeds at the tuned
    cells."""
    import tempfile
    from pathlib import Path

    from l2hmc_tpu_torch.benchmarks import beta_campaign
    from l2hmc_tpu_torch.train import autotune

    p = beta_campaign.build_parser()
    tune_l2 = autotune.tune_l2hmc

    def cut_tune_l2hmc(*a, **k):
        with train_chunks_of(BETA_TRAIN_CHUNK):
            return tune_l2(*a, **k)

    autotune.tune_l2hmc = cut_tune_l2hmc
    try:
        with tempfile.TemporaryDirectory() as td:
            lines, secs = run_main(beta_campaign.main, BETA_ARGV + [
                "--out", str(Path(td) / "b.json"), "--device", str(device)])
    finally:
        autotune.tune_l2hmc = tune_l2
    launches = phase_launches("drivers beta_campaign", kernels,
                              ("hmc_chain", "l2hmc_chain", "wilson_force"))
    res = lines[-1]
    key_gate(failed, "beta_campaign", res, BETA_KEYS)
    key_gate(failed, "beta_campaign hmc_opt", res["hmc_opt"],
             {"K", "eps", "accept"})
    key_gate(failed, "beta_campaign trained_cell", res["trained_cell"],
             {"K", "eps", "cells"})
    for c in res["trained_cell"]["cells"]:
        key_gate(failed, "beta_campaign cell", c, BETA_CELL_KEYS)
        if not (np.isfinite(c["score"]) and c["score"] > 0):
            failed.append(f"beta_campaign cell {c}: score")
    key_gate(failed, "beta_campaign h2h_summary", res["h2h_summary"],
             H2H_SUMMARY_KEYS)
    beta, side = flag(BETA_ARGV, "beta", p), flag(BETA_ARGV, "size", p)
    steps = flag(BETA_ARGV, "eval_steps", p)
    for rec in res["h2h_per_seed"]:
        key_gate(failed, "beta_campaign h2h_per_seed", rec, H2H_SEED_KEYS)
        for s in ("trained", "hmc"):
            key_gate(failed, f"beta_campaign {s}", rec[s], H2H_SAMPLER_KEYS)
            plaq_gate(failed, f"beta_campaign {s}", rec[s]["plaq_mean"],
                      beta, side, rec[s]["plaq"]["ess_ratio"], steps * 64)
            accept_gate(failed, f"beta_campaign {s}", rec[s]["accept"])
    k_grid = [int(k) for k in flag(BETA_ARGV, "l2hmc_k_grid", p).split(",")]
    hmc_grid = [int(k) for k in flag(BETA_ARGV, "hmc_k_grid", p).split(",")]
    seeds, train = flag(BETA_ARGV, "seeds", p), flag(BETA_ARGV, "train_steps",
                                                     p)
    pseeds = flag(BETA_ARGV, "probe_seeds", p)
    probe_chunks = max(flag(BETA_ARGV, "probe_train_steps", p) // 250, 1)
    k_t, k_h = res["trained_cell"]["K"], res["hmc_opt"]["K"]
    cells = [(kk, 3) for kk in k_grid] + [(k_t, 2)]    # + the refine pass
    ec = min(1000, steps)
    want = wilson_launches(
        [(300, kk) for kk in hmc_grid]
        + [(seeds * chunked(steps, ec), k_t), (seeds * chunked(steps, ec),
                                               k_h)],
        [(n * pseeds * probe_chunks * BETA_TRAIN_CHUNK, kk)
         for kk, n in cells] + [(seeds * train, k_t)])
    got = launch_gate(failed, "beta_campaign", launches, {
        "hmc_chain": len(hmc_grid) * 3 * 6,
        "l2hmc_chain": sum(n for _, n in cells) * pseeds * 6, **want})
    log(f"[drivers] beta_campaign {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


def local_cost_sweep_check(device, kernels, failed):
    """local_cost_sweep at 64x64, 1024 chains: nine samplers' eager
    transition rates."""
    from l2hmc_tpu_torch.benchmarks import local_cost_sweep

    p = local_cost_sweep.build_parser()
    (res,), secs = run_main(local_cost_sweep.main,
                            LCS_ARGV + ["--device", str(device)])
    launches = phase_launches("drivers local_cost_sweep", kernels,
                              ("wilson_force",))
    key_gate(failed, "local_cost_sweep", res, LCS_KEYS)
    key_gate(failed, "local_cost_sweep variants", res["variants"], LCS_TAGS)
    for tag, row in res["variants"].items():
        key_gate(failed, f"local_cost_sweep {tag}", row, LCS_ROW_KEYS)
        if not all(np.isfinite(v) and v > 0 for v in row.values()):
            failed.append(f"local_cost_sweep {tag} rates {row}")
    steps = flag(LCS_ARGV, "steps", p)
    k, k_h = flag(LCS_ARGV, "num_steps", p), flag(LCS_ARGV, "hmc_num_steps",
                                                  p)
    n = 4 * steps                     # a warm and three timed chunks
    got = launch_gate(failed, "local_cost_sweep", launches, wilson_launches(
        [(n, k_h), (n * (len(LCS_TAGS) - 1), k)]))
    log(f"[drivers] local_cost_sweep {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


def volume_sweep_check(device, kernels, failed):
    """volume_sweep: conv transitions at L = 8, 16, 32, 64, 128 chains, and
    the power-law fit."""
    from l2hmc_tpu_torch.benchmarks import volume_sweep
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    p = volume_sweep.build_parser()
    (res,), secs = run_main(volume_sweep.main,
                            VOL_ARGV + ["--device", str(device)])
    launches = phase_launches("drivers volume_sweep", kernels,
                              ("wilson_force",))
    key_gate(failed, "volume_sweep", res, VOL_KEYS)
    for row in res["rows"]:
        key_gate(failed, "volume_sweep row", row, VOL_ROW_KEYS)
        if not row["ms_per_transition"] > 0:
            failed.append(f"volume_sweep row {row}")
        accept_gate(failed, f"volume_sweep L={row['l']}", row["accept"])
    if not (np.isfinite(res["exponent_b"]) and np.isfinite(res["coeff_a_ms"])
            and res["coeff_a_ms"] > 0):
        failed.append(f"volume_sweep fit b={res['exponent_b']} "
                      f"a={res['coeff_a_ms']}")
    if res["platform"] != "gpu":
        failed.append(f"volume_sweep platform {res['platform']}")
    sizes, chunk = flag(VOL_ARGV, "sizes", p), flag(VOL_ARGV, "chunk", p)
    conv = sum(4 * chunk * conv_stack_launches_per_transition(GaugeConfig(
        time_size=lt, space_size=lt, num_steps=3,
        network_arch=flag(VOL_ARGV, "arch", p))) for lt in sizes)
    got = launch_gate(failed, "volume_sweep", launches, {
        **wilson_launches([(len(sizes) * 4 * chunk, 3)]),
        "conv_stack": conv})
    log(f"[drivers] volume_sweep {secs:.1f} s: {json.dumps(res)}")
    return {"seconds": secs, "launches": got, "result": res}


HOST_DRIVERS = (("topo_ensemble", topo_ensemble_check),
                ("charge_mixing", charge_mixing_check),
                ("pt_vs_hop", pt_vs_hop_check),
                ("freeze_line", freeze_line_check),
                ("beta_campaign", beta_campaign_check),
                ("local_cost_sweep", local_cost_sweep_check),
                ("volume_sweep", volume_sweep_check))


def drivers_child(device):
    """Phase 16's host-bound drivers, each launch count from 0, run in a
    child process (:func:`start_child`) from the end of phase 9 on."""
    kernels = reset_launches()
    failed, out = [], {}
    for name, check in HOST_DRIVERS:
        try:
            out[name] = check(device, kernels, failed)
        except Exception as e:            # a driver that raised: a gate
            failed.append(f"{name} raised {type(e).__name__}: {e}")
            reset_launches()
    return {"out": out, "failed": failed}


def drivers_phase(device, child):
    """Phase 16: the topological and volume drivers, each ``main`` at the
    widths of its defaults, cut in length, launches counted from 0 per
    driver; the fused ones here, the host-bound ones in ``child``
    (:func:`drivers_child`), joined at the end."""
    kernels = reset_launches()
    t0 = time.perf_counter()
    failed, out = [], {}
    for name, check in (("fused_hop", fused_hop_check),
                        ("local64_h2h", local64_h2h_check),
                        ("scaling", scaling_check)):
        out[name] = check(device, kernels, failed)
    res = join_child(child)
    failed += res["failed"]
    out.update(res["out"])
    log(f"[drivers] phase {time.perf_counter() - t0:.1f} s (the host-bound "
        "drivers beside phases 10-15)")
    if failed:
        raise AssertionError(f"drivers: failed gates {failed}")
    return out


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
    conv = conv_stack_phase(device)
    # the analytic-target runs (no kernel, host-bound) beside phases 10-13,
    # after the phases that time kernels
    targets = start_child("targets_child", device)
    vae_sun = start_child("vae_sun_phase", device)
    drivers = start_child("drivers_child", device)
    try:
        cli = cli_phase(device)
        ens = ensembles_phase(device)
        flow = flow_phase(device)
        par = parallel_phase(device)
        h2h = h2h_phase(device, targets)
        vs = join_child(vae_sun)
        drv = drivers_phase(device, drivers)
    finally:
        stop_child(targets)
        stop_child(vae_sun)
        stop_child(drivers)
    errs["hmc_chain"] = max(errs["hmc_chain"], flow["hmc_chain_err"],
                            par["max_abs_err"]["smc"])

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
    local_params = init_params(local_cfg(L64_LAYERS),
                               torch.Generator().manual_seed(640),
                               device=device)
    local_b = l2hmc_chain_bound(
        L64_CHAINS * L64_SIDE * L64_SIDE, L64_K,
        stencil_macs(local_params.xnet))
    local_lib_ms = conditioner_conv_ms(local_params, L64_K, device)
    log(f"[result] l2hmc_local_chain c{L64_CHANNELS}L{L64_LAYERS}: its "
        f"{3 * L64_K + 1} conditioner calls per transition as float32 "
        f"conv2d (TF32 off, {L64_CHAINS} chains at {L64_SIDE}x{L64_SIDE}) "
        f"{1e3 * local_lib_ms:.1f} us/transition (one CUDA graph)")
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
         "bound_ms": local_b[0], "bound_by": local_b[1],
         "library_ms": local_lib_ms},
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
    # the slab route of the same kernel (dp x sp, lattice_sharding): its
    # launches are the sharded quick-start path's (phase 13)
    for kname, w in par["slab_route"].items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "l2hmc_tpu_torch/ops/csrc/wilson.cu",
            "replaces": "l2hmc_tpu/ops/wilson.py:95",
            "launches": w["launches"], "max_abs_err": w["max_abs_err"],
            "ms": w["ms"], "plain_ms": w["plain_ms"],
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "library_ms": None})
    kernels.append({
        "name": "conv_stack", "route": "cuda",
        "source": "l2hmc_tpu_torch/ops/csrc/conv_stack.cu",
        "replaces": None,
        "launches": cli["canonical-restore"]["conv_stack_launches"],
        "max_abs_err": conv["max_abs_err"], "ms": conv["ms"],
        "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
        "bound_by": conv["bound_by"], "library_ms": conv["library_ms"]})
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
        f"16, 16, 2) and their slab route at (128, 18, 16, 2) (the "
        f"quick-start lattice extended by its halo rows; device time by "
        f"torch.profiler) and for issue_rates "
        f"(the cheap probe at {RATE_SHAPES[0]}, m={RATE_M[0]}), per call for "
        f"conv_stack (both slots, {CONV_CHAINS} chains at {CONV_SIDE}x"
        f"{CONV_SIDE}, CUDA events); launches are"
        f" the main paths' (Wilson: the train path's; its slab route: the "
        f"quick-start train path's under lattice_sharding, {PAR_STEPS + 1} "
        f"steps; the modes and issue_rates: the decomposition path's; "
        f"conv_stack: the canonical CLI command's eval, --restore); "
        f"library_ms: l2hmc_chain's "
        f"ten conditioner products as torch.matmul and l2hmc_local_chain's "
        f"13 conditioner calls as conv2d (yardsticks for part of their "
        f"work), conv_stack's the eager stacks (cuDNN, the same function),"
        f" null elsewhere: no single PyTorch call computes these "
        f"functions.  Train step {train_ms:.3f} "
        f"ms (plain potential {train_plain_ms:.3f} ms); train-step check "
        f"max rel err {train_err:.3e}; on {smi}")
    for part, line in ens.items():
        log(f"[result] ensembles {part}: {json.dumps(line)}; on {smi}")
    for cmd, line in cli.items():
        log(f"[result] cli {cmd}: {line['ms_per_train_step']:.3f} ms per "
            f"train step, {line['transitions_per_s']} transitions/s (eval at "
            f"beta_final, beta_final - 1); on {smi}")
    log(f"[result] flow cli: ms per train step (chunks 2-6) "
        f"{flow['cli']['ms_per_train_step']}, launches "
        f"{flow['cli']['launches']}; reverse-KL step kernel / plain "
        f"{flow['step8']['ms_kernel']} / {flow['step8']['ms_plain']} ms "
        f"(8x8), {flow['step16']['ms_kernel']} / "
        f"{flow['step16']['ms_plain']} ms (16x16); on {smi}")
    log(f"[result] parallel: modes (s) {par['modes_seconds_nccl']} on the "
        f"group, {par['modes_seconds_alone']} alone; kernel vs plain "
        f"{par['max_abs_err']}; quick-start train step (ms) "
        f"{par['train_step_ms']}, under lattice_sharding "
        f"{par['lattice_sharding_step_ms']:.3f} (x within "
        f"{par['lattice_sharding_x_diff']:.3e} of the unsharded step); "
        f"on {smi}")
    tvh = h2h["trained_vs_hmc"]["result"]
    secs = {k: round(v["seconds"], 1) for k, v in h2h.items()
            if k != "targets"}
    secs.update({k: round(v["seconds"], 1)
                 for k, v in h2h["targets"].items()})
    targets = {k: v["summary"] for k, v in h2h["targets"].items()}
    log(f"[result] h2h trained_vs_hmc (champion, 2048 chains, "
        f"{tvh['config']['eval_steps']} transitions): plaquette ESS/s ratio "
        f"eager {tvh['plaq_ess_per_s_ratio']} (per step "
        f"{tvh['plaq_ess_per_step_ratio']}), fused "
        f"{tvh['fused_tier']['plaq_ess_per_s_ratio']}; Q ESS/s ratio eager "
        f"{tvh['q_ess_per_s_ratio']}, fused "
        f"{tvh['fused_tier']['q_ess_per_s_ratio']}; phase 14 seconds "
        f"{secs}; targets {json.dumps(targets)}; on {smi}")
    vae, sun = vs["vae"], vs["sun"]
    log(f"[result] vae and sun (phase 15, {vs['seconds']:.1f} s; no kernel "
        f"on this path): train_vae @configs/vae_digits.txt "
        f"{vae['seconds']:.1f} s, {vae['steps']} train steps at "
        f"{np.median(vae['ms_per_train_step']):.2f} ms median per step, ELBO "
        f"{vae['elbo'][0]:.3f} -> {vae['elbo'][1]:.3f}, summary "
        f"{json.dumps(vae['summary'])} (band {vae['ais_band']}), AIS oracle "
        f"{vae['oracle']['ais']:.4f} vs exact {vae['oracle']['exact']:.4f}; "
        + "; ".join(
            f"{k} plaq {v['plaq_jk'][0]:.5f} +- {v['plaq_jk'][1]:.5f} (exact "
            f"{v['eval']['plaq_exact']:.5f}) acc "
            f"{v['eval']['accept_prob']:.4f}, "
            f"{v['ms_per_eval_transition']:.3f} ms/eval transition"
            + (f", {v['ms_per_train_step']:.3f} ms/train step"
               if v["ms_per_train_step"] else "")
            for k, v in sun.items() if k in SUN_RUNS)
        + f"; 4-D SU(2) beta 0.5 plaq {sun['su2_4d_b05']['eval']['plaq']:.5f}"
        f" (strong coupling "
        f"{sun['su2_4d_b05']['eval']['plaq_strong_coupling_lo']:.5f}) acc "
        f"{sun['su2_4d_b05']['eval']['accept_prob']:.4f}; sun_nd_bench "
        f"{json.dumps(sun['sun_nd_bench']['result'])}; on {smi}")
    for driver, r in drv.items():
        log(f"[result] drivers {driver} ({r['seconds']:.1f} s, launches "
            f"{json.dumps(r['launches'])}): {json.dumps(r['result'])}; on "
            f"{smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"[done] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
