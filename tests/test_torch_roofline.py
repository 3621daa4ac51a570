"""PyTorch port, the issue-rate roofline against JAX's ``benchmarks/vpu_roofline.py``.

- The op counter (a ``TorchDispatchMode`` over the port's shared
  transition math) against the JAX script's jaxpr walk of its own math, at
  b=8 chains of 4x4, K=3, and at b=4 of 4x6, K=2.
- The plain probe chains against the same bodies run through
  ``jax.lax.fori_loop`` at (8, 16), m=64.
- ``rates_from_slopes`` against the JAX script's ``measure_rates``
  arithmetic on fixed times (its clock replaced by a scripted one).
- The CPU wrapper of ``csrc/issue_rates.cu``, the counter's classes and the
  issue estimate; and a fresh interpreter that imports the benchmarks without
  JAX.

Tolerance of the probe chains: 1e-5 absolute.  XLA's CPU exp, log, sin and
atan2 are its own polynomials, torch's are libm's; each is within ~2 ulp,
every probe map contracts (|f'| < 1 at its fixed point), so 64 steps keep
the difference at a few ulp of values below 2.  The counts and the rate
arithmetic are exact.
"""

import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.benchmarks import vpu_roofline as tv
from l2hmc_tpu_torch.ops import issue_rates as tir

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from benchmarks import vpu_roofline as jv  # noqa: E402

torch.set_num_threads(1)

# the probe bodies of benchmarks/vpu_roofline.py:256-263, and atan2
JAX_BODIES = {
    "cheap": lambda x: x * 0.9995 + 2e-4,
    "exp": lambda x: jnp.exp(-x),
    "trig": lambda x: jnp.sin(x + 0.7),
    "log": lambda x: jnp.log(x + 1.5),
    "div": lambda x: 1.7 / (x + 1.2),
    "floor": lambda x: (x - jnp.floor(x * 0.73)) * 0.9 + 0.05,
    "atan2": lambda x: jnp.arctan2(x + 0.3, x + 1.1),
}


@pytest.mark.parametrize("b,lt,lx,K", [(8, 4, 4, 3), (4, 4, 6, 2)])
def test_torch_op_counts_match_jax_jaxpr_walk(b, lt, lx, K):
    """Per-transition op counts of the ablated trained transition and of
    HMC, the port's against the JAX script's (E = b d elements, B = b).

    exp, trig, log and floor: the same ops on both sides, so equal.

    atan2 / div: the port calls atan2 once per link and position
    half-update (4 K E); the reference's polynomial arctan divides twice
    and its circle map once more (12 K E), and it forms the mean plaquette
    1 - pot/d inside the transition (B), where the port does so in the
    chain.  So div_jax - div_port = 12 K E + B (HMC: B).

    cheap (JAX minus port):
    - ``_roll_s``, the TPU's lane-roll fix (eq + select), 2 E per call,
      2K+1 calls: 2E(2K+1); the port rolls with ``torch.roll`` (layout);
    - the energy: the reference sums v^2, w^2 per chain and differences
      two Hamiltonians (4E + 14B; HMC 4E + 13B), the port differences per
      site (8E + 6B; HMC 8E + 5B): -4E + 8B;
    - isfinite: one op in the jaxpr, four aten ops in torch (==, abs, !=,
      *), twice (once in HMC): -6B (HMC -3B);
    - the accept: the reference blends x0, x1, sinp by 0/1 arithmetic (3E +
      B each), pot and chg (4B each), casts acc, forms 1 - pot/d (9E +
      14B); the port selects x0, x1, sinp, cosp, pot, chg and compares
      (4E + 3B): 5E + 11B;
    - the circle map's arctangent: 26 cheap ops per element in
      ``_atan_f32`` plus the clamp and the product of its ratio against
      one product in the port: 27 per element, 27 * 4KE;
    - the direction compares: the reference forms d > 0 at every use
      (12K + 2 per transition), the port once: (12K + 1) B.
    Sum: ablated E(112K + 3) + B(12K + 14); HMC E(4K + 3) + 16B.
    """
    e = b * lt * lx
    j_abl, j_hmc = jv.transition_op_counts(b, lt, lx, K)
    t_abl, t_hmc = tv.transition_op_counts(b, lt, lx, K)
    for cls in ("exp", "trig", "log", "floor"):
        assert t_abl[cls] == j_abl[cls], cls
        assert t_hmc.get(cls, 0) == j_hmc.get(cls, 0), cls
    assert t_abl["atan2"] == 4 * K * e and "atan2" not in t_hmc
    assert j_abl["div"] - t_abl["div"] == 12 * K * e + b
    assert j_hmc["div"] - t_hmc["div"] == b
    assert j_abl["cheap"] - t_abl["cheap"] == e * (112 * K + 3) + b * (
        12 * K + 14)
    assert j_hmc["cheap"] - t_hmc["cheap"] == e * (4 * K + 3) + 16 * b
    assert "mm" not in t_abl and "mm" not in t_hmc
    if (b, lt, lx, K) == (8, 4, 4, 3):       # the reference's own numbers
        assert j_abl == {"cheap": 113984, "div": 8128, "trig": 3952,
                         "exp": 5128, "floor": 3456, "log": 1536}
        assert j_hmc == {"cheap": 13880, "div": 1160, "floor": 1152,
                         "trig": 768, "exp": 8}


@pytest.mark.parametrize("probe", [p.name for p in tir.PROBES])
def test_torch_probe_chain_matches_jax_fori_loop(probe):
    x = np.random.default_rng(7).uniform(0.0, 1.0, (8, 16)).astype(
        np.float32)
    body = JAX_BODIES[probe]
    want = jax.lax.fori_loop(0, 64, lambda i, v: body(v), jnp.asarray(x))
    before = tir.probe_chain.launches
    got = tir.probe_chain(torch.from_numpy(x), probe, 64)
    assert tir.probe_chain.launches == before         # CPU: plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not np.allclose(got.numpy(), x)            # the chain moved


def test_torch_rates_from_slopes_match_jax_measure_rates(monkeypatch):
    """The JAX script's ``measure_rates`` with a scripted clock (a call at
    length m lasts c0 + slope * m) against ``rates_from_slopes`` on the
    same slopes; the floor probe's slope sits below its cheap-op share, so
    the 0.2 floor is exercised too."""
    # seconds-scale steps (the JAX script clamps a slope below 1e-9 s)
    b, d, m_lo, m_hi = 8, 16, 2, 4
    elems = b * d
    slopes = {"cheap": 2 * elems / 64.0, "exp": elems / 4.0,
              "trig": elems / 1.0, "log": elems / 1.25,
              "div": elems / 2.0, "floor": 3 * elems / 64.0}
    durations = [0.5 + slopes[name] * m
                 for name in ("cheap", "exp", "trig", "log", "div", "floor")
                 for m in (m_lo, m_hi)]
    calls = {"n": 0, "t": 0.0}

    def clock():
        k = calls["n"]
        calls["n"] += 1
        if k % 2:
            return calls["t"] + durations[k // 2]
        calls["t"] += 1024.0
        return calls["t"]

    monkeypatch.setattr(jv, "time", SimpleNamespace(
        perf_counter=clock, strftime=time.strftime))
    want = jv.measure_rates(b, d, reps=1, m_lo=m_lo, m_hi=m_hi)
    assert calls["n"] == 2 * len(durations)
    got = tv.rates_from_slopes(slopes, elems)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-6), name
    assert got["floor"] == pytest.approx(1.0 / (0.2 * 3.0 / 64.0),
                                         rel=1e-9)
    assert tv.rates_from_slopes(dict(slopes, atan2=elems / 0.5),
                                elems)["atan2"] == pytest.approx(
        1.0 / (1.0 / 0.5 - 2.0 / 64.0), rel=1e-9)


def test_torch_op_counter_classes_and_issue_estimate():
    """Matrix products count m n k multiply-adds, in-place ops count as
    their op, layout ops not at all; the issue estimate charges each class
    at its rate, a sin/cos pair once and a multiply-add at half the cheap
    rate."""
    a, w = torch.ones(3, 5), torch.ones(5, 7)

    def fn():
        y = a @ w                     # mm: 3*7*5
        y = torch.addmm(y, a, w)      # addmm: 3*7*5
        y.mul_(2.0)                   # cheap 21
        z = torch.roll(y, 1, 0).reshape(-1)   # layout
        return torch.atan2(torch.exp(z), torch.cos(z)), torch.tanh(z)

    c = tv.count_ops(fn)
    assert c == {"mm": 210, "cheap": 21, "exp": 42, "trig": 21,
                 "atan2": 21}
    assert tv.count_ops(fn, by_op=True) == {
        "mm": 105, "addmm": 105, "mul": 21, "exp": 21, "cos": 21,
        "atan2": 21, "tanh": 21}
    rates = {"cheap": 50.0, "exp": 2.0, "trig": 1.0, "atan2": 0.5}
    assert tv.issue_estimate(c, rates) == pytest.approx(
        21 / 50 + 42 / 2 + 21 / 2 / 1 + 21 / 0.5 + 210 / 25)


@pytest.mark.parametrize("kind,kw", [("ablated", {}), ("hmc", {}),
                                     ("mlp", {"hidden": 16}),
                                     ("local", {"channels": 8, "layers": 2})])
def test_torch_transition_math_pairs_every_sin_with_a_cos(kind, kw):
    """The issue estimate charges one trig op per sin/cos pair, as the
    kernels compute both with one sincosf: every transition math issues as
    many cos as sin elements."""
    by_op = tv.op_counts(kind, 3, 4, 6, 2, by_op=True, **kw)
    assert by_op["sin"] == by_op["cos"] > 0
    assert tv.op_counts(kind, 3, 4, 6, 2, **kw)["trig"] == 2 * by_op["sin"]


def test_torch_probe_chain_wrapper_on_cpu():
    x = torch.full((4, 8), 0.5)
    for p in tir.PROBES:
        got = tir.probe_chain(x, p.name, 3)
        want = p.body(p.body(p.body(x)))
        assert torch.equal(got, want), p.name
    assert torch.equal(tir.probe_chain(x, "exp", 0), x)
    with pytest.raises(ValueError, match="probe"):
        tir.probe_chain(x, "sqrt", 3)
    with pytest.raises(ValueError, match="m="):
        tir.probe_chain(x, "exp", -1)
    assert tir.probe_chain.launches == 0


def test_torch_ab_time_pairs_runs_in_turns():
    """``ab_time.paired_difference`` on runs in the order base, new, new,
    base: new - base per pair, its mean and standard error; runs that do
    not pair base with new raise."""
    from l2hmc_tpu_torch.benchmarks.ab_time import paired_difference

    runs = [("base", 10.0), ("new", 11.0), ("new", 12.5), ("base", 10.5),
            ("base", 9.0), ("new", 9.5)]
    mean, se, diffs = paired_difference(runs)
    assert diffs == [1.0, 2.0, 0.5]
    assert mean == pytest.approx(3.5 / 3)
    assert se == pytest.approx(np.std(diffs, ddof=1) / np.sqrt(3))
    with pytest.raises(ValueError, match="pair"):
        paired_difference([("base", 1.0), ("base", 2.0)])


def test_torch_benchmarks_import_no_jax():
    """A fresh interpreter imports the benchmark modules and counts the
    champion-shape ops without importing jax or the JAX package."""
    code = r"""
import sys
before = {m for m in sys.modules if m == "jax" or m.startswith("jax.")}
from l2hmc_tpu_torch.benchmarks import (ab_time, kernel_decomposition,
                                        local_kernel_bench, vpu_roofline,
                                        wilson_routes, wilson_variants)
a, h = vpu_roofline.transition_op_counts(2048, 16, 16, 3)
assert a["exp"] == 5120 * 4096 + 2048 and h["exp"] == 2048, (a, h)
jax_mods = {m for m in sys.modules if m == "jax" or m.startswith("jax.")}
assert jax_mods == before, sorted(jax_mods - before)[:5]
ref = [m for m in sys.modules if m == "l2hmc_tpu" or m.startswith("l2hmc_tpu.")
       or m == "benchmarks" or m.startswith("benchmarks.")]
assert not ref, ref
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NOJAX_OK" in proc.stdout
