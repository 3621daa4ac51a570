"""MCMC statistics: autocorrelation, ESS, integrated autocorrelation time,
jackknife/blocking, tunneling diagnostics (a copy of
``l2hmc_tpu/analysis/stats.py``, which is numpy only).

Rebuild of the reference's analysis layer (SURVEY §2.5):
``utils/autocorr.py:23-209`` (FFT autocorrelation, ESS, Sokal-window IAT),
``utils/jackknife.py:22-67`` + ``utils/data_utils.py:66-142`` (block
resampling), ``utils/trajectories.py:5-95`` (distances, mode-tunneling).

All functions are pure numpy over chain arrays shaped ``(T, ...)`` with
time on the leading axis; device tensors are moved to the host first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def autocorr_fft(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation function via FFT (``utils/autocorr.py:23-34``).

    ``x`` is 1-D ``(T,)``; returns ``rho(t)`` with ``rho(0)=1``.
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    x = x - x.mean()
    # zero-pad to the next power of two for FFT efficiency
    f = np.fft.rfft(x, n=2 * n)
    acf = np.fft.irfft(f * np.conjugate(f))[:n].real
    if acf[0] == 0:
        return np.zeros_like(acf)
    return acf / acf[0]


def autocovariance(x: np.ndarray, tau: int = 0) -> float:
    """Lag-``tau`` autocovariance averaged over chains and dims
    (``utils/autocorr.py:42-55``; x shaped (T, chains, d) or (T,))."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None, None]
    dt = x.shape[0] - tau
    xc = x - x.mean(axis=0)
    return float(np.mean(np.sum(xc[:dt] * xc[tau : tau + dt], axis=-1)))


def calc_ess(x: np.ndarray, cutoff: float = 0.05) -> float:
    """Effective sample size ratio ``1 / (1 + 2 sum rho)`` with the
    reference's 0.05 truncation (``utils/autocorr.py:65-69``).

    ``x`` 1-D; returns ESS per sample in (0, 1].
    """
    rho = autocorr_fft(x)
    mask = rho >= cutoff
    # truncate at first dip below cutoff
    if not mask[0]:
        return 1.0
    first_below = np.argmin(mask) if not mask.all() else len(rho)
    s = np.sum(rho[1:first_below])
    return float(1.0 / (1.0 + 2.0 * max(s, 0.0)))


def integrated_time(x: np.ndarray, c: float = 5.0, tol: float = 50.0) -> Tuple[float, bool]:
    """Sokal-window integrated autocorrelation time
    (``utils/autocorr.py:133-199``).

    Returns ``(tau_int, reliable)``; ``reliable`` is False when the chain is
    shorter than ``tol * tau`` (the reference raises ``AutocorrError``).
    """
    rho = autocorr_fft(x)
    taus = 2.0 * np.cumsum(rho) - 1.0
    # Sokal's automated windowing: smallest M with M >= c * tau(M)
    window = np.arange(len(taus)) >= c * taus
    m = np.argmax(window) if window.any() else len(taus) - 1
    tau = float(taus[m])
    reliable = bool(tol * tau <= len(x))
    return tau, reliable


def batch_means_ess(x: np.ndarray, num_batches: int = 20) -> float:
    """Batch-means effective sample size — cross-check for the FFT/Sokal
    estimators (``calc_ess`` / ``integrated_time``).

    Split the chain into ``num_batches`` contiguous batches of size ``b``.
    For ``b >> tau_int`` the batch means are approximately independent with
    variance ``sigma2_asym / b`` where ``sigma2_asym = var(x) * 2 tau_int``
    is the asymptotic variance, so

        ESS = T * var(x) / sigma2_asym ~= T * var(x) / (b * var(batch means)).

    Returns an absolute ESS in ``[1, T]`` (not a per-sample ratio).
    """
    x = np.asarray(x, np.float64)
    b = len(x) // num_batches
    if b < 2:
        return float(len(x))
    t = b * num_batches
    means = x[:t].reshape(num_batches, b).mean(axis=1)
    var_b = means.var(ddof=1)
    var_x = x[:t].var(ddof=1)
    if var_b == 0.0 or var_x == 0.0:
        return float(t)
    return float(np.clip(t * var_x / (b * var_b), 1.0, t))


def jackknife(samples: np.ndarray, num_blocks: int = 10) -> Tuple[float, float]:
    """Delete-one-block jackknife mean and error
    (``utils/jackknife.py:22-67``, ``utils/data_utils.py:119-142``).

    ``samples`` 1-D ``(T,)``; returns ``(mean, err)``.
    """
    samples = np.asarray(samples, np.float64)
    t = len(samples) // num_blocks * num_blocks
    blocks = samples[:t].reshape(num_blocks, -1)
    total = blocks.sum()
    n_per = blocks.shape[1]
    # delete-one-block means
    deleted = (total - blocks.sum(axis=1)) / (t - n_per)
    mean = deleted.mean()
    err = np.sqrt((num_blocks - 1) / num_blocks * np.sum((deleted - mean) ** 2))
    return float(mean), float(err)


def sem(x: np.ndarray) -> float:
    """Standard error of the mean (reference uses ``scipy.stats.sem``,
    ``gauge_model.py:1473-1533``)."""
    x = np.asarray(x, np.float64).ravel()
    if len(x) < 2:
        return 0.0
    return float(x.std(ddof=1) / np.sqrt(len(x)))


# ---------------------------------------------------------------------------
# Pooled multi-chain estimators (VERDICT r3 item 6)
# ---------------------------------------------------------------------------
# Single-trace Sokal windows fail exactly where topological freezing makes
# tau_int interesting: at 32x32 beta=4, tau_int(Q) >> any affordable trace
# length, and per-chain estimates are "estimator garbage" (RESULTS.md).
# But campaign evals advance O(2048) INDEPENDENT chains — averaging the
# per-chain autocovariance over chains cuts the noise on rho(t) by
# sqrt(C), extending the reliable window by orders of magnitude.  The
# key detail is GLOBAL mean subtraction: with per-chain means, short
# chains at large tau bias rho (and tau) down by O(tau/T); the pooled
# cross-chain mean is unbiased because chains are iid replicas.


def pooled_autocorr(x: np.ndarray) -> np.ndarray:
    """Chain-averaged normalized autocorrelation of a ``(T, C)`` trace.

    Per-chain FFT autocovariances with the GLOBAL mean subtracted,
    averaged over chains, normalized at lag 0.  Noise on ``rho(t)`` is
    ``~1/sqrt(C)`` of the single-chain estimator's.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    t = x.shape[0]
    xc = x - x.mean()                      # global mean (see note above)
    f = np.fft.rfft(xc, n=2 * t, axis=0)
    acf = np.fft.irfft(f * np.conjugate(f), axis=0)[:t].real.mean(axis=1)
    if acf[0] == 0:
        return np.zeros_like(acf)
    return acf / acf[0]


def pooled_integrated_time(
    x: np.ndarray, c: float = 5.0, tol: float = 50.0
) -> Tuple[float, bool]:
    """Sokal-window tau_int from the pooled ``(T, C)`` autocorrelation.

    Same windowing rule as :func:`integrated_time`; the reliability
    criterion uses the POOLED statistics: the estimate is trustworthy when
    the window fits the trace (``c * tau <= T``) and the total data
    ``T * C`` exceeds ``tol * tau`` — with 2048 chains that is ~45x more
    tau-range than one trace of the same length.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    t, chains = x.shape
    rho = pooled_autocorr(x)
    taus = 2.0 * np.cumsum(rho) - 1.0
    window = np.arange(len(taus)) >= c * taus
    m = np.argmax(window) if window.any() else len(taus) - 1
    tau = float(taus[m])
    reliable = bool(c * tau <= t and tol * tau <= t * chains)
    return tau, reliable


def pooled_ess(x: np.ndarray) -> float:
    """Per-sample ESS ratio ``1 / tau_int`` from the pooled estimator.

    Consistent with :func:`integrated_time`'s normalization
    (``tau = 1 + 2 sum rho``), so ``ess_ratio * T * C`` is the effective
    sample count of the whole population.
    """
    tau, _ = pooled_integrated_time(x)
    return float(1.0 / max(tau, 1.0))


# ---------------------------------------------------------------------------
# Trajectory / tunneling diagnostics (utils/trajectories.py)
# ---------------------------------------------------------------------------


def step_distances(trajectory: np.ndarray) -> np.ndarray:
    """Euclidean distance per step (``utils/trajectories.py:5-37``).

    ``trajectory`` shaped ``(T, d)`` or ``(T, chains, d)``.
    """
    diff = np.diff(np.asarray(trajectory, np.float64), axis=0)
    return np.sqrt(np.sum(diff * diff, axis=-1))


def nearest_mode(trajectory: np.ndarray, means: np.ndarray) -> np.ndarray:
    """Index of the nearest mixture mode at each step
    (``utils/trajectories.py:39-61``). trajectory (T, d), means (k, d)."""
    d2 = np.sum(
        (trajectory[:, None, :] - means[None, :, :]) ** 2, axis=-1
    )
    return np.argmin(d2, axis=-1)


def tunneling_rate(trajectory: np.ndarray, means: np.ndarray) -> float:
    """Fraction of steps that hop between modes
    (``utils/trajectories.py:63-95``)."""
    modes = nearest_mode(trajectory, means)
    if len(modes) < 2:
        return 0.0
    return float(np.mean(np.diff(modes) != 0))


def tunneling_events(charges: np.ndarray) -> np.ndarray:
    """Topological tunneling events |dQ| per step per chain
    (reference ``charge_diff_op``, ``gauge_model.py:849-851``).
    charges (T, chains)."""
    return np.abs(np.diff(np.asarray(charges, np.float64), axis=0))


def charge_histogram(charges: np.ndarray):
    """Integer-charge histogram (``gauge_model.py:1509-1533``)."""
    q = np.asarray(charges).astype(np.int64).ravel()
    vals, counts = np.unique(q, return_counts=True)
    return dict(zip(vals.tolist(), counts.tolist()))


def therm_cut(arr: np.ndarray, frac: float = 0.25) -> np.ndarray:
    """Drop the leading ``frac`` as thermalization (reference
    ``therm_frac``, ``gauge_model.py:1449-1460``)."""
    n = int(len(arr) * frac)
    return arr[n:]


def observables_stats(metrics: dict, therm_frac: float = 0.25) -> dict:
    """Thermalization-cut summary stats for an eval run's stacked metrics
    (``calc_observables_stats``, ``gauge_model.py:1473-1533``)."""
    out = {}
    for name, arr in metrics.items():
        a = therm_cut(np.asarray(arr), therm_frac)
        out[name] = {"mean": float(a.mean()), "sem": sem(a)}
    if "charges" in metrics:
        q = therm_cut(np.asarray(metrics["charges"]), therm_frac)
        out["charges"]["histogram"] = charge_histogram(q)
        out["charges"]["susceptibility"] = float(np.mean(q * q))
    return out
