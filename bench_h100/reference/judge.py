"""The numbers that decide ``correct``: the program's outputs against the
plain reference's on the same inputs and the same random stream.

A chain call's answers are its links out and its ``(N, B)`` plaquette,
charge and accept-probability traces.  Two float32 programs on one stream
agree to rounding at first, but the U(1) dynamics is chaotic where
plaquettes pass near pi: the kernels' momenta differ from the reference's
by an ulp or two (the device's Box-Muller), and within some tens of
transitions a few chains carry that difference up to 1e-3 of a link and
then part at a near-tie accept decision.  So the largest gap over every
chain and transition measures that tail, not the arithmetic, and the check
compares what is steady from seed to seed:

- the first transition of every chain, where program and reference start
  from the same links: its accept probability and plaquette, and whether
  a differing accept decision there lies at a near-tie (``|u - prob_ref|``
  within ``first_prob_gap``'s limit);
- each chain's first ``EARLY`` transitions up to and with its first
  differing accept decision: the 99th percentile over chains of each chain's widest
  accept-probability gap there, which stays at rounding while fewer than
  one chain in a hundred turns chaotic that early (so a fault in a later
  transition of one chain in a hundred or more shows);
- the bulk of the call: the 90th percentile over chains of the links-out
  gap (mod 2 pi), which stays at rounding while fewer than a tenth of the
  chains part.

Each number is ``(value, limit)``; a run is correct when every value is
finite and at most its limit.  :func:`chain_summary` keeps the per-chain
readings the numbers come from (``control.py --dump`` saves them).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from bench_h100.reference import lattice

Numbers = Dict[str, Tuple[float, float]]
PART_ATOL = 1e-3        # links further apart (mod 2 pi): the chain parted
BULK_QUANTILE = 0.9
EARLY_QUANTILE = 0.99
EARLY = 20              # transitions of the per-chain early readings


def chain_summary(prog, ref) -> Dict[str, torch.Tensor]:
    """Per-chain readings of one call: ``prog = (links, plaq, charge,
    prob)``, ``ref = (links, plaq, charge, prob, u)``."""
    links_p, plaq_p, chg_p, prob_p = (t.float() for t in prog)
    links_r, plaq_r, chg_r, prob_r, u = ref
    differ = (u < prob_p) != (u < prob_r)
    n = u.shape[0]
    steps = torch.arange(n, device=u.device)[:, None]
    flip_at = torch.where(differ, steps, n).min(dim=0).values
    # up to and with the first differing decision: both sides made it from
    # the same links, so its probabilities still compare
    before = steps <= flip_at[None, :]
    dprob = torch.where(before, (prob_p - prob_r).abs(), 0.0)
    dplaq = torch.where(before, (plaq_p - plaq_r).abs(), 0.0)
    m = min(n, EARLY)
    return {
        "early_prob": dprob[:m].amax(dim=0),
        "early_plaq": dplaq[:m].amax(dim=0),
        "mean_prob": dprob.sum(dim=0) / before.sum(dim=0).clamp(min=1),
        "first_prob": (prob_p[0] - prob_r[0]).abs(),
        "first_plaq": (plaq_p[0] - plaq_r[0]).abs(),
        "first_charge": (chg_p[0] != chg_r[0]).float(),
        "first_tie": (u[0] - prob_r[0]).abs(),
        "first_flip": differ[0].float(),
        "flip_at": flip_at.float(),
        "links_out": lattice.wrap(links_p - links_r).flatten(1).abs()
                            .amax(dim=1),
    }


def chain_numbers(s: Dict[str, torch.Tensor], limits: Dict[str, float]
                  ) -> Dict[str, float]:
    """The call's numbers from :func:`chain_summary`:

    - ``first_unexplained``: chains whose accept decision in the first
      transition differs, not at a near-tie (exact: limit 0);
    - ``first_prob_gap``: the largest accept-probability gap there;
    - ``first_plaq_gap``: the largest plaquette gap there, over chains
      whose decision agrees;
    - ``early_prob_gap``: the 99th percentile over chains of each chain's
      largest accept-probability gap in its first ``EARLY`` transitions,
      up to and with its first differing decision;
    - ``bulk_link_gap``: the 90th percentile over chains of the links-out
      gap.
    """
    flip = s["first_flip"] > 0
    agree = ~flip
    plaq = s["first_plaq"][agree]
    return {
        "first_unexplained": float(
            (flip & (s["first_tie"] > limits["first_prob_gap"])).sum()),
        "first_prob_gap": float(s["first_prob"].max()),
        "first_plaq_gap": float(plaq.max()) if plaq.numel() else math.inf,
        "early_prob_gap": float(torch.quantile(s["early_prob"],
                                               EARLY_QUANTILE)),
        "bulk_link_gap": float(torch.quantile(s["links_out"],
                                              BULK_QUANTILE)),
    }


def worst(readings) -> Dict[str, float]:
    """The largest of each number over several checked answers."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def with_limits(values: Dict[str, float], limits: Dict[str, float]
                ) -> Numbers:
    """``{name: (value, limit)}`` of the numbers the cell's limits name,
    in their order (a cell compares only numbers whose control separates
    its readings); a limit for a number not computed raises."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"no number {sorted(missing)}")
    return {k: (values[k], limits[k]) for k in limits}


def correct(numbers: Numbers) -> bool:
    """Every number finite and within its limit; nothing judged is not
    correct."""
    return bool(numbers) and all(math.isfinite(v) and v <= lim
                                 for v, lim in numbers.values())
