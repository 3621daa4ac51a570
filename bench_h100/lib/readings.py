"""What a per-layer reader (``metrics/<name>.py``, ``read(r)``) is handed,
and the arithmetic that several readers share.  A reader that finds
nothing to read returns ``None``, and the run leaves its metric out."""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Optional

from bench_h100.lib import common
from bench_h100.lib.trace import Trace


@dataclass
class Reading:
    trace: Trace            # the traced window
    config: dict            # configs/<config>.json
    config_name: str
    work: dict              # the driver's counts: kernel, shapes, transitions
    window_s: float         # the measured window, host clock

    @property
    def counts(self):
        return common.load_module("counts", self.config_name)

    @property
    def peaks(self) -> dict:
        return json.loads((common.BENCH / "peaks.json").read_text())


def kernel_matcher(kernel: str):
    """Matches the device symbol of the kernel ``<kernel>_kernel``,
    demangled or mangled (its length before it), and no kernel whose name
    merely ends the same (``hmc_chain_kernel`` is not
    ``l2hmc_chain_kernel``)."""
    sym = kernel + "_kernel"
    pat = re.compile(r"(^|[^A-Za-z0-9_])" + re.escape(sym) + r"\b|"
                     + str(len(sym)) + re.escape(sym))
    return lambda name: bool(pat.search(name))


def roofline(r: Reading, kernel: str) -> Optional[float]:
    """``<kernel>``'s share of its roofline, in %: its launches in the
    window times the least time of one call (the largest of its matrix
    work at the matrix peak, its other operations at the float32 peak and
    its bytes at the memory peak), over its device time."""
    if r.work.get("kernel") != kernel:
        return None
    sec, launches = r.trace.seconds_of(kernel_matcher(kernel))
    if sec <= 0 or launches == 0:
        return None
    p = r.peaks
    w = r.counts.call_work(r.config, r.work)
    least = max(w.matrix_flops / p["matrix_flops_per_s"],
                w.other_ops / p["float32_flops_per_s"],
                w.bytes / p["hbm_bytes_per_s"])
    return 100.0 * launches * least / sec


def bound_by(r: Reading) -> str:
    """Which of the three terms sets the least time of the cell's kernel."""
    p = r.peaks
    w = r.counts.call_work(r.config, r.work)
    terms = {"matrix": w.matrix_flops / p["matrix_flops_per_s"],
             "operations": w.other_ops / p["float32_flops_per_s"],
             "bytes": w.bytes / p["hbm_bytes_per_s"]}
    return max(terms, key=terms.get)
