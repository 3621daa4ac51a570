"""Share of their roofline of the Wilson kernels
(``ops/wilson.py`` -> ``csrc/wilson.cu``, ``wilson_kernel<KIND, ROUTE>``),
in %: the least time of every launch in the traced window (its bytes, each
input read once and each output written once, by kind, at the memory
peak; ``counts/u1_16x16_conv.py``) over their device time.  ``None`` where
no Wilson launch was traced or a launch's kind cannot be read from its
name."""

import re

from bench_h100.lib.readings import kernel_matcher

# the KIND template argument, demangled (wilson_kernel<2, 0>) or mangled
# (13wilson_kernelILi2ELi0E)
KIND = re.compile(r"wilson_kernel(?:<\s*(\d+)\s*,|ILi(\d+)E)")


def least_seconds(kernels: dict, b: int, d: int, counts, peaks) -> tuple:
    """``(least seconds, device seconds)`` of the Wilson launches in
    ``kernels`` (name -> (seconds, launches)), or ``None`` where a kind is
    unreadable."""
    match = kernel_matcher("wilson")
    least = sec = 0.0
    for name, (s, launches) in kernels.items():
        if not match(name):
            continue
        m = KIND.search(name)
        if m is None:
            return None
        kind = int(m.group(1) or m.group(2))
        least += launches * counts.wilson_bytes(kind, b, d)
        sec += s
    return least / peaks["hbm_bytes_per_s"], sec


def read(r):
    if r.work.get("kernel") != "eval_chunk":
        return None
    lt, lx = r.config["lattice"]
    got = least_seconds(r.trace.kernels, r.work["chains"], lt * lx,
                        r.counts, r.peaks)
    if got is None or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]
