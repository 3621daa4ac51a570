"""Share of its roofline of the conv stacks' kernel (``networks/nets.py
ConvNet`` -> ``ops/conv_stack.py`` -> ``csrc/conv_stack.cu``,
``conv_stack_kernel``), in %: the launches in the traced window times the
least time of one (both slots of one conditioner call over all the cell's
chains; ``counts/conv_stack.py``) over their device time.  ``None`` where
no such launch was traced (a program whose stacks run eagerly)."""

from bench_h100.lib import common
from bench_h100.lib.readings import kernel_matcher


def read(r):
    if r.work.get("kernel") != "eval_chunk":
        return None
    sec, launches = r.trace.seconds_of(kernel_matcher("conv_stack"))
    if sec <= 0 or launches == 0:
        return None
    lt, lx = r.config["lattice"]
    least = common.load_module("counts", "conv_stack").least_seconds(
        r.work["chains"], lt * lx, r.config["sampler"], r.peaks)
    return 100.0 * launches * least / sec
