"""The whole sampling step's share of the card's matrix peak, in %: the
conditioner FLOPs of every chain transition of the traced window, over the
window's seconds, over the peak.  A later change that folds one kernel into
another leaves this reading in place, so it still bounds a gain."""


def read(r):
    if "sampler" not in r.config or r.work.get("kernel") == "hmc_chain":
        return None
    lt, lx = r.config["lattice"]
    flops = (r.counts.conditioner_flops_per_transition(r.config["sampler"],
                                                       lt * lx)
             * r.work["transitions"])
    if flops <= 0 or r.window_s <= 0:
        return None
    return 100.0 * flops / r.window_s / r.peaks["matrix_flops_per_s"]
