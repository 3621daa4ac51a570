"""Times per eval transition that the host waits for the card, in
waits/transition: the program's ``host.waits`` counter over its
``eval.transition`` spans (recorded while the window is traced).  ``None``
where no ``eval.transition`` was recorded."""

SPAN = "eval.transition"


def value(summary):
    n = sum(v["count"] for p, v in summary["spans"].items()
            if p.split("/")[-1] == SPAN)
    if n == 0:
        return None
    return summary["counters"].get("host.waits", 0) / n


def read(r):
    try:
        from l2hmc_tpu_torch.utils import trace
    except ImportError:
        return None
    return value(trace.summary())
