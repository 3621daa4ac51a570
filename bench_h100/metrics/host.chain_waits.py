"""Times per chain-wrapper call that the host waits for the card, in
waits/call: the program's ``host.waits`` counter over its ``chain.call``
spans (``l2hmc_tpu_torch/utils/trace.py``, recorded while the window is
traced).  ``None`` where no ``chain.call`` was recorded."""


def value(summary):
    calls = sum(v["count"] for p, v in summary["spans"].items()
                if p.split("/")[-1] == "chain.call")
    if calls == 0:
        return None
    return summary["counters"].get("host.waits", 0) / calls


def read(r):
    try:
        from l2hmc_tpu_torch.utils import trace
    except ImportError:
        return None
    return value(trace.summary())
