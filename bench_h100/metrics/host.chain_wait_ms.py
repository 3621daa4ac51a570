"""Milliseconds per chain-wrapper call that the host waits for the card, in
ms: the seconds of the ``sync`` spans inside the program's ``chain.call``
spans (``l2hmc_tpu_torch/utils/trace.py``, recorded while the window is
traced), over the calls.  ``None`` where no ``chain.call`` was recorded
(a program without the recorder, or no call on the card)."""


def value(summary):
    spans = summary["spans"]
    calls = sum(v["count"] for p, v in spans.items()
                if p.split("/")[-1] == "chain.call")
    if calls == 0:
        return None
    wait_s = sum(v["total_s"] for p, v in spans.items()
                 if p.split("/")[-1] == "sync"
                 and "chain.call" in p.split("/")[:-1])
    return 1e3 * wait_s / calls


def read(r):
    try:
        from l2hmc_tpu_torch.utils import trace
    except ImportError:
        return None
    return value(trace.summary())
