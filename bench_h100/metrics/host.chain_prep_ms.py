"""Host milliseconds per chain-wrapper call spent on other work than
waiting for the card, in ms: the seconds of the program's ``chain.call``
spans (``l2hmc_tpu_torch/utils/trace.py``, recorded while the window is
traced) less those of the ``sync`` spans inside them, over the calls:
weight packing, the kernel seed, the launch.  ``None`` where no
``chain.call`` was recorded."""


def value(summary):
    spans = summary["spans"]
    calls = sum(v["count"] for p, v in spans.items()
                if p.split("/")[-1] == "chain.call")
    if calls == 0:
        return None
    call_s = sum(v["total_s"] for p, v in spans.items()
                 if p.split("/")[-1] == "chain.call")
    wait_s = sum(v["total_s"] for p, v in spans.items()
                 if p.split("/")[-1] == "sync"
                 and "chain.call" in p.split("/")[:-1])
    return 1e3 * (call_s - wait_s) / calls


def read(r):
    try:
        from l2hmc_tpu_torch.utils import trace
    except ImportError:
        return None
    return value(trace.summary())
