"""Where the port's entry points put what they create.

Functions that create tensors from nothing (fresh parameters, link fields,
train states) take ``device=None`` to mean the first CUDA device: the port
runs on the card unless the caller asks for the CPU.  Functions that take
tensors follow their inputs' device instead.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda:0``.

    Raises when ``None`` is given and no CUDA device is present: the port
    never falls back to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)
