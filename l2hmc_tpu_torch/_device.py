"""Where the port's entry points put what they create.

Functions that create tensors from nothing (fresh parameters, link fields,
train states) take ``device=None`` to mean this process's CUDA device: the
port runs on the card unless the caller asks for the CPU.  Functions that
take tensors follow their inputs' device instead.

Under a launcher (``torchrun`` sets ``LOCAL_RANK``) or in an initialized
process group, each process's card is ``cuda:<local rank>``; alone, it is
``cuda:0``.
"""

from __future__ import annotations

import os

import torch


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` when a launcher set
    it, else the global rank modulo the host's cards in an initialized
    process group, else 0."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() % max(torch.cuda.device_count(), 1)
    return 0


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda:<local rank>``
    (:func:`local_rank`: ``cuda:0`` in a process of its own).

    Raises when ``None`` is given and no CUDA device is present: the port
    never falls back to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda", local_rank())


def float32_matmuls(tf32: bool = False) -> None:
    """The port's one float32 rule, which every entry point applies first:
    matmuls and cuDNN convolutions in full float32 (TF32 off), as the CPU
    and the JAX package compute them.  TF32 rounds the operands to 10-bit
    mantissas, and the training amplifies that rounding: one card with TF32
    on parts from itself with it off by step 8 of the canonical 8x8 run.
    ``tf32=True`` turns TF32 on, for a run that compares the two."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
