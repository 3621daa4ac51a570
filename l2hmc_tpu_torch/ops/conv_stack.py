"""The conv conditioner's periodic conv stacks (``networks/nets.py``
``ConvNet``) on the no-grad path, both input slots in one launch of
``csrc/conv_stack.cu``.

Each slot is a flat input ``(B, cin d)`` (``cin / 2`` blocks of ``(lt, lx,
2)``: the position's cos/sin features, ``cin = 4``, or one per-link field,
``cin = 2``) through ``relu(conv3x3_periodic(image, w1) + b1)`` of 8
filters, then ``relu(conv2x2_stride2(., w2) + b2)`` of 16, flattened in
NCHW order to ``(B, 16 (lt/2)(lx/2))``: what ``ConvNet._stack`` computes
with ``to_image``, circular pads and ``F.conv2d``.

- :func:`conv_stack_reference`, the plain version: the same function in
  other torch ops (the 3x3 conv as a sum of rolled taps, the stride-2 conv
  over the 2x2 blocks).
- :func:`conv_stack`: the kernel for CUDA tensors (it raises on what the
  kernel does not take), the plain version for CPU ones; each launch adds
  one to ``conv_stack.launches``.  It launches on the current stream and
  never waits for the card.
- :func:`takes`: the shapes the kernel computes.
"""

from __future__ import annotations

import torch

from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.leapfrog import check_cuda_input
from l2hmc_tpu_torch.ops.wilson import _aligned

FILTERS = 8                  # conv 1's filters; conv 2 has twice as many
KERNEL_SIDES = (3, 2)        # conv 1's kernel side; conv 2's, at stride 2
CHANNELS = (2, 4)
MAX_POSITIONS = 256          # (lt/2)(lx/2): one thread each in a CTA


def takes(lt: int, lx: int, k1: int, k2: int, filters: int,
          channels) -> bool:
    """Whether the kernel computes the stacks of a ``lt x lx`` lattice with
    kernel sides ``k1``, ``k2`` (stride 2), ``filters`` first-conv filters
    and the slots' ``channels``: even sides with ``(lt/2)(lx/2)`` at most
    256 (up to 32x32), 3 then 2, 8 filters, 2 or 4 channels a slot."""
    return ((k1, k2) == KERNEL_SIDES and filters == FILTERS
            and all(c in CHANNELS for c in channels)
            and lt >= 2 and lx >= 2 and lt % 2 == 0 and lx % 2 == 0
            and (lt // 2) * (lx // 2) <= MAX_POSITIONS)


def conv_stack_reference(flat, w1, b1, w2, b2, lt: int, lx: int):
    """One slot's stack in plain torch: ``flat (B, cin d)``, ``w1 (8, cin,
    3, 3)``, ``b1 (8,)``, ``w2 (16, 8, 2, 2)``, ``b2 (16,)`` -> ``(B, 16
    (lt/2)(lx/2))``.  Channel ``2 n + dir`` is element ``(n d + site) 2 +
    dir``; tap ``(i, j)`` of the 3x3 conv reads site ``(t + i - 1, x + j -
    1)`` wrapped; tap ``(i, j)`` of the 2x2 conv site ``(2T + i, 2X +
    j)``."""
    b = flat.shape[0]
    cin = flat.shape[1] // (lt * lx)
    img = flat.reshape(b, cin // 2, lt, lx, 2).permute(0, 1, 4, 2, 3)
    img = img.reshape(b, cin, lt, lx)
    taps = torch.stack([torch.roll(img, (1 - i, 1 - j), (2, 3))
                        for i in range(3) for j in range(3)], dim=2)
    y = torch.einsum("bcktx,fck->bftx", taps,
                     w1.reshape(w1.shape[0], cin, 9))
    y = torch.relu(y + b1[:, None, None])
    blocks = y.reshape(b, w1.shape[0], lt // 2, 2, lx // 2, 2)
    z = torch.einsum("bfTiXj,gfij->bgTX", blocks, w2)
    return torch.relu(z + b2[:, None, None]).reshape(b, -1)


def conv_stack(slots, lt: int, lx: int):
    """Both slots' stacks, ``slots = ((flat, w1, b1, w2, b2), (flat, w1,
    b1, w2, b2))`` with the shapes of :func:`conv_stack_reference`; returns
    the two outputs.  CUDA tensors: one launch of ``csrc/conv_stack.cu``;
    CPU tensors: :func:`conv_stack_reference` per slot."""
    if len(slots) != 2:
        raise ValueError(f"conv_stack: expected 2 slots, got {len(slots)}")
    if not slots[0][0].is_cuda:
        return tuple(conv_stack_reference(*s, lt, lx) for s in slots)
    d = lt * lx
    b = slots[0][0].shape[0]
    cins = [s[0].shape[-1] // d if s[0].dim() == 2 else 0 for s in slots]
    if not takes(lt, lx, 3, 2, FILTERS, cins):
        raise ValueError(f"conv_stack: the kernel does not take a {lt}x{lx} "
                         f"lattice with {cins} channels")
    dev = slots[0][0].device
    args, outs, held = [], [], []    # held: the inputs until the launch
    for (flat, w1, b1, w2, b2), cin in zip(slots, cins):
        check_cuda_input("flat", flat, (b, cin * d))
        check_cuda_input("w1", w1, (FILTERS, cin, 3, 3))
        check_cuda_input("b1", b1, (FILTERS,))
        check_cuda_input("w2", w2, (2 * FILTERS, FILTERS, 2, 2))
        check_cuda_input("b2", b2, (2 * FILTERS,))
        if any(t.device != dev for t in (flat, w1, b1, w2, b2)):
            raise ValueError("conv_stack: every tensor on one device")
        flat = _aligned(flat)
        held.append(flat)
        out = torch.empty((b, 2 * FILTERS * d // 4), dtype=torch.float32,
                          device=dev)
        args += [flat.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), out.data_ptr(), cin]
        outs.append(out)
    conv_stack.launches += 1
    _cuda.check(_cuda.library().conv_stack_launch(
        *args, b, lt, lx, dev.index or 0, _cuda.stream_handle(dev)),
        "conv_stack_launch")
    return tuple(outs)


conv_stack.launches = 0
