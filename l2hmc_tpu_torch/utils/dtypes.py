"""Float-precision switch (port of ``l2hmc_tpu/utils/dtypes.py``).

The reference's global dtype switch (``utils/config.py:26-27``: ``TF_FLOAT
= tf.float32 / NP_FLOAT = np.float32``, flipped to float64 by editing the
file) as the ``L2HMC_FLOAT`` environment variable, read once at import:
"float32" (the default) or "float64" / "f64" / "double".

Usage::

    from l2hmc_tpu_torch.utils.dtypes import FLOAT, NP_FLOAT
    x = torch.zeros(n, dtype=FLOAT)

Everything in the port defaults to float32, the card's fast type (the
kernels in ``ops/csrc/`` are float32 only), so float64 is a debugging mode
for the plain torch paths (e.g. tightening the reversibility and
log-Jacobian property tests), not a production path.  Nothing in the port
reads it by itself: :func:`set_default_dtype` makes it torch's default.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _from_env() -> str:
    name = os.environ.get("L2HMC_FLOAT", "float32").lower()
    if name in ("float64", "f64", "double"):
        return "float64"
    if name in ("float32", "f32", "single", ""):
        return "float32"
    raise ValueError(f"L2HMC_FLOAT={name!r}: expected float32 or float64")


_NAME = _from_env()

#: numpy dtype used for host-side buffers (reference ``NP_FLOAT``).
NP_FLOAT = np.dtype(_NAME)

#: torch dtype used for device tensors (reference ``TF_FLOAT``).
FLOAT = getattr(torch, _NAME)


def set_default_dtype() -> None:
    """Make :data:`FLOAT` torch's default floating dtype (JAX's
    ``enable_x64`` counterpart: new float tensors follow the switch)."""
    torch.set_default_dtype(FLOAT)
