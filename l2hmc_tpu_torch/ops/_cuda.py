"""Build and load the port's hand-written CUDA kernels.

At first use :func:`library` compiles every ``csrc/*.cu`` into one shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<hash>/libl2hmc_kernels.so csrc/*.cu

and loads it with ``ctypes``.  The output directory is keyed by a hash of the
sources and flags, lives under the repository's ``build/`` (listed in
``.gitignore``), and is reused by later processes.  Only sources in this
repository and the CUDA toolkit's own headers (curand's Philox) are used.

Every C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on a non-zero code.  Pointers and the stream are ``c_void_p`` so
ctypes never truncates them to 32 bits.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libl2hmc_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong

# name -> (restype, argtypes); the C prototypes are in csrc/*.cu
_SIGNATURES = {
    "smem_optin_bytes": (_I, [_I]),
    "hmc_chain_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "hmc_chain_launch": (_I, [
        _P, _P,                      # x0, x1 (B, d), updated in place
        _P, _P, _P, _P, _P,          # v0s, v1s, us, nus, uhs (or null)
        _P, _P, _P,                  # plaq, chg, prob traces (N, B)
        _I, _I, _I, _I, _I,          # B, lt, lx, K, N
        _F, _F, _I, _U64,            # eps, beta, hop, seed
        _I, _P,                      # device, stream
    ]),
    "l2hmc_chain_smem_bytes": (ctypes.c_size_t, [_I, _I, _I]),
    "l2hmc_chain_launch": (_I, [
        _P, _P,                      # x0, x1 (B, d), updated in place
        _P,                          # host array of 26 weight pointers
        _P, _P, _P, _P, _P, _P,      # v0s, v1s, ds, us, nus, uhs (or null)
        _P, _P, _P,                  # plaq, chg, prob traces (N, B)
        _I, _I, _I, _I, _I, _I,      # B, lt, lx, K, N, hidden
        _F, _F, _I, _I, _U64,        # eps, beta, bounded_q, hop, seed
        _I, _P,                      # device, stream
    ]),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> tuple[Path, float]:
    """Compile the kernels if needed; returns ``(library path, seconds)``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (C NULL) for ``t is None``."""
    return None if t is None else t.data_ptr()


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
