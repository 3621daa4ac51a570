"""Build and load the port's hand-written CUDA kernels.

At first use :func:`library` compiles every ``csrc/*.cu`` into an object,
one ``nvcc`` process per source, all started together::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o

links them into one shared library with a plain C interface
(``nvcc -shared``), and loads it with ``ctypes``.  The output directory is
keyed by a hash of the sources and flags, lives under the repository's
``build/`` (listed in ``.gitignore``), and is reused by later processes;
``ptxas.log`` there holds each kernel's registers, shared memory and
spills.  Only sources in this repository and the CUDA toolkit's own headers
(curand's Philox) are used.

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
LIB_NAME = "libl2hmc_kernels.so"
PTXAS_LOG = "ptxas.log"

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
    "l2hmc_local_chain_smem_bytes": (ctypes.c_size_t, [_I, _I, _I, _I]),
    "l2hmc_local_chain_launch": (_I, [
        _P, _P,                      # x0, x1 (B, d), updated in place
        _P, _P, _P,                  # flat net weights, mask0, mask1 (K, d)
        _P, _P, _P, _P, _P, _P,      # v0s, v1s, ds, us, nus, uhs (or null)
        _P, _P, _P,                  # plaq, chg, prob traces (N, B)
        _I, _I, _I, _I, _I, _I, _I,  # B, lt, lx, K, N, channels, layers
        _F, _F, _I, _I, _U64,        # eps, beta, bounded_q, hop, seed
        _I, _P,                      # device, stream
    ]),
    "wilson_fwd_launch": (_I, [
        _P, _P, _P,                  # links (B, Lt, Lx, 2); action (B,), sinp
        _I, _I, _I, _I, _P,          # B, lt, lx, device, stream
    ]),
    "wilson_bwd_launch": (_I, [
        _P, _P, _P,                  # sinp (B, Lt, Lx), g (B,); force
        _I, _I, _I, _I, _P,          # B, lt, lx, device, stream
    ]),
    "wilson_bwd_bwd_launch": (_I, [
        _P, _P, _P,                  # links, g (B,), w (B, Lt, Lx, 2)
        _P, _P,                      # dlinks (B, Lt, Lx, 2), dg (B,)
        _I, _I, _I, _I, _P,          # B, lt, lx, device, stream
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


def _run_failed(cmd, proc_out, code):
    out, err = proc_out
    return RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}\n{err}")


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
    nvcc = _nvcc()
    pid = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    # wait for every compiler before raising, so none is left running
    results = [(src, obj, cmd, p.communicate(), p.returncode)
               for src, obj, cmd, p in jobs]
    for _, _, cmd, out, code in results:
        if code != 0:
            raise _run_failed(cmd, out, code)
    log = "".join(f"== {src.name}\n{out[1]}" for src, _, _, out, _ in results)
    (out_dir / PTXAS_LOG).write_text(log)
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
           *[str(obj) for _, obj, _, _, _ in results]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise _run_failed(cmd, (proc.stdout, proc.stderr), proc.returncode)
    for _, obj, _, _, _ in results:
        obj.unlink()
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return lib, time.perf_counter() - t0


def ptxas_report(lib: Path) -> list[str]:
    """ptxas's per-kernel lines (registers, spills, shared memory) from the
    build of ``lib``."""
    log = lib.parent / PTXAS_LOG
    if not log.exists():
        return []
    keep = ("Compiling entry", "registers", "spill")
    return [ln.strip() for ln in log.read_text().splitlines()
            if any(k in ln for k in keep)]


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
