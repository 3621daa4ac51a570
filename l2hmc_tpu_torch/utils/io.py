"""Run-dir management, logging and metrics persistence (port of
``l2hmc_tpu/utils/io.py``).

Run dirs are ``<base>/run_<n>``; metrics go to ``metrics.jsonl`` (one
record per logged step), the run's flags to ``params.json``.  In a
``torch.distributed`` process group only global rank 0 (the primary) writes
and logs; the others compute the same run dir and stay silent.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def is_primary() -> bool:
    """``True`` on global rank 0 of an initialized process group, and when
    there is no group (the reference's ``jax.process_index() == 0``)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or (
        dist.get_rank() == 0)


def install_sigterm_handler():
    """Turn SIGTERM into KeyboardInterrupt, so a run killed by ``timeout``
    falls through to the trainer's save-on-interrupt path."""
    import signal

    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)


def log(*args, **kwargs):
    """Print and flush."""
    if is_primary():
        print(*args, **kwargs)
        sys.stdout.flush()


def make_run_dir(base: str | Path, prefix: str = "run") -> Path:
    """Create the next numbered run dir ``<base>/<prefix>_<n>``.  In a
    process group the primary picks and creates it and every rank gets its
    path (a collective: every rank calls it)."""
    import torch.distributed as dist

    base = Path(base)
    run_dir = None
    if is_primary():
        base.mkdir(parents=True, exist_ok=True)
        existing = [
            int(p.name.split("_")[-1])
            for p in base.glob(f"{prefix}_*")
            if p.name.split("_")[-1].isdigit()
        ]
        run_dir = base / f"{prefix}_{max(existing, default=0) + 1}"
        run_dir.mkdir(parents=True, exist_ok=True)
    if dist.is_available() and dist.is_initialized():
        box = [str(run_dir) if run_dir is not None else None]
        dist.broadcast_object_list(box, src=0)
        run_dir = Path(box[0])
    return run_dir


def latest_run_dir(base: str | Path, prefix: str = "run") -> Path:
    """Highest-numbered existing run dir under ``base``."""
    base = Path(base)
    existing = [
        (int(p.name.split("_")[-1]), p)
        for p in base.glob(f"{prefix}_*")
        if p.name.split("_")[-1].isdigit()
    ]
    if not existing:
        raise FileNotFoundError(f"no {prefix}_* dirs under {base}")
    return max(existing)[1]


def save_params_json(run_dir: str | Path, params: dict):
    """Write the run configuration to ``params.json``."""
    if is_primary():
        (Path(run_dir) / "params.json").write_text(
            json.dumps(params, indent=2, default=str))


class MetricsLogger:
    """Tabular console + JSONL metrics writer: prints the training table
    (step, t/step, loss, accept, eps, beta, actions, plaqs, exact plaq, dQ,
    lr) and appends every record to ``metrics.jsonl``.  ``tensorboard``
    also writes scalars through ``tensorboardX`` (imported only then)."""

    COLUMNS = [
        ("step", "{:>7d}"),
        ("dt", "{:>8.3f}"),
        ("loss", "{:>12.4g}"),
        ("accept_prob", "{:>7.4f}"),
        ("eps", "{:>7.4f}"),
        ("beta", "{:>7.4f}"),
        ("actions", "{:>10.4g}"),
        ("plaqs", "{:>8.5f}"),
        ("plaq_exact", "{:>8.5f}"),
        ("dq", "{:>7.4f}"),
        ("lr", "{:>9.3g}"),
    ]

    def __init__(
        self,
        run_dir: Optional[str | Path] = None,
        print_every: int = 1,
        tensorboard: bool = False,
    ):
        self.run_dir = Path(run_dir) if run_dir else None
        self.print_every = print_every
        self._n = 0
        self._file = None
        self._tb = None
        if self.run_dir and is_primary():
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._file = open(self.run_dir / "metrics.jsonl", "a")
            if tensorboard:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(str(self.run_dir / "tb"))
        self._header_printed = False

    def header(self):
        names = [name for name, _ in self.COLUMNS]
        line = " ".join(
            f"{n:>{len(fmt.format(0)) if 'd' in fmt else 8}}"
            for n, fmt in zip(names, (f for _, f in self.COLUMNS)))
        log(line)
        log("-" * len(line))

    def write(self, record: Dict):
        """Record one logged step (floats/ints only)."""
        rec = {
            k: (float(v) if isinstance(
                v, (np.floating, float, torch.Tensor, np.ndarray)) else v)
            for k, v in record.items()
        }
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._tb is not None and "step" in rec:
            for k, v in rec.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, int(rec["step"]))
        if self._n % self.print_every == 0:
            if not self._header_printed:
                self.header()
                self._header_printed = True
            parts = []
            for name, fmt in self.COLUMNS:
                if name in rec:
                    try:
                        parts.append(fmt.format(
                            rec[name] if "d" not in fmt else int(rec[name])))
                    except (ValueError, TypeError):
                        parts.append(str(rec[name]))
            log(" ".join(parts))
        self._n += 1

    def write_summaries(self, step: int, tree, prefix: str = "params"):
        """Per-variable mean/std/min/max (:func:`variable_summaries`) as
        one ``metrics.jsonl`` record, and with TensorBoard as scalars and
        histograms."""
        stats = variable_summaries(tree, prefix)
        if self._file is not None:
            self._file.write(json.dumps({"step": int(step), **stats}) + "\n")
            self._file.flush()
        if self._tb is not None:
            for k, v in stats.items():
                self._tb.add_scalar(k, v, int(step))
            for name, leaf in _named_arrays(tree).items():
                self._tb.add_histogram(f"{prefix}/{name}", leaf.ravel(),
                                       int(step))

    def close(self):
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


def _named_arrays(tree) -> Dict[str, np.ndarray]:
    """``{path: array}`` of a parameter tree: a ``DynamicsParams`` module
    (its leaves by the reference's pytree path, ``xnet/h_layer/w``) or a
    dict of arrays or tensors."""
    if isinstance(tree, torch.nn.Module):
        from l2hmc_tpu_torch.train.gauge import named_leaves

        tree = named_leaves(tree)
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in tree.items()}


def variable_summaries(tree, prefix: str = "params") -> Dict[str, float]:
    """mean/std/min/max per leaf under ``{prefix}/{path}/{stat}``."""
    out: Dict[str, float] = {}
    for path, arr in _named_arrays(tree).items():
        name = f"{prefix}/{path}"
        out[f"{name}/mean"] = float(arr.mean())
        out[f"{name}/stddev"] = float(arr.std())
        out[f"{name}/min"] = float(arr.min())
        out[f"{name}/max"] = float(arr.max())
    return out
