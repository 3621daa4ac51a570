"""Argfile-aware argument parsing (port of ``l2hmc_tpu/utils/flags.py``).

``@argfile`` indirection with shell-style quoting and ``#`` comments, so
argument files compose with regular flags and with each other::

    python -m l2hmc_tpu_torch.cli.train_gauge @configs/gauge_8x8.txt --train_steps 100

Argfile format: one or more tokens per line (``--flag value`` or the flag
and value on separate lines both work), blank lines and ``#`` comments
ignored.
"""

from __future__ import annotations

import argparse
import shlex


class ArgfileParser(argparse.ArgumentParser):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("fromfile_prefix_chars", "@")
        kwargs.setdefault(
            "formatter_class", argparse.ArgumentDefaultsHelpFormatter
        )
        super().__init__(*args, **kwargs)

    def convert_arg_line_to_args(self, arg_line: str):
        return shlex.split(arg_line, comments=True)
