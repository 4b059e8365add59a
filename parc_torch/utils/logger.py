"""Key-value training logger with tabular console output and TSV persistence.

Reference parity: util/logger.py:8-183 (+ tb_logger / wandb_logger
integration points). Values may be 0-d tensors: each is read to the host
once, when it is logged.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional


class Logger:
    def __init__(self, output_file: Optional[str] = None,
                 use_wandb: bool = False, project: str = "parc_torch",
                 run_name: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 step_key: str = "Samples"):
        self._row = OrderedDict()
        self._quiet = set()
        self._output_file = output_file
        self._wrote_header = False
        self._wandb = None
        self._step_key = step_key  # reference: wandb_logger step key
        self._tb = None
        if tensorboard_dir:
            # optional sinks: a missing package or a failing service
            # turns the sink off, never the training run
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                self._tb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project, name=run_name)
            except Exception:
                self._wandb = None
        if output_file:
            os.makedirs(os.path.dirname(os.path.abspath(output_file)),
                        exist_ok=True)

    def log(self, key: str, value, quiet: bool = False):
        try:
            value = float(value)
        except (TypeError, ValueError):
            pass
        self._row[key] = value
        if quiet:
            self._quiet.add(key)

    def print_log(self):
        width = max((len(k) for k in self._row), default=10) + 2
        lines = []
        for k, v in self._row.items():
            if k in self._quiet:
                continue
            sval = f"{v:.5g}" if isinstance(v, float) else str(v)
            lines.append(f"| {k:<{width}}| {sval:<14}|")
        bar = "-" * (width + 19)
        print(bar, *lines, bar, sep="\n", flush=True)

    def write_log(self):
        if self._output_file:
            keys = list(self._row.keys())
            mode = "a" if self._wrote_header else "w"
            with open(self._output_file, mode) as f:
                if not self._wrote_header:
                    f.write("\t".join(keys) + "\n")
                    self._wrote_header = True
                f.write("\t".join(str(self._row.get(k, "")) for k in keys)
                        + "\n")
        if self._wandb is not None:
            step = self._row.get("Samples")
            self._wandb.log(dict(self._row),
                            step=int(step) if step else None)

    def end_iter(self):
        self.print_log()
        self.write_log()
        if self._tb is not None:
            step = int(self._row.get(self._step_key, 0))
            for k, v in self._row.items():
                if k != self._step_key:
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(dict(self._row))
        self._row.clear()
