"""CSV and optional wandb metric logging (port of
ssl_audio_tpu/utils/logging_utils.py), with the reference's CSV line format
('epoch,{e},step,{s},loss,{l}', main.py:158-167)."""
from __future__ import annotations

import logging
import os
from typing import Optional


def make_csv_logger(log_dir: str, name: str = "log.csv") -> logging.Logger:
    """A logger that appends each message as a line of log_dir/name."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"ssl_audio_tpu_torch.{log_dir}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.FileHandler(os.path.join(log_dir, name), mode="a"))
    return logger


class WandbRun:
    """Thin optional wandb wrapper; does nothing when wandb is missing or
    its run does not start."""

    def __init__(self, project: str, config=None, name: Optional[str] = None):
        self._run = None
        try:
            import wandb
        except ImportError:
            return
        try:
            self._run = wandb.init(project=project, config=config, name=name)
        except Exception as e:  # a run that cannot start must not stop training
            print(f"wandb disabled: {e!r}")

    def log(self, metrics: dict):
        if self._run is not None:
            self._run.log(metrics)

    def finish(self):
        if self._run is not None:
            self._run.finish()
