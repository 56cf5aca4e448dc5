"""Logging utilities (reference: utils/tools.py)."""

from __future__ import annotations

import logging
import os
import sys


def get_logger(log_dir: str | None, model: str) -> logging.Logger:
    """File + stdout logger, one per model name."""
    logger = logging.getLogger(f"cleverrec_tpu_torch.{model}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s  %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{model}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    return logger
