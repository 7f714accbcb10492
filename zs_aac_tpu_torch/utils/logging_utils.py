"""Training utilities: meters, loggers, seeding, metric logging.

The port's copy of the JAX package's ``utils/logging_utils.py`` (the
reference ``retrieval/tools/utils.py``):
``AverageMeter`` (:21), loguru-style console+file ``set_logger`` (:42),
``setup_seed`` (:57), and ``log_results`` (:140) which prints/wandb-logs
retrieval recalls. loguru/wandb are not in this environment; stdlib logging
reproduces the format, and wandb calls are gated on importability.
"""

from __future__ import annotations

import logging
import os
import random
import sys
from typing import Dict, Optional

import numpy as np

__all__ = ["AverageMeter", "set_logger", "rank_logger", "setup_seed", "log_results",
           "maybe_wandb"]


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def set_logger(exp_name: str, log_dir: str = "outputs") -> logging.Logger:
    """Console + file logger, loguru-ish format."""
    folder = os.path.join(log_dir, exp_name, "logging")
    os.makedirs(folder, exist_ok=True)
    logger = logging.getLogger(exp_name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
    for h in (logging.StreamHandler(sys.stdout),
              logging.FileHandler(os.path.join(folder, "output.log"))):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def rank_logger(exp_name: str, log_dir: str = "outputs") -> logging.Logger:
    """``set_logger`` on the main process; on the other ranks of a
    multi-GPU run a logger that writes nothing."""
    from zs_aac_tpu_torch.parallel.mesh import is_main_process, process_index

    if is_main_process():
        return set_logger(exp_name, log_dir)
    logger = logging.getLogger(f"{exp_name}.rank{process_index()}")
    logger.handlers.clear()
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def setup_seed(seed: int) -> None:
    """Seed the host-side generators (tools/utils.py:57-66) and torch's."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def maybe_wandb():
    try:
        import wandb  # noqa: F401

        return wandb
    except ImportError:
        return None


def log_results(logger, metrics: Dict[str, float], dataset: str, direction: str,
                epoch: Optional[int] = None, wandb_run=None) -> None:
    """Console (+ optional wandb) retrieval-metric logging
    (tools/utils.py:140-161)."""
    msg = (
        f"{dataset} {direction}: r1: {metrics['r1']:.2f}, r5: {metrics['r5']:.2f}, "
        f"r10: {metrics['r10']:.2f}, r50: {metrics['r50']:.2f}, "
        f"medr: {metrics['medr']:.2f}, meanr: {metrics['meanr']:.2f}, "
        f"mAP10: {metrics['mAP10']:.2f}"
    )
    logger.info(msg)
    if wandb_run is not None:
        wandb_run.log({f"{dataset}/{direction}/{k}": v for k, v in metrics.items()},
                      step=epoch)
