"""Small host-side utilities (counterpart of convasr_tpu/infra/utils.py)."""
import gzip
import logging
import logging.handlers
import os
import random

import numpy as np
import torch


def flatten(nested):
    """Flatten one level of nesting."""
    return [item for sub in nested for item in sub]


def open_maybe_gz(path, mode='rt'):
    return gzip.open(path, mode) if str(path).endswith('.gz') else open(path, mode)


def set_random_seed(seed: int, device=None) -> torch.Generator:
    """Seed python, numpy and torch (spec: the reference utils.py:113-117) and
    return a generator on `device` (CPU by default) seeded from `seed`: the
    source of the train step's dropout masks and dither, which the caller
    passes down and saves in checkpoints."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return torch.Generator(device=device or 'cpu').manual_seed(seed)


def setup_logging(log_file_path=None, mode='a', level=logging.INFO, rank=0):
    """Root logger + optional rotating file sink (spec: utils.py:34-51)."""
    logging.basicConfig(level=level, format='%(asctime)s [%(levelname)s] %(name)s: %(message)s')
    logger = logging.getLogger()
    logger.setLevel(level if rank == 0 else logging.WARNING)
    if log_file_path:
        os.makedirs(os.path.dirname(log_file_path) or '.', exist_ok=True)
        handler = logging.handlers.RotatingFileHandler(
            log_file_path, mode=mode, maxBytes=100 * 1024 * 1024, backupCount=5)
        handler.setFormatter(logging.Formatter('%(asctime)s [%(levelname)s] %(name)s: %(message)s'))
        logger.addHandler(handler)
    return logger
