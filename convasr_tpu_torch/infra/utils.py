"""Small host-side utilities (counterpart of convasr_tpu/infra/utils.py)."""
import gzip


def flatten(nested):
    """Flatten one level of nesting."""
    return [item for sub in nested for item in sub]


def open_maybe_gz(path, mode='rt'):
    return gzip.open(path, mode) if str(path).endswith('.gz') else open(path, mode)
