"""Checkpoints of the port (counterpart of convasr_tpu/train/checkpoints.py).

The port's own format is one file written by torch.save:
{'model_state_dict': ..., 'args': {...}}. A flattened `.npz` of a JAX
package's flax trees ('params/block0/conv0/conv/kernel', ...) loads too,
converted by models/convert.py. Reading orbax directories and reference
convasr `.pt` checkpoints waits for a later slice.
"""
import typing

import torch

from ..models.convert import from_jax_npz


def save_checkpoint(path: str, model: torch.nn.Module, args: typing.Optional[dict] = None):
    torch.save(dict(model_state_dict=model.state_dict(), args=dict(args or {})), path)
    return path


def load_any_checkpoint(path: str):
    """Returns (state_dict or {} when the file holds no weights, ckpt_args)."""
    if path.endswith('.npz'):
        return from_jax_npz(path), {}
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    return ckpt.get('model_state_dict') or {}, dict(ckpt.get('args') or {})
