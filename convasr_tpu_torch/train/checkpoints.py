"""Checkpoints of the port (counterpart of convasr_tpu/train/checkpoints.py).

The port's own format is one file written by torch.save. A model checkpoint
holds {'model_state_dict': ..., 'args': {...}}; a training checkpoint adds
the optimizer state and step, the epoch, the sampler's position, the state
of the generator that draws dropout masks and dither, so that a resumed run
continues the one it was cut from. A flattened `.npz` of a JAX package's flax
trees ('params/block0/conv0/conv/kernel', ...) loads too, converted by
models/convert.py. Reading orbax directories and reference convasr `.pt`
checkpoints waits for a later slice.
"""
import glob
import json
import os
import re
import typing

import torch

from ..models.convert import from_jax_npz

CHECKPOINT_TEMPLATE = 'checkpoint_epoch{epoch:02d}_iter{iteration:07d}'


def checkpoint_path(experiment_dir: str, epoch: int, iteration: int,
                    template: typing.Optional[str] = None) -> str:
    """template: --checkpoint-format (spec: the reference train.py:918); the
    port's checkpoints are files ending in .pt."""
    name = (template or CHECKPOINT_TEMPLATE).format(epoch=epoch, iteration=iteration)
    return os.path.join(experiment_dir, name if name.endswith('.pt') else name + '.pt')


def save_checkpoint(path: str, model: torch.nn.Module, args: typing.Optional[dict] = None):
    torch.save(dict(model_state_dict=model.state_dict(), args=dict(args or {})), path)
    return path


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def plain_args(args: dict) -> dict:
    """args as JSON-able values (what torch.load(weights_only=True) reads)."""
    return json.loads(json.dumps(args, default=str))


def save_train_checkpoint(path: str, model: torch.nn.Module, state, epoch: int = 0,
                          sampler_state: typing.Optional[dict] = None,
                          generator: typing.Optional[torch.Generator] = None,
                          args: typing.Optional[dict] = None) -> str:
    """state: train/loop.TrainState. Written to a temporary file first, so a
    checkpoint that exists is whole."""
    payload = dict(model_state_dict=model.state_dict(), opt_state=_to(state.opt_state, 'cpu'),
                   step=int(state.step), epoch=int(epoch), sampler=dict(sampler_state or {}),
                   generator_state=generator.get_state() if generator is not None else None,
                   args=plain_args(dict(args or {})))
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_train_checkpoint(path: str, device='cpu') -> dict:
    """The payload of save_train_checkpoint, optimizer state on `device`. A
    model-only checkpoint comes back with opt_state None."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    ckpt.setdefault('opt_state', None)
    ckpt['opt_state'] = _to(ckpt['opt_state'], device)
    for key, default in (('step', 0), ('epoch', 0), ('sampler', {}), ('generator_state', None),
                         ('args', {})):
        ckpt.setdefault(key, default)
    return ckpt


def load_any_checkpoint(path: str):
    """Returns (state_dict or {} when the file holds no weights, ckpt_args)."""
    if path.endswith('.npz'):
        return from_jax_npz(path), {}
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    return ckpt.get('model_state_dict') or {}, dict(ckpt.get('args') or {})


def average_checkpoints(paths: typing.List[str]) -> dict:
    """Uniform average of the models' float tensors (spec: train.py:347-353),
    summed in float64; other entries come from the first checkpoint."""
    state_dicts = [load_any_checkpoint(p)[0] for p in paths]
    out = dict(state_dicts[0])
    for key, value in out.items():
        if value.is_floating_point():
            total = sum(sd[key].to(torch.float64) for sd in state_dicts)
            out[key] = (total / len(state_dicts)).to(value.dtype)
    return out


def remove_old_checkpoints(experiment_dir: str, keep_last: int = 5,
                           keep_iterations: typing.Sequence[int] = ()):
    """Delete all but the newest `keep_last` checkpoints (by iteration), and
    never those of `keep_iterations` (spec: the reference tools.py:253-279)."""
    pattern = re.compile(r'checkpoint_epoch(\d+)_iter(\d+)\.pt$')
    found = sorted((int(m.group(2)), path)
                   for path in glob.glob(os.path.join(experiment_dir, 'checkpoint_epoch*_iter*.pt'))
                   for m in [pattern.search(path)] if m)
    removed = []
    for iteration, path in found[:-keep_last] if keep_last else found:
        if iteration not in keep_iterations:
            os.remove(path)
            removed.append(path)
    return removed
