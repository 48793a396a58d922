"""Checkpoints of the port (counterpart of convasr_tpu/train/checkpoints.py).

The port's own format is one file written by torch.save. A model checkpoint
holds {'model_state_dict': ..., 'args': {...}}; a training checkpoint adds
the optimizer state and step, the epoch, the sampler's position, the state
of the generator that draws dropout masks and dither, so that a resumed run
continues the one it was cut from. A flattened `.npz` of a JAX package's flax
trees ('params/block0/conv0/conv/kernel', ...) loads too, converted by
models/convert.py. A reference convasr `.pt` (`backbone.*`, `decoder.*`
keys) is converted by `load_reference_checkpoint`; `load_any_checkpoint`
tells it from the port's own by its key names. The port does not read an
orbax directory itself: `scripts/orbax_to_npz.py` flattens one into such an
`.npz`, its args beside the weights as a JSON string.

Under the tensor-parallel layout (parallel/tensor_parallel.py) every rank
calls the savers, which gather the sharded leaves, and rank 0 writes the
whole tensors: the file is a one-process run's, as orbax writes global
arrays. `restore_train_state_` loads a whole checkpoint into a sharded model
and optimizer state, each rank taking its slices, so a checkpoint moves
between the two layouts both ways.
"""
import argparse
import glob
import json
import os
import re
import typing

import numpy as np
import torch

from ..models.convert import from_jax_npz
from ..parallel import mesh, tensor_parallel

CHECKPOINT_TEMPLATE = 'checkpoint_epoch{epoch:02d}_iter{iteration:07d}'


def checkpoint_path(experiment_dir: str, epoch: int, iteration: int,
                    template: typing.Optional[str] = None) -> str:
    """template: --checkpoint-format (spec: the reference train.py:918); the
    port's checkpoints are files ending in .pt."""
    name = (template or CHECKPOINT_TEMPLATE).format(epoch=epoch, iteration=iteration)
    return os.path.join(experiment_dir, name if name.endswith('.pt') else name + '.pt')


def save_checkpoint(path: str, model: torch.nn.Module, args: typing.Optional[dict] = None):
    state_dict = tensor_parallel.gather_state(model)
    if mesh.rank() == 0 or not tensor_parallel.is_sharded(model):
        torch.save(dict(model_state_dict=state_dict, args=dict(args or {})), path)
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
                          args: typing.Optional[dict] = None,
                          generator_states: typing.Optional[list] = None) -> str:
    """state: train/loop.TrainState. Written to a temporary file first, so a
    checkpoint that exists is whole. generator_states: every rank's generator
    state (bytes, in rank order) of a run over several processes. A sharded
    model's whole tensors are written by rank 0."""
    sharded = tensor_parallel.is_sharded(model)
    opt_state = tensor_parallel.gather_opt_state(state.opt_state, list(model.parameters())) \
        if sharded else state.opt_state
    model_state_dict = tensor_parallel.gather_state(model)
    if sharded and mesh.rank() != 0:
        return path
    payload = dict(model_state_dict=model_state_dict, opt_state=_to(opt_state, 'cpu'),
                   step=int(state.step), epoch=int(epoch), sampler=dict(sampler_state or {}),
                   generator_state=generator.get_state() if generator is not None else None,
                   args=plain_args(dict(args or {})))
    if generator_states is not None:
        payload['generator_states'] = list(generator_states)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state_(model: torch.nn.Module, ckpt: dict, state=None):
    """Loads load_train_checkpoint's payload into `model` (and its optimizer
    state into `state`, a train/loop.TrainState, where both are given): each
    sharded leaf of a tensor-parallel model takes this rank's slice."""
    if tensor_parallel.is_sharded(model):
        tensor_parallel.load_sharded_(model, ckpt['model_state_dict'])
    else:
        model.load_state_dict(ckpt['model_state_dict'])
    if state is not None and ckpt.get('opt_state') is not None:
        state.opt_state = tensor_parallel.shard_opt_state(ckpt['opt_state'],
                                                          list(model.parameters())) \
            if tensor_parallel.is_sharded(model) else ckpt['opt_state']
        state.step = int(ckpt.get('step', state.step))
    return model


def load_train_checkpoint(path: str, device='cpu') -> dict:
    """The payload of save_train_checkpoint, optimizer state on `device`. A
    model-only checkpoint comes back with opt_state None and step 0, so that
    training starts with a fresh optimizer: the port's model checkpoint, a
    flattened JAX `.npz`, or a reference convasr `.pt` (its weights and BN
    statistics, the args of its Namespace and its epoch, as the JAX CLI takes
    them: convasr_tpu/cli/train.py:579-581,680-706)."""
    check_not_orbax(path)
    if path.endswith('.npz'):
        state_dict, args = load_any_checkpoint(path)
        ckpt = dict(model_state_dict=state_dict, args=args)
    else:
        ckpt = _load_pt(path)
        if is_reference_state_dict(ckpt.get('model_state_dict', ckpt)):
            state_dict, meta = convert_reference_checkpoint(ckpt)
            ckpt = dict(model_state_dict=state_dict, epoch=int(meta.get('epoch') or 0),
                        args=_args_dict(meta.get('args')))
    ckpt.setdefault('opt_state', None)
    ckpt['opt_state'] = _to(ckpt['opt_state'], device)
    for key, default in (('step', 0), ('epoch', 0), ('sampler', {}), ('generator_state', None),
                         ('args', {})):
        ckpt.setdefault(key, default)
    return ckpt


def _load_pt(path: str):
    """torch.load with weights only, allowing (for this call only) the
    argparse.Namespace that reference convasr checkpoints keep their args in."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location='cpu', weights_only=True)


def is_reference_state_dict(state_dict: dict) -> bool:
    """A reference convasr model's keys (`backbone.{i}.*`, `decoder.{i}.*`),
    which no module of the port's JasperNet has (`block{i}.*`,
    `decoder.head0.*`)."""
    return any(k.startswith('backbone.') for k in state_dict) or \
        any(re.match(r'decoder\.\d+\.', k) for k in state_dict)


def _reference_key(name: str, separable_convs: set) -> typing.Optional[str]:
    """The port's state_dict name of a reference convasr module name (the key
    map of convasr_tpu/train/checkpoints.py:load_reference_checkpoint, to the
    port's names, which keep the flax module names); None for an entry the
    port has no counterpart of (the frontend's buffers). Conv weights keep
    their (out, in, k) layout."""
    parts = name.split('.')
    leaf = parts[-1]
    if parts[0] == 'backbone':
        i, kind = parts[1], parts[2]
        block = f'block{i}'
        if kind == 'conv':
            r, sub = parts[3], parts[4]
            if sub == '0':
                target = 'depthwise' if (i, r) in separable_convs else 'conv'
            elif sub == '2':
                target = 'pointwise'
            else:
                return None
            return f'{block}.conv{r}.{target}.{leaf}'
        if kind in ('bn', 'bn_residual', 'conv_residual'):
            return f'{block}.{kind}{parts[3]}.{leaf}'
        return None
    if parts[0] == 'decoder':
        if len(parts) == 3:            # flat Conv1d head: decoder.{i}.{weight,bias}
            return f'decoder.head{parts[1]}.{leaf}'
        if parts[1] == '1' and len(parts) >= 6 and parts[3] in ('conv', 'bn'):
            # type='bpe' head: decoder.1 is Sequential(ConvBn1d, ConvBn1d)
            # (reference models.py:27-35); decoder.1.{j}.conv.0.0.weight and
            # decoder.1.{j}.bn.0.{weight,bias,running_mean,running_var}
            bpe = f'decoder.bpe_conv{parts[2]}'
            return f'{bpe}.conv0.conv.{leaf}' if parts[3] == 'conv' else f'{bpe}.bn0.{leaf}'
        raise ValueError(
            f'unsupported reference decoder structure: {name!r} — expected a flat Conv1d head '
            "(decoder.{i}.weight) or the type='bpe' nested ConvBn head (decoder.1.{j}.conv/bn.*)")
    return None


def load_reference_checkpoint(pt_path: str):
    """A reference convasr .pt checkpoint -> (the port's JasperNet state_dict,
    meta: its epoch, iteration, args and sampler state where present)."""
    return convert_reference_checkpoint(_load_pt(pt_path))


def convert_reference_checkpoint(ckpt: dict):
    """load_reference_checkpoint on a checkpoint already loaded. A batch norm
    without `num_batches_tracked` gets 0, as models/convert.py gives a JAX
    checkpoint's."""
    sd = ckpt.get('model_state_dict', ckpt)
    # the reference's separable ConvSamePadding is Sequential(depthwise, relu,
    # pointwise): a `.2.` sub-module exists; a plain conv has `.0.` only
    separable_convs = {(p[1], p[3]) for p in (name.split('.') for name in sd)
                       if len(p) >= 5 and p[0] == 'backbone' and p[2] == 'conv' and p[4] == '2'}
    out = {}
    for name, tensor in sd.items():
        key = _reference_key(name, separable_convs)
        if key is not None:
            out[key] = tensor
    for key in [k for k in out if k.endswith('.running_mean')]:
        out.setdefault(key[:-len('running_mean')] + 'num_batches_tracked',
                       torch.zeros((), dtype=torch.long))
    meta = {k: ckpt[k] for k in ('epoch', 'iteration', 'args', 'sampler_state_dict')
            if isinstance(ckpt, dict) and k in ckpt}
    return out, meta


def _args_dict(args) -> dict:
    """A checkpoint's args as a dict: reference files keep an
    argparse.Namespace."""
    return dict(args if isinstance(args, dict) else vars(args or argparse.Namespace()))


NPZ_ARGS_KEY = 'meta/args_json'   # the args of scripts/orbax_to_npz.py, a JSON string


def check_not_orbax(path: str):
    """An orbax checkpoint (a directory) stops with the command that converts
    it: the port reads no orbax."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f'{path} is an orbax checkpoint directory, which convasr_tpu_torch does not read; '
            f'convert it first: python scripts/orbax_to_npz.py {path} model.npz')


def load_any_checkpoint(path: str):
    """Returns (state_dict or {} when the file holds no weights, ckpt_args):
    the port's .pt, a reference convasr .pt (told apart by its key names) or
    a flattened .npz of a JAX checkpoint (with the args that
    scripts/orbax_to_npz.py stores beside the weights, else none)."""
    check_not_orbax(path)
    if path.endswith('.npz'):
        with np.load(path) as arrays:
            args = json.loads(str(arrays[NPZ_ARGS_KEY])) if NPZ_ARGS_KEY in arrays else {}
        return from_jax_npz(path), args
    ckpt = _load_pt(path)
    if is_reference_state_dict(ckpt.get('model_state_dict', ckpt)):
        state_dict, meta = convert_reference_checkpoint(ckpt)
        return state_dict, _args_dict(meta.get('args'))
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
