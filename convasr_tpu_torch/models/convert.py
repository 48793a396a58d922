"""Carry JAX-package weights across to the port.

The flax trees `params` and `batch_stats` of a JasperNet map one to one onto
the port's state_dict, because the port keeps the flax module names:

    params/block0/conv0/conv/kernel     (K, Cin/g, Cout) -> block0.conv0.conv.weight (Cout, Cin/g, K)
    params/block0/bn0/{scale,bias}                       -> block0.bn0.{weight,bias}
    batch_stats/block0/bn0/{mean,var}                    -> block0.bn0.{running_mean,running_var}
    params/decoder/head0/{kernel,bias}                   -> decoder.head0.{weight,bias}

The trees come as nested dicts of numpy arrays, or from a flattened `.npz`
whose keys are the '/'-joined paths ('params/block0/conv0/conv/kernel', ...),
so a JAX checkpoint crosses over without the port importing JAX.
"""
import numpy as np
import torch

_PARAM_LEAVES = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
_STAT_LEAVES = {'mean': 'running_mean', 'var': 'running_var'}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_params(params: dict, batch_stats: dict) -> dict:
    """flax {params, batch_stats} trees -> the port's JasperNet state_dict."""
    sd = {}
    for path, value in _flatten(params):
        *module, leaf = path
        value = np.asarray(value, dtype=np.float32)
        if leaf == 'kernel':
            value = value.transpose(2, 1, 0)
        sd['.'.join(module + [_PARAM_LEAVES[leaf]])] = torch.tensor(value)
    for path, value in _flatten(batch_stats):
        *module, leaf = path
        sd['.'.join(module + [_STAT_LEAVES[leaf]])] = torch.tensor(
            np.asarray(value, dtype=np.float32))
        sd['.'.join(module + ['num_batches_tracked'])] = torch.zeros((), dtype=torch.long)
    return sd


def from_jax_npz(path: str) -> dict:
    """Flattened `.npz` of the flax trees -> the port's state_dict."""
    tree: dict = {}
    with np.load(path) as arrays:
        for key in arrays.keys():
            node = tree
            *parents, leaf = key.split('/')
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = arrays[key]
    return from_jax_params(tree.get('params', {}), tree.get('batch_stats', {}))
