"""NovoGrad's whole update on two CUDA kernels (csrc/novograd_update.cu): the
global-norm clip, NovoGrad, the schedule's rate, the train step's non-finite
skip and the apply over every leaf at once, and the batch norms' stash and
restore around the step.

`step` runs the norm kernel (each gradient read once: the per-leaf sums of
squares, grad_norm, the clip's decision, NovoGrad's EMA, step and count) and
the update kernel (one pass over g, p and m: the parameters and the momentum
in place, and weight_norm). The optimizer state keeps its tree and its
tensors, updated in place. `stash` and `restore` keep the batch norms' running
statistics in one flat buffer before the forward and put them back where the
loss was not finite.

The plain version is the chain of train/optim.py and train/loop.py
(`chain_update`): the train step takes it on the CPU and for the
compositions that carry no fused update, and the card tests and
chip_smoke.py's phase 6 hold the kernels to it. Tensors the kernels cannot
take (`table`) raise ValueError: the fused route never falls back to the
chain. Elementwise the kernels round as the chain does; the sums of squares
go in another order (a fixed one: two runs give the same bits), so the two
agree to float32 rounding of those sums.
"""
import ctypes
import re

import numpy as np
import torch

from . import build

# launches of each kernel, counted where it is launched
NORM_LAUNCHES = 0
UPDATE_LAUNCHES = 0
STASH_LAUNCHES = 0      # the batch norms' statistics into the flat buffer
RESTORE_LAUNCHES = 0    # and back where the loss was not finite

_SOURCE = (build.CSRC / 'novograd_update.cu').read_text()
# the table's capacity and a block's elements, read from the source without a
# build (the CPU's tests hold the arithmetic)
MAX_LEAVES, CHUNK = (int(re.search(rf'constexpr int {name} = (\d+);', _SOURCE).group(1))
                     for name in ('MAX_LEAVES', 'CHUNK'))


def _declare(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.novograd_norm.argtypes = [P, P, I, P, P, P, P, P, P, P, P, P, F, F, F, F, P]
    lib.novograd_apply.argtypes = [P, P, P, P, I, P, P, P, P, F, F, F, F, P, P, P, P]
    lib.stash_tensors.argtypes = [P, P, I, P, I, P, P]
    for fn in (lib.novograd_norm, lib.novograd_apply, lib.stash_tensors):
        fn.restype = ctypes.c_int


def _library():
    return build.load('novograd_update', _declare)


def chunks(numels) -> int:
    """Blocks of a launch over leaves of these sizes: CHUNK elements of one
    leaf a block."""
    return sum(-(-int(n) // CHUNK) for n in numels)


def table(tensors, device, what) -> np.ndarray:
    """The tensors' addresses, for a launch's table. Raises ValueError where
    the kernels cannot take them: more than MAX_LEAVES tensors, or one that
    is not a contiguous float32 tensor on `device` (a CUDA device) of fewer
    than 2^31 - CHUNK elements."""
    if device.type != 'cuda':
        raise ValueError(f'{what}: the fused update runs on a CUDA device, not {device}')
    if len(tensors) > MAX_LEAVES:
        raise ValueError(f'{what}: {len(tensors)} tensors, more than the fused update\'s '
                         f'table of {MAX_LEAVES}')
    f32 = torch.float32
    for t in tensors:
        if t.dtype is not f32 or t.device != device or not t.is_contiguous() \
                or t.numel() >= 2 ** 31 - CHUNK:
            raise ValueError(
                f'{what}: the fused update takes contiguous float32 tensors of fewer than '
                f'2^31 - {CHUNK} elements on {device}, not a '
                f'{"" if t.is_contiguous() else "non-contiguous "}{tuple(t.shape)} {t.dtype} '
                f'tensor on {t.device}')
    return np.fromiter((t.data_ptr() for t in tensors), dtype=np.int64, count=len(tensors))


def _sizes(tensors) -> np.ndarray:
    return np.fromiter((t.numel() for t in tensors), dtype=np.int32, count=len(tensors))


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f'{what} failed to launch: CUDA error {rc}')


class Scratch:
    """The kernels' device memory for one list of leaves (their sizes, on
    one device): each block's partial sum, each leaf's sqrt(e + eps), the
    clip's norm and decision, and the two kernels' counters (zero between
    launches: the last block resets its own). One train step's: launches
    that share it run in order on one stream."""

    def __init__(self, numels, device):
        self.numels = tuple(int(n) for n in numels)
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        self.device = device
        self.sizes = np.asarray(self.numels, dtype=np.int32)
        self.blocks = chunks(self.numels)
        n = len(self.numels)
        floats = torch.empty(self.blocks + n + 2, dtype=torch.float32, device=self.device)
        self.partial, self.denom, self.clip = floats[:self.blocks], \
            floats[self.blocks:self.blocks + n], floats[self.blocks + n:]
        self.counters = torch.zeros(2, dtype=torch.int32, device=self.device)


def _check_scalar(t, dtype, device, what):
    if not torch.is_tensor(t) or t.dtype != dtype or t.device != device or t.numel() != 1:
        raise ValueError(f'{what}: the fused update takes a one-element {dtype} tensor on '
                         f'{device}')


def step(scratch: Scratch, grads, params, momentum, grads_ema, nv_step, count, lr, finite,
         betas, eps: float, weight_decay: float, max_norm: float):
    """One update over every leaf, in place: the parameters, the momentum,
    NovoGrad's EMA (N,) and step, and the schedule's count, as
    csrc/novograd_update.cu says, from the gradients and the rate `lr` (a
    Python number or a 0-dim tensor, read on the device); where the 0-dim
    bool `finite` is false nothing changes. max_norm <= 0: no clip. Returns
    (grad_norm, weight_norm), 0-dim float32 tensors on the device. `scratch`
    made for the parameters' sizes on their device; every tensor as `table`
    requires (gradients are made contiguous), the momentum of the parameters'
    sizes, the EMA of one element a leaf, int32 counters: ValueError
    otherwise."""
    global NORM_LAUNCHES, UPDATE_LAUNCHES
    device = scratch.device
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    # the tables' arrays stay referenced until the calls return
    g_at = table(grads, device, 'the gradients')
    p_at = table(params, device, 'the parameters')
    m_at = table(momentum, device, 'the momentum')
    for what, tensors in (('gradients', grads), ('parameters', params), ('momentum', momentum)):
        if not np.array_equal(_sizes(tensors), scratch.sizes):
            raise ValueError(f'the {what}\' sizes are not those the scratch was made for')
    table([grads_ema], device, 'NovoGrad\'s EMA')
    if grads_ema.numel() != len(params):
        raise ValueError(f'NovoGrad\'s EMA has {grads_ema.numel()} elements for '
                         f'{len(params)} leaves')
    _check_scalar(nv_step, torch.int32, device, 'NovoGrad\'s step')
    _check_scalar(count, torch.int32, device, 'the schedule\'s count')
    _check_scalar(finite, torch.bool, device, 'the flag finite')
    if torch.is_tensor(lr):
        lr = lr.to(device=device, dtype=torch.float32)
        lr_ptr, lr_value = lr.data_ptr(), 0.0
    else:
        lr_ptr, lr_value = None, float(lr)
    out = torch.empty(2, dtype=torch.float32, device=device)
    flag = finite.data_ptr()
    counters = scratch.counters.data_ptr()
    b1, b2 = betas
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _library()
    with torch.cuda.device(device):
        _check(lib.novograd_norm(
            g_at.ctypes.data, scratch.sizes.ctypes.data, len(grads), flag,
            scratch.partial.data_ptr(), counters, scratch.denom.data_ptr(),
            scratch.clip.data_ptr(), out.data_ptr(), grads_ema.data_ptr(), nv_step.data_ptr(),
            count.data_ptr(), b2, 1.0 - b2, eps, max_norm,
            stream), 'the norm kernel')
        NORM_LAUNCHES += 1
        _check(lib.novograd_apply(
            g_at.ctypes.data, p_at.ctypes.data, m_at.ctypes.data,
            scratch.sizes.ctypes.data, len(grads), flag, scratch.clip.data_ptr(),
            scratch.denom.data_ptr(), lr_ptr, lr_value, b1, weight_decay, max_norm,
            scratch.partial.data_ptr(), counters + 4, out.data_ptr() + 4, stream),
            'the update kernel')
        UPDATE_LAUNCHES += 1
    return out[0], out[1]


def stash(tensors, flat=None) -> torch.Tensor:
    """Copies the tensors (as `table` requires) into one flat buffer, `flat`
    where it has their size, else a new one; returns it."""
    global STASH_LAUNCHES
    device = tensors[0].device
    at, sizes = table(tensors, device, 'the stashed tensors'), _sizes(tensors)
    total = int(sizes.sum(dtype=np.int64))
    if flat is None or flat.numel() != total or flat.device != device:
        flat = torch.empty(total, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _check(_library().stash_tensors(
            at.ctypes.data, sizes.ctypes.data, len(tensors), flat.data_ptr(), 0,
            None, torch.cuda.current_stream(device).cuda_stream), 'the stash kernel')
    STASH_LAUNCHES += 1
    return flat


def restore(tensors, flat: torch.Tensor, finite: torch.Tensor):
    """Puts `stash`'s copies back into the tensors where the 0-dim bool
    `finite` is false (on the device: nothing waits for the flag)."""
    global RESTORE_LAUNCHES
    device = tensors[0].device
    at, sizes = table(tensors, device, 'the stashed tensors'), _sizes(tensors)
    table([flat], device, 'the stash')
    _check_scalar(finite, torch.bool, device, 'the flag finite')
    if flat.numel() != int(sizes.sum(dtype=np.int64)):
        raise ValueError('the stash does not hold these tensors')
    with torch.cuda.device(device):
        _check(_library().stash_tensors(
            at.ctypes.data, sizes.ctypes.data, len(tensors), flat.data_ptr(), 1,
            finite.data_ptr(), torch.cuda.current_stream(device).cuda_stream),
            'the restore kernel')
    RESTORE_LAUNCHES += 1
