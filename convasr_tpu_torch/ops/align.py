"""CTC forced alignment: the CUDA Viterbi kernels and their dispatcher
(counterpart of convasr_tpu/ops/align_pallas.py).

`ctc_alignment_kernel` runs csrc/ctc_viterbi.cu on CUDA tensors: the Viterbi
recursion and the backtrace to each target char's frame, both on the card.
`viterbi_route` picks the kernel: the warp kernel (`viterbi_warp`, one warp a
row, backpointers and backtrace on chip, one launch) for S = 2L+1 <=
WARP_S_MAX, the block pair (`viterbi_forward` with int8 backpointers in
device memory, then `viterbi_backtrace`) for longer lattices.
`ctc_alignment_auto` picks the plain version (ops/ctc.py) for tensors on the
CPU and the kernels for tensors on the card, never the other way: on the card
a kernel runs or the call raises.
"""
import ctypes
import re
import typing

import torch

from . import build
from .ctc import ctc_alignment

# shared memory a block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
# launches of each kernel, counted where it is launched
WARP_LAUNCHES = 0    # viterbi_warp
BLOCK_LAUNCHES = 0   # the block pair viterbi_forward + viterbi_backtrace, one launch of both

# the most states the route gives the warp kernel (the crossover measured by
# chip_smoke.py phase 3), read from csrc/ctc_viterbi.cu without a build
WARP_S_MAX = int(re.search(r'constexpr int WARP_S_MAX = (\d+);',
                           (build.CSRC / 'ctc_viterbi.cu').read_text()).group(1))


def _library():
    lib = build.load('ctc_viterbi')
    if lib.ctc_viterbi_align.argtypes is None:
        lib.ctc_viterbi_align.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p] * 4)
        lib.ctc_viterbi_align_warp.argtypes = lib.ctc_viterbi_align.argtypes
        lib.ctc_viterbi_warp_fits.argtypes = [ctypes.c_int] * 2
        lib.ctc_viterbi_warp_spill_words.argtypes = [ctypes.c_int] * 3
        for fn in (lib.ctc_viterbi_align, lib.ctc_viterbi_align_warp, lib.ctc_viterbi_warp_fits,
                   lib.ctc_viterbi_warp_spill_words):
            fn.restype = ctypes.c_int
    return lib


def viterbi_route(L: int, C: int) -> str:
    """'warp' for S = 2L+1 <= WARP_S_MAX where, as the library says
    (csrc/ctc_viterbi.cu ctc_viterbi_warp_fits), the warp kernel's buffers
    for C classes fit a block's shared memory; 'block' elsewhere."""
    if 2 * L + 1 <= WARP_S_MAX and _library().ctc_viterbi_warp_fits(L, C):
        return 'warp'
    return 'block'


def shared_bytes(L: int, C: int) -> int:
    """Shared memory of one block of a lattice kernel: two rows of 2L+1 states
    (alpha double-buffered; for the CTC loss backward, beta and its terms) and
    two C-wide rows (the staged log-prob row double-buffered; for the
    backward, the log-prob row and the gradient row)."""
    return (2 * (2 * L + 1) + 2 * C) * 4


def check_lattice_inputs(log_probs, targets, input_lengths, target_lengths, blank: int,
                         kernel: str):
    """Validate the inputs of a kernel over the CTC lattice (csrc/ctc_viterbi.cu,
    csrc/ctc_loss.cu) and return them as it takes them: float32 log_probs,
    int32 targets and lengths, all contiguous. Raises on anything else."""
    if not log_probs.is_cuda:
        raise ValueError(f'{kernel} takes CUDA tensors; use its plain version on the CPU')
    if not log_probs.is_floating_point() or log_probs.ndim != 3:
        raise ValueError(f'log_probs must be (B, T, C) float, got '
                         f'{tuple(log_probs.shape)} {log_probs.dtype}')
    B, T, C = log_probs.shape
    if targets.ndim != 2 or targets.shape[0] != B:
        raise ValueError(f'targets must be (B={B}, L), got {tuple(targets.shape)}')
    L = targets.shape[1]
    for name, t in (('targets', targets), ('input_lengths', input_lengths),
                    ('target_lengths', target_lengths)):
        if t.device != log_probs.device or t.is_floating_point():
            raise ValueError(f'{name} must be an integer tensor on {log_probs.device}')
    if input_lengths.shape != (B,) or target_lengths.shape != (B,):
        raise ValueError('input_lengths and target_lengths must be (B,)')
    if not 0 <= blank < C:
        raise ValueError(f'blank {blank} outside [0, {C})')
    if shared_bytes(L, C) > MAX_SHARED_BYTES:
        raise ValueError(f'{2 * L + 1} lattice states and {C} classes need '
                         f'{shared_bytes(L, C)} bytes of shared memory, more than '
                         f'the {MAX_SHARED_BYTES} a block has')
    return (log_probs.to(torch.float32).contiguous(), targets.to(torch.int32).contiguous(),
            input_lengths.to(torch.int32).contiguous(),
            target_lengths.to(torch.int32).contiguous())


def _inputs(log_probs, targets, input_lengths, target_lengths, blank, op):
    if log_probs.is_cuda and log_probs.dtype != torch.float32:
        raise ValueError(f'log_probs must be float32, got {log_probs.dtype}')
    blank = log_probs.shape[-1] - 1 if blank is None else int(blank)
    return (*check_lattice_inputs(log_probs, targets, input_lengths, target_lengths, blank, op),
            blank)


def _launch(lp, y, xlen, ylen, blank, route):
    """One launch of a Viterbi kernel on checked inputs: route 'warp' or
    'block' -> (char frames (B, L) int32, final alpha (B, 2L+1) float32)."""
    B, T, C = lp.shape
    L = y.shape[1]
    S = 2 * L + 1
    dev = lp.device
    frames = torch.empty((B, L), dtype=torch.int32, device=dev)
    final = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return frames.zero_(), final.fill_(-1e30)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == 'warp':
        # the warp kernel copies frames in 16-byte pieces from a tensor that
        # starts on 16 bytes (the allocator's do; a view may not); its
        # backpointers leave shared memory only where T frames of them pass it
        lp = lp if lp.data_ptr() % 16 == 0 else lp.clone()
        words = lib.ctc_viterbi_warp_spill_words(T, L, C)
        spill = torch.empty(B * words, dtype=torch.int32, device=dev) if words else None
        with torch.cuda.device(dev):
            rc = lib.ctc_viterbi_align_warp(
                lp.data_ptr(), y.data_ptr(), xlen.data_ptr(), ylen.data_ptr(), B, T, C, L, blank,
                None if spill is None else spill.data_ptr(), final.data_ptr(),
                frames.data_ptr(), stream)
    else:
        bp = torch.empty((B, T, S), dtype=torch.int8, device=dev)
        with torch.cuda.device(dev):
            rc = lib.ctc_viterbi_align(lp.data_ptr(), y.data_ptr(), xlen.data_ptr(),
                                       ylen.data_ptr(), B, T, C, L, blank, bp.data_ptr(),
                                       final.data_ptr(), frames.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f'ctc_viterbi ({route}): CUDA error {rc} at launch')
    return frames, final


def ctc_alignment_kernel(log_probs: torch.Tensor, targets: torch.Tensor,
                         input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                         blank: typing.Optional[int] = None, return_final: bool = False):
    """Frame index of each target char, (B, L) int32, computed on the card
    (and, with return_final, each row's alpha at its last frame, (B, 2L+1)):
    the kernel `viterbi_route` names.

    log_probs: (B, T, C) float32 CUDA tensor; targets (B, L) and the (B,)
    lengths: integer tensors on the same device. Raises on anything else."""
    global WARP_LAUNCHES, BLOCK_LAUNCHES
    lp, y, xlen, ylen, blank = _inputs(log_probs, targets, input_lengths, target_lengths, blank,
                                       'ctc_alignment_kernel')
    route = viterbi_route(y.shape[1], lp.shape[2])
    frames, final = _launch(lp, y, xlen, ylen, blank, route)
    if lp.shape[0] and lp.shape[1]:
        if route == 'warp':
            WARP_LAUNCHES += 1
        else:
            BLOCK_LAUNCHES += 1
    return (frames, final) if return_final else frames


def _alignment_route(log_probs, targets, input_lengths, target_lengths, blank=None,
                     route: str = 'warp', return_final: bool = False):
    """One Viterbi kernel whatever the rule says ('warp' or 'block'), for
    measurements. Counts no launch."""
    frames, final = _launch(*_inputs(log_probs, targets, input_lengths, target_lengths, blank,
                                     'ctc_alignment_kernel'), route)
    return (frames, final) if return_final else frames


def ctc_alignment_auto(log_probs, targets, input_lengths, target_lengths, blank=None):
    """The kernels for CUDA tensors, the plain version for CPU tensors."""
    if log_probs.is_cuda:
        return ctc_alignment_kernel(log_probs, targets, input_lengths, target_lengths, blank)
    return ctc_alignment(log_probs, targets, input_lengths, target_lengths, blank=blank)
