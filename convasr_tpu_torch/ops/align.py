"""CTC forced alignment: the CUDA Viterbi kernel and its dispatcher
(counterpart of convasr_tpu/ops/align_pallas.py).

`ctc_alignment_kernel` runs csrc/ctc_viterbi.cu on CUDA tensors: the Viterbi
recursion with int8 backpointers, then the backtrace to each target char's
frame, both on the card. `ctc_alignment_auto` picks the plain version
(ops/ctc.py) for tensors on the CPU and the kernel for tensors on the card,
never the other way: on the card the kernel runs or the call raises.
"""
import ctypes
import typing

import torch

from . import build
from .ctc import ctc_alignment

# shared memory a block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
# launches of the kernel, counted where it is launched
KERNEL_LAUNCHES = 0


def _library():
    lib = build.load('ctc_viterbi')
    fn = lib.ctc_viterbi_align
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return fn


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


def ctc_alignment_kernel(log_probs: torch.Tensor, targets: torch.Tensor,
                         input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                         blank: typing.Optional[int] = None, return_final: bool = False):
    """Frame index of each target char, (B, L) int32, computed on the card
    (and, with return_final, each row's alpha at its last frame, (B, 2L+1)).

    log_probs: (B, T, C) float32 CUDA tensor; targets (B, L) and the (B,)
    lengths: integer tensors on the same device. Raises on anything else."""
    global KERNEL_LAUNCHES
    if log_probs.is_cuda and log_probs.dtype != torch.float32:
        raise ValueError(f'log_probs must be float32, got {log_probs.dtype}')
    blank = log_probs.shape[-1] - 1 if blank is None else int(blank)
    log_probs, targets32, xlen32, ylen32 = check_lattice_inputs(
        log_probs, targets, input_lengths, target_lengths, blank, 'ctc_alignment_kernel')
    B, T, C = log_probs.shape
    L = targets.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    frames = torch.empty((B, L), dtype=torch.int32, device=dev)
    final = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        frames.zero_()
        final.fill_(-1e30)
        return (frames, final) if return_final else frames
    fn = _library()
    bp = torch.empty((B, T, S), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = fn(log_probs.data_ptr(), targets32.data_ptr(), xlen32.data_ptr(),
                ylen32.data_ptr(), B, T, C, L, blank, bp.data_ptr(), final.data_ptr(),
                frames.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'ctc_viterbi_align: CUDA error {rc} at launch')
    KERNEL_LAUNCHES += 1
    return (frames, final) if return_final else frames


def ctc_alignment_auto(log_probs, targets, input_lengths, target_lengths, blank=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if log_probs.is_cuda:
        return ctc_alignment_kernel(log_probs, targets, input_lengths, target_lengths, blank)
    return ctc_alignment(log_probs, targets, input_lengths, target_lengths, blank=blank)
