"""Whole-T CTC loss on the CUDA kernels K2f/K2b and their plain versions
(counterpart of convasr_tpu/ops/ctc_pallas.py: `ctc_loss_pallas` and
`vmem_fits`).

`CTCLossWholeT` is one autograd function returning the per-row loss (B,): its
forward runs the alpha recursion, its backward the beta recursion and the
scatter to the classes. On CUDA tensors the forward is K2f of
csrc/ctc_loss_whole_t.cu, which stages a row's valid log-prob frames in
shared memory once and runs the whole T from there. The backward, K2b,
computes K1b's function (its oracle is K1's beta_grad_plain), so it takes
K1b's route (`beta_grad_route`): K1b's warp kernel of csrc/ctc_loss.cu where
ops/ctc_loss.beta_grad_warp_fits takes the lattice, the whole-T block kernel
of csrc/ctc_loss_whole_t.cu elsewhere. On CPU tensors they are their plain
versions, ops/ctc_loss.alpha_plain (with take_frame0) and beta_grad_plain.
`ctc_loss_whole_t` picks by where the tensors lie, never the other way: on the
card the kernels run or the call raises.

The semantics are the TPU v1 kernel's, which differ from K1
(ops/ctc_loss.py) on one row only: a row with xlen = 0 still takes frame 0,
so it gets a finite loss where ylen <= 1, and a zero gradient (its beta is
never initialised). An infeasible row gets +inf and a zero gradient; gamma is
clipped to exp(+-80); the blank defaults to C-1.

No CLI path of either package reaches this function (the JAX package's
`ctc_loss_auto` sends the TPU to the time-chunked v2, as the port's train path
uses K1); `smem_fits` is the card's budget for it, as `vmem_fits` is the
TPU's, on either route of the backward. The whole-T kernels sum a class's
states with shared-memory atomics, in an order that varies from run to run
(the warp kernel in a fixed order of its own): against the plain version the
losses agree to rtol 1e-5 and the gradients to atol 1e-4 and rtol 1e-3.
"""
import ctypes
import typing

import torch

from . import build, ctc_loss
from .align import MAX_SHARED_BYTES, check_lattice_inputs
from .ctc import NEG_INF
from .ctc_loss import alpha_plain, beta_grad_plain

# launches of each kernel, counted where it is launched
ALPHA_LAUNCHES = 0
BETA_GRAD_LAUNCHES = 0        # the whole-T block backward kernel
BETA_GRAD_WARP_LAUNCHES = 0   # K1b's warp kernel on K2b's route


def smem_bytes(T: int, L: int, C: int) -> int:
    """Shared memory a block of K2b takes (K2f takes C floats less): the T x C
    float32 log-prob frames staged with up to 3 floats of alignment offset,
    rounded to 16 bytes, then beta and its terms (2 x (2L+1)) and the C-wide
    gradient row (csrc/ctc_loss_whole_t.cu)."""
    return ((T * C + 6) // 4 * 4 + 2 * (2 * L + 1) + C) * 4


def smem_fits(T: int, L: int, C: int) -> bool:
    """Whether the kernels take T frames of C classes and L targets: the
    whole T of a row must fit the 227 KB of shared memory a block has. It
    depends on the padded T, not on the batch (one block per row). The plain
    versions have no limit."""
    return smem_bytes(T, L, C) <= MAX_SHARED_BYTES


def _library():
    lib = build.load('ctc_loss_whole_t')
    alpha, beta_grad = lib.ctc_loss_whole_t_alpha, lib.ctc_loss_whole_t_beta_grad
    if alpha.argtypes is None:
        alpha.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        alpha.restype = ctypes.c_int
        beta_grad.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        beta_grad.restype = ctypes.c_int
    return alpha, beta_grad


def _guard(log_probs, targets, kernel):
    """Raise where a row's whole T does not fit a block (smem_fits)."""
    if log_probs.is_cuda and log_probs.ndim == 3 and targets.ndim == 2:
        (_, T, C), L = log_probs.shape, targets.shape[1]
        if not smem_fits(T, L, C):
            raise ValueError(f'{kernel}: T={T} frames of {C} classes and {2 * L + 1} lattice '
                             f'states need {smem_bytes(T, L, C)} bytes of shared memory, more '
                             f'than the {MAX_SHARED_BYTES} a block has')


def alpha_kernel(log_probs, targets, input_lengths, target_lengths, blank: int):
    """K2f on the card -> (alpha (B, T, 2L+1), ll (B,))."""
    global ALPHA_LAUNCHES
    _guard(log_probs, targets, 'ctc_loss_whole_t_alpha')
    lp, y, xlen, ylen = check_lattice_inputs(log_probs, targets, input_lengths, target_lengths,
                                             blank, 'ctc_loss_whole_t_alpha')
    B, T, C = lp.shape
    L = y.shape[1]
    alpha = torch.empty((B, T, 2 * L + 1), dtype=torch.float32, device=lp.device)
    ll = torch.empty((B,), dtype=torch.float32, device=lp.device)
    if B == 0 or T == 0:
        return alpha, ll.fill_(NEG_INF)
    fn, _ = _library()
    with torch.cuda.device(lp.device):
        rc = fn(lp.data_ptr(), y.data_ptr(), xlen.data_ptr(), ylen.data_ptr(), B, T, C, L,
                blank, alpha.data_ptr(), ll.data_ptr(),
                torch.cuda.current_stream(lp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'ctc_loss_whole_t_alpha: CUDA error {rc} at launch')
    ALPHA_LAUNCHES += 1
    return alpha, ll


def beta_grad_route(L: int, C: int) -> str:
    """K2b's route, K1b's: 'warp' (K1b's warp kernel, csrc/ctc_loss.cu) where
    ops/ctc_loss.beta_grad_warp_fits takes the lattice, 'block' (the whole-T
    kernel) elsewhere."""
    return 'warp' if ctc_loss.beta_grad_warp_fits(L, C) else 'block'


def _launch_beta_grad(inputs, blank, route):
    """One launch of a K2b kernel on checked inputs: route 'warp' (K1b's)
    or 'block' (the whole-T kernel)."""
    if route == 'warp':
        return ctc_loss._launch_beta_grad(inputs, blank, 'warp')
    lp, y, xlen, ylen, alpha, ll, g = inputs
    B, T, C = lp.shape
    L = y.shape[1]
    grad = torch.empty((B, T, C), dtype=torch.float32, device=lp.device)
    if B == 0 or T == 0:
        return grad
    _, fn = _library()
    with torch.cuda.device(lp.device):
        rc = fn(lp.data_ptr(), y.data_ptr(), xlen.data_ptr(), ylen.data_ptr(), alpha.data_ptr(),
                ll.data_ptr(), g.data_ptr(), B, T, C, L, blank, grad.data_ptr(),
                torch.cuda.current_stream(lp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'ctc_loss_whole_t_beta_grad: CUDA error {rc} at launch')
    return grad


def _beta_grad_inputs(log_probs, targets, input_lengths, target_lengths, alpha, ll, g, blank):
    _guard(log_probs, targets, 'ctc_loss_whole_t_beta_grad')
    return ctc_loss._beta_grad_inputs(log_probs, targets, input_lengths, target_lengths, alpha,
                                      ll, g, blank, 'ctc_loss_whole_t_beta_grad')


def beta_grad_kernel(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                     blank: int):
    """K2b on the card -> (B, T, C) float32: g[b] * d loss[b] / d log_probs
    for feasible rows with xlen > 0, 0 elsewhere and past xlen; on the kernel
    `beta_grad_route` names. Both write 0 on every frame of a row with
    xlen = 0, whose finite ll is K2's one difference from K1."""
    global BETA_GRAD_LAUNCHES, BETA_GRAD_WARP_LAUNCHES
    inputs = _beta_grad_inputs(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                               blank)
    lp, y = inputs[:2]
    route = beta_grad_route(y.shape[1], lp.shape[2])
    grad = _launch_beta_grad(inputs, blank, route)
    if lp.shape[0] and lp.shape[1]:
        if route == 'warp':
            BETA_GRAD_WARP_LAUNCHES += 1
        else:
            BETA_GRAD_LAUNCHES += 1
    return grad


def _beta_grad_route(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                     blank: int, route: str):
    """One K2b kernel whatever the rule says ('warp' or 'block'), for
    measurements. Counts no launch."""
    return _launch_beta_grad(_beta_grad_inputs(log_probs, targets, input_lengths,
                                               target_lengths, alpha, ll, g, blank), blank, route)


def alpha_whole_t_plain(log_probs, targets, input_lengths, target_lengths, blank: int):
    """K2f's plain version: alpha_plain with frame 0 taken by every row."""
    return alpha_plain(log_probs, targets, input_lengths, target_lengths, blank,
                       take_frame0=True)


class CTCLossWholeT(torch.autograd.Function):
    """Per-row CTC loss (B,) with its gradient: K2f/K2b on CUDA tensors, their
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths, blank: int):
        forward = alpha_kernel if log_probs.is_cuda else alpha_whole_t_plain
        alpha, ll = forward(log_probs, targets, input_lengths, target_lengths, blank)
        ctx.save_for_backward(log_probs, targets, input_lengths, target_lengths, alpha, ll)
        ctx.blank = blank
        return torch.where(ll > NEG_INF / 2, -ll, float('inf'))

    @staticmethod
    def backward(ctx, g):
        log_probs, targets, input_lengths, target_lengths, alpha, ll = ctx.saved_tensors
        backward = beta_grad_kernel if log_probs.is_cuda else beta_grad_plain
        grad = backward(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                        ctx.blank)
        return grad.to(log_probs.dtype), None, None, None, None


def ctc_loss_whole_t(log_probs: torch.Tensor, targets: torch.Tensor,
                     input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                     blank: typing.Optional[int] = None) -> torch.Tensor:
    """Per-row CTC loss (B,) of the whole-T kernels (ctc_loss_pallas's
    semantics): K2f/K2b for CUDA tensors, the plain versions for CPU tensors.
    blank defaults to C-1. On the card, raises where smem_fits is False."""
    blank = log_probs.shape[-1] - 1 if blank is None else int(blank)
    return CTCLossWholeT.apply(log_probs, targets, input_lengths, target_lengths, blank)
