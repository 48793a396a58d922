"""CTC loss on the CUDA kernels and their plain versions (counterpart of
convasr_tpu/ops/ctc_pallas_v2.py and the parts of ops/ctc_pallas.py it uses).

`CTCLoss` is one autograd function: its forward runs the alpha recursion and
returns the per-row loss, its backward runs the beta recursion and returns
d loss / d log_probs (B, T, C). On CUDA tensors they are the kernels of
csrc/ctc_loss.cu (`alpha_kernel`, its log-prob frames copied ahead through a
ring in shared memory; `beta_grad_kernel`: the warp kernel where
`beta_grad_warp_fits` takes the lattice, the block kernel elsewhere); on CPU
tensors their plain versions (`alpha_plain`, `beta_grad_plain`), which
compute exactly what the kernels compute. `ctc_loss_auto` picks by where the tensors lie, never
the other way: on the card the kernels run or the call raises.

The semantics are the TPU kernel's (the product path of the JAX package):
- a row with xlen = 0 gets an infinite loss, where the time scan of
  ops/ctc.py gives a finite one (the train path never feeds xlen = 0:
  output lengths are a ceil of a positive fraction);
- an infeasible row (no alignment within xlen frames) gets +inf and a zero
  gradient;
- gamma = exp(alpha + beta - ll) is clipped to exp(+-80), so every state a
  valid frame holds adds at least exp(-80) to its class.

The block backward kernel sums the states of one class in the gradient with
shared-memory atomics, in an order that varies from run to run; the warp
kernel sums in a fixed order of its own. Against the plain version the losses
agree to rtol 1e-5 and the gradients to atol 1e-4 and rtol 1e-3 (see
csrc/ctc_loss.cu).
"""
import ctypes
import re
import typing

import torch

from . import build
from .align import check_lattice_inputs
from .ctc import NEG_INF, _diff_labels, _shift, interleave_blanks

# launches of each kernel, counted where it is launched
ALPHA_LAUNCHES = 0
BETA_GRAD_LAUNCHES = 0        # the block backward kernel
BETA_GRAD_WARP_LAUNCHES = 0   # the warp backward kernel

_SOURCE = (build.CSRC / 'ctc_loss.cu').read_text()
# the most states the route gives the warp backward kernel, and the frames of
# the forward's ring on the path, read from csrc/ctc_loss.cu without a build
# (the rule's states part also serves the CPU's tests)
WARP_S_MAX, ALPHA_DEPTH = (int(re.search(rf'constexpr int {name} = (\d+);', _SOURCE).group(1))
                           for name in ('WARP_S_MAX', 'ALPHA_DEPTH'))


def _library():
    lib = build.load('ctc_loss')
    if lib.ctc_loss_alpha.argtypes is None:
        lib.ctc_loss_alpha.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.ctc_loss_beta_grad.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                           + [ctypes.c_void_p] * 2)
        lib.ctc_loss_beta_grad_warp.argtypes = lib.ctc_loss_beta_grad.argtypes
        lib.ctc_loss_beta_grad_warp_fits.argtypes = [ctypes.c_int] * 2
        for fn in (lib.ctc_loss_alpha, lib.ctc_loss_beta_grad, lib.ctc_loss_beta_grad_warp,
                   lib.ctc_loss_beta_grad_warp_fits):
            fn.restype = ctypes.c_int
    return lib


def beta_grad_warp_fits(L: int, C: int) -> bool:
    """The route of the backward pass: the warp kernel for S = 2L+1 <=
    WARP_S_MAX (where it beat the block kernel) where, as the library says
    (csrc/ctc_loss.cu ctc_loss_beta_grad_warp_fits), one row's buffers fit a
    block's shared memory. Other lattices go to the block kernel."""
    return 2 * L + 1 <= WARP_S_MAX and bool(_library().ctc_loss_beta_grad_warp_fits(L, C))


def _lattice(targets, target_lengths, S, C, blank):
    """Per-row lattice: state classes (B, S), skip flags (B, S) and the mask
    of states inside the row's own lattice (s < 2*ylen+1)."""
    ext = interleave_blanks(targets.long().clamp(0, C - 1), blank)
    skip = _diff_labels(ext, blank)
    states = torch.arange(S, device=targets.device)
    in_row = states[None, :] < (2 * target_lengths.long()[:, None] + 1)
    return ext, skip, in_row


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _final_ll(last, target_lengths):
    """logsumexp of the two end states 2*ylen-1 and 2*ylen of (B, S) alpha;
    -1e30 where both are out of reach."""
    ylen = target_lengths.long()
    a1 = last.gather(1, (2 * ylen - 1).clamp(min=0)[:, None])[:, 0]
    a1 = torch.where(ylen > 0, a1, NEG_INF)
    a2 = last.gather(1, (2 * ylen)[:, None])[:, 0]
    m = torch.maximum(a1, a2)
    return torch.where(m <= NEG_INF / 2, NEG_INF,
                       m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)))


def alpha_plain(log_probs, targets, input_lengths, target_lengths, blank: int,
                take_frame0: bool = False):
    """The alpha kernel in plain PyTorch -> (alpha (B, T, 2L+1), ll (B,)),
    float32. Frames past xlen repeat the last alpha.

    take_frame0: frame 0 starts every row, even one with xlen = 0, whose ll
    then comes from frame 0 (the whole-T kernel's rule, ops/ctc_loss_whole_t.py);
    by default such a row keeps -1e30 (this module's kernels)."""
    B, T, C = log_probs.shape
    L = targets.shape[1]
    S = 2 * L + 1
    ylen = target_lengths.long().clamp(0, L)
    ext, skip, in_row = _lattice(targets, ylen, S, C, blank)
    xlen = input_lengths.long().clamp(0, T)
    lp = log_probs.to(torch.float32)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=lp.device)
    states = torch.arange(S, device=lp.device)

    def emissions(t):
        return torch.where(in_row, lp[:, t].gather(1, ext), neg)

    alpha = torch.full((B, T, S), NEG_INF, dtype=torch.float32, device=lp.device)
    if T == 0:
        return alpha, torch.full((B,), NEG_INF, device=lp.device)
    a = torch.where((states[None, :] <= 1) & ((xlen > 0) | take_frame0)[:, None], emissions(0),
                    neg)
    alpha[:, 0] = a
    for t in range(1, T):
        prev2 = torch.where(skip, _shift(a, 2), neg)
        new = torch.maximum(_lse3(a, _shift(a, 1), prev2) + emissions(t), neg)
        a = torch.where((t < xlen)[:, None], new, a)
        alpha[:, t] = a
    last = alpha[torch.arange(B, device=lp.device), (xlen - 1).clamp(min=0)]
    return alpha, _final_ll(last, ylen)


def beta_grad_plain(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                    blank: int):
    """The beta/gradient kernel in plain PyTorch -> (B, T, C) float32:
    g[b] * d loss[b] / d log_probs for feasible rows, 0 elsewhere and past
    xlen."""
    B, T, C = log_probs.shape
    L = targets.shape[1]
    S = 2 * L + 1
    ylen = target_lengths.long().clamp(0, L)
    ext, skip, in_row = _lattice(targets, ylen, S, C, blank)
    skip_next2 = torch.zeros_like(skip)
    skip_next2[:, :-2] = skip[:, 2:]
    xlen = input_lengths.long().clamp(0, T)
    lp = log_probs.to(torch.float32)
    dev = lp.device
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    states = torch.arange(S, device=dev)
    ends = (states[None, :] == 2 * ylen[:, None] - 1) | (states[None, :] == 2 * ylen[:, None])
    init = torch.where(ends, 0.0, neg)
    scale = torch.where(ll > NEG_INF / 2, -g.to(torch.float32), 0.0)

    def shift_left(x, k):
        return torch.cat([x[:, k:], torch.full_like(x[:, :k], NEG_INF)], dim=1)

    grad = torch.zeros((B, T, C), dtype=torch.float32, device=dev)
    beta = torch.full((B, S), NEG_INF, dtype=torch.float32, device=dev)
    for t in range(T - 1, -1, -1):
        beta = torch.where((t == xlen - 1)[:, None], init, beta)
        active = (t < xlen)[:, None]
        gamma = torch.exp(torch.clamp(alpha[:, t] + beta - ll[:, None], -80.0, 80.0))
        per_class = torch.zeros((B, C), dtype=torch.float32, device=dev).scatter_add_(
            1, ext, gamma)
        grad[:, t] = torch.where(active, scale[:, None] * per_class, 0.0)
        bterm = beta + torch.where(in_row, lp[:, t].gather(1, ext), neg)
        next2 = torch.where(skip_next2, shift_left(bterm, 2), neg)
        new = torch.maximum(_lse3(bterm, shift_left(bterm, 1), next2), neg)
        beta = torch.where(active, new, beta)
    return grad


def _launch_alpha(log_probs, targets, input_lengths, target_lengths, blank, depth):
    """One launch of the forward kernel with a ring of at most `depth` frames."""
    lp, y, xlen, ylen = check_lattice_inputs(log_probs, targets, input_lengths, target_lengths,
                                             blank, 'ctc_loss_alpha')
    B, T, C = lp.shape
    L = y.shape[1]
    alpha = torch.empty((B, T, 2 * L + 1), dtype=torch.float32, device=lp.device)
    ll = torch.empty((B,), dtype=torch.float32, device=lp.device)
    if B == 0 or T == 0:
        return alpha, ll.fill_(NEG_INF)
    # the ring takes frames in 16-byte pieces from a tensor that starts on 16
    # bytes (the allocator's do; a view may not)
    lp = lp if lp.data_ptr() % 16 == 0 else lp.clone()
    with torch.cuda.device(lp.device):
        rc = _library().ctc_loss_alpha(
            lp.data_ptr(), y.data_ptr(), xlen.data_ptr(), ylen.data_ptr(), B, T, C, L, blank,
            alpha.data_ptr(), ll.data_ptr(), depth,
            torch.cuda.current_stream(lp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'ctc_loss_alpha: CUDA error {rc} at launch')
    return alpha, ll


def alpha_kernel(log_probs, targets, input_lengths, target_lengths, blank: int):
    """csrc/ctc_loss.cu forward on the card -> (alpha (B, T, 2L+1), ll (B,)),
    its log-prob frames through a ring of ALPHA_DEPTH frames."""
    global ALPHA_LAUNCHES
    out = _launch_alpha(log_probs, targets, input_lengths, target_lengths, blank, ALPHA_DEPTH)
    ALPHA_LAUNCHES += bool(log_probs.shape[0] and log_probs.shape[1])
    return out


def _alpha_depth(log_probs, targets, input_lengths, target_lengths, blank: int, depth: int):
    """The forward kernel with a ring of `depth` frames (2, 4, 8, 16 or 32),
    for measurements. Counts no launch."""
    return _launch_alpha(log_probs, targets, input_lengths, target_lengths, blank, depth)


def _beta_grad_inputs(log_probs, targets, input_lengths, target_lengths, alpha, ll, g, blank,
                      op):
    lp, y, xlen, ylen = check_lattice_inputs(log_probs, targets, input_lengths, target_lengths,
                                             blank, op)
    B, T, C = lp.shape
    L = y.shape[1]
    if alpha.shape != (B, T, 2 * L + 1) or ll.shape != (B,) or g.shape != (B,):
        raise ValueError('alpha must be (B, T, 2L+1), ll and g (B,)')
    alpha = alpha.to(torch.float32).contiguous()
    ll = ll.to(torch.float32).contiguous()
    g = g.to(device=lp.device, dtype=torch.float32).contiguous()  # mean() gives stride 0
    return lp, y, xlen, ylen, alpha, ll, g


def _launch_beta_grad(inputs, blank, route):
    """One launch of a backward kernel of csrc/ctc_loss.cu: route 'warp' or
    'block'."""
    lp, y, xlen, ylen, alpha, ll, g = inputs
    B, T, C = lp.shape
    L = y.shape[1]
    grad = torch.empty((B, T, C), dtype=torch.float32, device=lp.device)
    if B == 0 or T == 0:
        return grad
    if route == 'warp':
        # the warp kernel copies frames in 16-byte pieces from a tensor that
        # starts on 16 bytes (the allocator's are; a view may not be)
        lp, alpha = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (lp, alpha))
    lib = _library()
    args = [lp.data_ptr(), y.data_ptr(), xlen.data_ptr(), ylen.data_ptr(), alpha.data_ptr(),
            ll.data_ptr(), g.data_ptr(), B, T, C, L, blank, grad.data_ptr()]
    stream = torch.cuda.current_stream(lp.device).cuda_stream
    with torch.cuda.device(lp.device):
        fn = lib.ctc_loss_beta_grad_warp if route == 'warp' else lib.ctc_loss_beta_grad
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f'ctc_loss_beta_grad ({route}): CUDA error {rc} at launch')
    return grad


def beta_grad_kernel(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                     blank: int):
    """csrc/ctc_loss.cu backward on the card -> (B, T, C) float32: the warp
    kernel where `beta_grad_warp_fits` takes the lattice, the block kernel
    elsewhere."""
    global BETA_GRAD_LAUNCHES, BETA_GRAD_WARP_LAUNCHES
    inputs = _beta_grad_inputs(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                               blank, 'ctc_loss_beta_grad')
    lp, y = inputs[:2]
    warp = beta_grad_warp_fits(y.shape[1], lp.shape[2])
    grad = _launch_beta_grad(inputs, blank, 'warp' if warp else 'block')
    if lp.shape[0] and lp.shape[1]:
        if warp:
            BETA_GRAD_WARP_LAUNCHES += 1
        else:
            BETA_GRAD_LAUNCHES += 1
    return grad


def _beta_grad_route(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                     blank: int, route: str):
    """One backward kernel whatever the rule says ('warp' or 'block'), for
    measurements. Counts no launch."""
    inputs = _beta_grad_inputs(log_probs, targets, input_lengths, target_lengths, alpha, ll, g,
                               blank, 'ctc_loss_beta_grad')
    return _launch_beta_grad(inputs, blank, route)


class CTCLoss(torch.autograd.Function):
    """Per-row CTC loss (B,) with its gradient: the kernels on CUDA tensors,
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths, blank: int):
        forward = alpha_kernel if log_probs.is_cuda else alpha_plain
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


def ctc_loss_auto(log_probs: torch.Tensor, targets: torch.Tensor,
                  input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                  blank: typing.Optional[int] = None) -> torch.Tensor:
    """Per-row CTC loss (B,): the kernels for CUDA tensors, the plain
    versions for CPU tensors. blank defaults to C-1."""
    blank = log_probs.shape[-1] - 1 if blank is None else int(blank)
    return CTCLoss.apply(log_probs, targets, input_lengths, target_lengths, blank)
