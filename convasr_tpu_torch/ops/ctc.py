"""CTC loss, forced alignment and greedy decoding in plain PyTorch
(counterpart of convasr_tpu/ops/ctc.py).

`ctc_alignment` is the CPU path of ops/align.py and the oracle that the CUDA
Viterbi kernel (csrc/ctc_viterbi.cu) is held against. It computes exactly
what the kernel computes: the max-product recursion over the
blank-interleaved lattice, with backpointers 0 = stay, 1 = from s-1,
2 = from s-2 chosen by strict `>` in that order (ties keep the lower move),
then a backtrace to the frame of each target char. Only maxima and float32
additions are involved, so the two agree bit for bit.

States beyond a row's own lattice (s >= 2*ylen+1) get -1e30 emissions, as in
the JAX package's Pallas kernel; they can never feed the states the
backtrace visits, so the char frames equal those of the JAX scan.

`ctc_loss` is the JAX package's time scan, with the gradient from autograd
through a Python loop over frames: the oracle of the plain versions beside
the CTC loss kernels (ops/ctc_loss.py). It follows the scan, not the TPU
kernel, where the two differ: a row with xlen = 0 still takes frame 0 and
gets a finite loss.
"""
import typing

import torch

NEG_INF = -1e30


def interleave_blanks(targets: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, L) targets -> (B, 2L+1) lattice [blank, t0, blank, t1, ..., blank]."""
    B, L = targets.shape
    ext = torch.full((B, 2 * L + 1), blank, dtype=targets.dtype, device=targets.device)
    ext[:, 1::2] = targets
    return ext


def _diff_labels(ext_targets: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, S) mask: state s may receive a skip transition from s-2 (its label
    differs from the label two states back)."""
    diff = torch.zeros(ext_targets.shape, dtype=torch.bool, device=ext_targets.device)
    diff[:, 2:] = ext_targets[:, 2:] != ext_targets[:, :-2]
    return diff


def _shift(alpha, k):
    return torch.cat([torch.full_like(alpha[:, :k], NEG_INF), alpha[:, :-k]], dim=1)


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             input_lengths: torch.Tensor, target_lengths: torch.Tensor,
             blank: typing.Optional[int] = None) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood, (B,) float32; +inf where no
    alignment fits (ops/ctc.py:44-106 of the JAX package).

    log_probs: (B, T, C) log-softmax outputs; targets: (B, L) padded labels;
    input_lengths and target_lengths: (B,) ints. blank defaults to C-1."""
    B, T, C = log_probs.shape
    L = targets.shape[1]
    blank = C - 1 if blank is None else blank
    ext = interleave_blanks(targets.long(), blank)
    can_skip = _diff_labels(ext, blank)
    lp = log_probs.to(torch.float32)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=lp.device)

    first = [lp[:, 0, blank:blank + 1]] + ([lp[:, 0].gather(1, ext[:, 1:2])] if L else [])
    alpha = torch.cat(first + [torch.full((B, 2 * L + 1 - len(first)), NEG_INF,
                                          device=lp.device)], dim=1)
    for t in range(1, T):
        stacked = torch.stack([alpha, _shift(alpha, 1),
                               torch.where(can_skip, _shift(alpha, 2), neg)])
        m = stacked.max(dim=0).values
        lse = m + torch.log(torch.exp(stacked - m[None]).sum(dim=0))
        lse = torch.where(m <= NEG_INF / 2, neg, lse)
        new = torch.maximum(lse + lp[:, t].gather(1, ext), neg)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)

    ylen = target_lengths.long()
    a1 = alpha.gather(1, (2 * ylen - 1).clamp(min=0)[:, None])[:, 0]
    a2 = alpha.gather(1, (2 * ylen)[:, None])[:, 0]
    m = torch.maximum(a1, a2)
    ll = m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m))
    ll = torch.where(ylen == 0, a2, ll)
    ll = torch.where(ll <= NEG_INF / 2, torch.full_like(ll, -float('inf')), ll)
    return -ll


def viterbi(log_probs, targets, input_lengths, target_lengths, blank: int):
    """Max-product forward pass -> (backpointers (B, T, S) int8, alpha at each
    row's last valid frame (B, S) float32). Rows freeze past their length;
    backpointers there and at t = 0 are 0."""
    B, T, C = log_probs.shape
    L = targets.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    ext = interleave_blanks(targets.long(), blank)
    skip = _diff_labels(ext, blank)
    states = torch.arange(S, device=dev)
    in_row = states[None, :] < (2 * target_lengths.long()[:, None] + 1)
    xlen = input_lengths.long().clamp(max=T)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    def emissions(t):
        e = log_probs[:, t].to(torch.float32).gather(1, ext)
        return torch.where(in_row, e, neg)

    alpha = torch.where(states[None, :] <= 1, emissions(0), neg) if T else \
        torch.full((B, S), NEG_INF, device=dev)
    alpha = torch.where((xlen > 0)[:, None], alpha, neg)
    bp = torch.zeros((B, T, S), dtype=torch.int8, device=dev)
    for t in range(1, T):
        prev1 = _shift(alpha, 1)
        prev2 = torch.where(skip, _shift(alpha, 2), neg)
        best = torch.where(prev1 > alpha, 1, 0)
        val = torch.maximum(alpha, prev1)
        best = torch.where(prev2 > val, 2, best)
        val = torch.maximum(val, prev2)
        new = torch.maximum(val + emissions(t), neg)
        active = (t < xlen)[:, None]
        alpha = torch.where(active, new, alpha)
        bp[:, t] = torch.where(active, best, 0).to(torch.int8)
    return bp, alpha


def backtrace(bp, final_alpha, input_lengths, target_lengths, L: int):
    """Backpointers + final alpha -> frame index of each target char, (B, L):
    the last frame whose state is 2l+1 (0 where none)."""
    B, T, S = bp.shape
    xlen = input_lengths.long().clamp(max=T)
    ylen = target_lengths.long()
    end1, end2 = 2 * ylen - 1, 2 * ylen
    a1 = final_alpha.gather(1, end1.clamp(min=0)[:, None])[:, 0]
    a2 = final_alpha.gather(1, end2[:, None])[:, 0]
    state = torch.where(ylen == 0, end2, torch.where(a1 >= a2, end1, end2))
    frames = torch.zeros((B, max(L, 1)), dtype=torch.int64, device=bp.device)
    for t in range(T - 1, -1, -1):
        active = t < xlen
        hit = active & (state % 2 == 1)
        frames.scatter_reduce_(1, (state // 2).clamp(0, max(L - 1, 0))[:, None],
                               torch.where(hit, t, 0)[:, None], reduce='amax')
        if t > 0:
            move = bp[:, t].gather(1, state[:, None])[:, 0].long()
            state = torch.where(active, state - move, state)
    return frames[:, :L].to(torch.int32)


def ctc_alignment(log_probs: torch.Tensor, targets: torch.Tensor,
                  input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                  blank: typing.Optional[int] = None, return_final: bool = False):
    """Viterbi forced alignment -> frame index of each target char, (B, L)
    int32 (and, with return_final, each row's final alpha (B, 2L+1)).

    log_probs: (B, T, C); targets: (B, L) padded labels; input_lengths and
    target_lengths: (B,) ints. blank defaults to C-1."""
    blank = log_probs.shape[-1] - 1 if blank is None else blank
    bp, final = viterbi(log_probs, targets, input_lengths, target_lengths, blank)
    frames = backtrace(bp, final, input_lengths, target_lengths, targets.shape[1])
    return (frames, final) if return_final else frames


def greedy_decode(log_probs: torch.Tensor, output_lengths=None, K: int = 1):
    """Top-K class indices per frame."""
    if K == 1:
        return log_probs.argmax(dim=-1)
    return log_probs.topk(K, dim=-1).indices
