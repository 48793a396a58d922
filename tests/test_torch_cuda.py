"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it also runs where only the port is installed:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Without a card every test skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from convasr_tpu_torch.ops import align
from convasr_tpu_torch.ops.ctc import ctc_alignment

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda')


def make_batch(seed, B=4, T=24, C=7, L=5, blank=None, empty_row=False, full_row=True):
    rng = np.random.RandomState(seed)
    blank = C - 1 if blank is None else blank
    lp = torch.log_softmax(torch.from_numpy(rng.randn(B, T, C).astype(np.float32)), -1)
    labels = [c for c in range(C) if c != blank]
    y = rng.choice(labels, size=(B, L)).astype(np.int32)
    xlen = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    if full_row:
        xlen[0] = T
    ylen = rng.randint(1, L + 1, size=B).astype(np.int32)
    if empty_row:
        ylen[-1] = 0
    return lp, torch.from_numpy(y), torch.from_numpy(xlen), torch.from_numpy(ylen), blank


CASES = dict(
    base=dict(seed=0),
    odd_batch_and_time=dict(seed=1, B=3, T=19),
    empty_targets=dict(seed=2, B=5, T=21, empty_row=True),
    short_rows=dict(seed=3, B=4, T=30, C=6, L=6, full_row=False),
    non_last_blank=dict(seed=4, B=4, T=26, C=9, L=6, blank=0),
    repeated_labels=dict(seed=5, B=6, T=40, C=3, L=8, blank=1),
    many_states=dict(seed=6, B=3, T=700, C=40, L=700),   # 1401 states: 2 per thread
    states_16_per_thread=dict(seed=9, B=2, T=40, C=38, L=7000),
    states_32_per_thread=dict(seed=10, B=2, T=30, C=38, L=14000),  # near the shared-memory limit
)


@pytest.mark.parametrize('case', CASES)
def test_viterbi_kernel_equals_plain(card, case):
    lp, y, xlen, ylen, blank = make_batch(**CASES[case])
    frames, final = ctc_alignment(lp, y, xlen, ylen, blank=blank, return_final=True)
    before = align.KERNEL_LAUNCHES
    k_frames, k_final = align.ctc_alignment_kernel(
        *(t.to(card) for t in (lp, y, xlen, ylen)), blank=blank, return_final=True)
    torch.cuda.synchronize()
    assert align.KERNEL_LAUNCHES == before + 1
    np.testing.assert_array_equal(k_frames.cpu().numpy(), frames.numpy())
    np.testing.assert_array_equal(k_final.cpu().numpy(), final.numpy())


def test_viterbi_kernel_refuses_too_many_states(card):
    lp, y, xlen, ylen, blank = make_batch(seed=7, B=1, T=4, L=30000)
    with pytest.raises(ValueError, match='shared memory'):
        align.ctc_alignment_kernel(*(t.to(card) for t in (lp, y, xlen, ylen)))


def test_auto_dispatches_to_kernel(card):
    lp, y, xlen, ylen, blank = make_batch(seed=8)
    before = align.KERNEL_LAUNCHES
    out = align.ctc_alignment_auto(*(t.to(card) for t in (lp, y, xlen, ylen)), blank=blank)
    assert out.is_cuda and align.KERNEL_LAUNCHES == before + 1


# --- CTC loss kernels (csrc/ctc_loss.cu) -----------------------------------

def loss_batch(seed, B=4, T=30, C=7, L=5, blank=None, empty_row=False, infeasible_row=False,
               zero_xlen_row=False, repeated=False):
    lp, y, xlen, ylen, blank = make_batch(seed, B=B, T=T, C=C, L=L, blank=blank,
                                          empty_row=empty_row)
    if repeated:                      # runs of one label: skips are barred there
        y[:, 1::2] = y[:, 0:-1:2]
    if infeasible_row:                # 2*ylen+1 states cannot fit into 3 frames
        xlen[1], ylen[1] = 3, L
    if zero_xlen_row:
        xlen[-1], ylen[-1] = 0, 0
    return lp, y, xlen, ylen, blank


LOSS_CASES = dict(
    base=dict(seed=20),
    odd_batch_and_time=dict(seed=21, B=3, T=19),
    empty_target=dict(seed=22, B=5, T=25, empty_row=True),
    non_last_blank=dict(seed=23, B=4, T=26, C=9, L=6, blank=0),
    repeated_labels=dict(seed=24, B=6, T=40, C=5, L=8, repeated=True),
    infeasible_row=dict(seed=25, B=4, T=28, L=6, infeasible_row=True),
    zero_input_length=dict(seed=26, B=3, T=24, zero_xlen_row=True),
    many_states=dict(seed=27, B=3, T=400, C=40, L=700),        # 1401 states: 2 per thread
)


@pytest.mark.parametrize('case', LOSS_CASES)
def test_ctc_loss_kernels_equal_plain(card, case):
    from convasr_tpu_torch.ops import ctc_loss
    lp, y, xlen, ylen, blank = loss_batch(**LOSS_CASES[case])
    g = torch.from_numpy(np.random.RandomState(1).uniform(0.5, 1.5, lp.shape[0]).astype(np.float32))
    alpha, ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
    grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, alpha, ll, g, blank)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    before = (ctc_loss.ALPHA_LAUNCHES, ctc_loss.BETA_GRAD_LAUNCHES)
    k_alpha, k_ll = ctc_loss.alpha_kernel(*on_card, blank)
    k_grad = ctc_loss.beta_grad_kernel(*on_card, k_alpha, k_ll, g.to(card), blank)
    torch.cuda.synchronize()
    assert (ctc_loss.ALPHA_LAUNCHES, ctc_loss.BETA_GRAD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    feasible = ll > -5e29
    assert torch.equal(k_ll.cpu() > -5e29, feasible)
    # the recursions are the same float32 operations; expf/logf of the card's
    # library and of the CPU's differ in the last bit
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(k_ll.cpu()[feasible].numpy(), ll[feasible].numpy(), rtol=1e-5)
    # gamma in [0, 1] summed per class with shared-memory atomics in any order
    np.testing.assert_allclose(k_grad.cpu().numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (k_grad.cpu()[~feasible] == 0).all()


def test_ctc_loss_auto_runs_both_kernels(card):
    from convasr_tpu_torch.ops import ctc_loss
    lp, y, xlen, ylen, blank = loss_batch(seed=28, B=5, T=33)
    x = lp.to(card).requires_grad_()
    before = (ctc_loss.ALPHA_LAUNCHES, ctc_loss.BETA_GRAD_LAUNCHES)
    loss = ctc_loss.ctc_loss_auto(x, *(t.to(card) for t in (y, xlen, ylen)), blank=blank)
    loss.mean().backward()            # an expanded (stride 0) cotangent
    torch.cuda.synchronize()
    assert (ctc_loss.ALPHA_LAUNCHES, ctc_loss.BETA_GRAD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    x_cpu = lp.clone().requires_grad_()
    ref = ctc_loss.ctc_loss_auto(x_cpu, y, xlen, ylen, blank=blank)
    ref.mean().backward()
    np.testing.assert_allclose(loss.detach().cpu().numpy(), ref.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.cpu().numpy(), x_cpu.grad.numpy(), rtol=1e-3, atol=1e-4)
