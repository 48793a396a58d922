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
