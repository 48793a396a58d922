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


# --- int8 conv and GEMM kernels (csrc/int8_conv.cu, csrc/int8_gemm.cu) ------

def int8_tensors(seed, *shapes, full=False):
    rng = np.random.RandomState(seed)
    if full:                          # all +-127: the largest sums
        return [torch.from_numpy(np.where(rng.rand(*s) < 0.5, -127, 127).astype(np.int8))
                for s in shapes]
    return [torch.from_numpy(rng.randint(-128, 128, size=s).astype(np.int8)) for s in shapes]


INT8_CONV_CASES = dict(
    prologue=dict(B=8, T=601, Cin=64, Cout=256, K=11, stride=2),        # the path's shapes
    block10_k25=dict(B=8, T=301, Cin=640, Cout=768, K=25),
    epilogue_k29=dict(B=8, T=301, Cin=768, Cout=896, K=29),
    overflow_edge=dict(B=1, T=70, Cin=768, Cout=8, K=29, full=True),
    dilation2=dict(B=2, T=77, Cin=32, Cout=40, K=11, dilation=2),
    ragged=dict(B=3, T=37, Cin=13, Cout=6, K=11),                       # the mma.sync loop
    ragged_cout=dict(B=2, T=45, Cin=48, Cout=38, K=5, stride=2),
    t_shorter_than_k=dict(B=2, T=9, Cin=16, Cout=16, K=29),
    # the wgmma kernel's edges: BM = 128 output rows, BN 128 or 192, 128-channel chunks
    t_out_127=dict(B=2, T=127, Cin=128, Cout=128, K=11),
    t_out_128=dict(B=2, T=128, Cin=128, Cout=192, K=13),
    t_out_129=dict(B=3, T=129, Cin=256, Cout=136, K=11),
    halo_past_both_ends_k29=dict(B=2, T=20, Cin=256, Cout=200, K=29),
    batch_1=dict(B=1, T=301, Cin=256, Cout=384, K=13),
    batch_9=dict(B=9, T=150, Cin=384, Cout=512, K=17),
    cout_896=dict(B=2, T=260, Cin=512, Cout=896, K=21),
    cout_38=dict(B=3, T=140, Cin=640, Cout=38, K=25),
    cin_16=dict(B=2, T=200, Cin=16, Cout=64, K=11),
    cin_48=dict(B=2, T=131, Cin=48, Cout=128, K=13),
    cin_640_k1=dict(B=2, T=257, Cin=640, Cout=96, K=1),
    stride2_odd_t=dict(B=3, T=257, Cin=64, Cout=256, K=11, stride=2),
    stride2_dilation2=dict(B=2, T=300, Cin=128, Cout=64, K=13, stride=2, dilation=2),
    dilation2_k29=dict(B=2, T=200, Cin=128, Cout=128, K=29, dilation=2),
    overflow_edge_wide=dict(B=2, T=140, Cin=768, Cout=200, K=29, full=True),
    stride3_mma_sync=dict(B=2, T=50, Cin=32, Cout=16, K=5, stride=3),
)
# one case per distinct (K, Cin, Cout, stride) of the 32 convs with taps of
# JasperNetBig's int8 path, at its batch of 8 six-second segments
PATH_CONVS = [(11, 64, 256, 2), (11, 256, 256, 1), (13, 256, 256, 1), (13, 256, 384, 1),
              (13, 384, 384, 1), (17, 384, 384, 1), (17, 384, 512, 1), (17, 512, 512, 1),
              (21, 512, 512, 1), (21, 512, 640, 1), (21, 640, 640, 1), (25, 640, 640, 1),
              (25, 640, 768, 1), (25, 768, 768, 1), (29, 768, 896, 1)]
INT8_CONV_CASES.update({f'path_k{K}_{Cin}_{Cout}_s{s}': dict(B=8, T=601 if s == 2 else 301,
                                                             Cin=Cin, Cout=Cout, K=K, stride=s)
                        for K, Cin, Cout, s in PATH_CONVS})


def conv_case_tensors(case, card):
    c = dict(INT8_CONV_CASES[case])
    x, w = int8_tensors(sorted(INT8_CONV_CASES).index(case), (c['B'], c['T'], c['Cin']),
                        (c['K'], c['Cin'], c['Cout']), full=c.get('full', False))
    return x.to(card), w.to(card), c.get('stride', 1), c.get('dilation', 1)


@pytest.mark.parametrize('case', INT8_CONV_CASES)
def test_int8_conv_kernel_equals_plain(card, case):
    """Bit-equal to the float64 plain version; the counters say which kernel
    ran, as the shape rule says."""
    from convasr_tpu_torch.ops import int8
    x, w, stride, dilation = conv_case_tensors(case, card)
    K, Cin, _ = w.shape
    wgmma = int8.wgmma_conv_fits(x.shape[1], Cin, K, stride, dilation)
    assert wgmma == bool(int8._conv_library().int8_conv1d_wgmma_fits(x.shape[1], Cin, K, stride,
                                                                     dilation))
    assert wgmma == (case not in ('ragged', 'stride3_mma_sync'))
    before = (int8.CONV_LAUNCHES, int8.CONV_MMA_SYNC_LAUNCHES)
    got = int8.int8_conv1d(x, w, stride, dilation)
    want = int8.int8_conv1d_plain(x, w, stride, dilation)
    torch.cuda.synchronize()
    assert (int8.CONV_LAUNCHES, int8.CONV_MMA_SYNC_LAUNCHES) == \
        (before[0] + wgmma, before[1] + (not wgmma))
    assert got.shape == want.shape and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize('case', ['prologue', 'block10_k25', 'epilogue_k29', 't_out_129',
                                  'cout_38', 'cin_48', 'stride2_dilation2', 'overflow_edge_wide'])
def test_int8_conv_mma_sync_loop_past_the_rule_equals_plain(card, case):
    """The mma.sync loop on shapes the rule gives the wgmma kernel (as
    chip_smoke.py times it), on the packed weight and on the JAX layout;
    it counts no launch."""
    from convasr_tpu_torch.ops import int8
    x, w, stride, dilation = conv_case_tensors(case, card)
    packed = int8.pack_conv_weight(w)
    want = int8.int8_conv1d_plain(x, w, stride, dilation)
    before = (int8.CONV_LAUNCHES, int8.CONV_MMA_SYNC_LAUNCHES)
    for got in (int8._int8_conv1d_mma_sync(x, None, stride, dilation, w_packed=packed),
                int8._int8_conv1d_mma_sync(x, w, stride, dilation)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert (int8.CONV_LAUNCHES, int8.CONV_MMA_SYNC_LAUNCHES) == before


def test_int8_conv_packed_weight_is_used_as_given(card):
    from convasr_tpu_torch.ops import int8
    x, w, stride, dilation = conv_case_tensors('batch_1', card)
    packed = int8.pack_conv_weight(w)
    packs = int8.CONV_WEIGHT_PACKS
    got = int8.int8_conv1d_auto(x, None, stride, dilation, w_packed=packed)
    assert int8.CONV_WEIGHT_PACKS == packs and torch.equal(got, int8.int8_conv1d_plain(x, w))
    with pytest.raises(ValueError, match='not one weight'):
        int8.int8_conv1d(x, w[:, :, :8].contiguous(), w_packed=packed)


INT8_GEMM_CASES = dict(
    block1_res0=dict(M=2408, K=256, N=256),                  # whole-K on the path
    block6_fused=dict(M=2408, K=1792, N=512),
    head=dict(M=2408, K=1024, N=38),
    ragged_whole_k=dict(M=7, K=13, N=38),
    block10_fused=dict(M=2408, K=4096, N=768),               # K-tiled on the path
    ragged_k_tiled=dict(M=33, K=1801, N=17),
    overflow_edge=dict(M=70, K=4096, N=16, full=True),
)


@pytest.mark.parametrize('case', INT8_GEMM_CASES)
def test_int8_gemm_kernels_equal_plain(card, case):
    from convasr_tpu_torch.ops import int8
    c = INT8_GEMM_CASES[case]
    a, b = (t.to(card) for t in int8_tensors(20 + sorted(INT8_GEMM_CASES).index(case),
                                             (c['M'], c['K']), (c['K'], c['N']),
                                             full=c.get('full', False)))
    whole_k = c['K'] <= int8.WHOLE_K_MAX
    before = (int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_K_TILED_LAUNCHES)
    got = int8.int8_matmul(a, b)
    want = int8.int8_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert (int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_K_TILED_LAUNCHES) == \
        (before[0] + whole_k, before[1] + (not whole_k))
    assert torch.equal(got, want)


def test_int8_auto_dispatch_counts_each_variant(card):
    from convasr_tpu_torch.ops import int8
    x, w = (t.to(card) for t in int8_tensors(30, (2, 20, 16), (3, 16, 8)))
    a, b_short, b_deep = (t.to(card) for t in int8_tensors(31, (5, 2000), (16, 8), (2000, 8)))
    before = (int8.CONV_LAUNCHES, int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_K_TILED_LAUNCHES)
    int8.int8_conv1d_auto(x, w)
    int8.int8_matmul_auto(a[:, :16].contiguous(), b_short)
    int8.int8_matmul_auto(a, b_deep)
    torch.cuda.synchronize()
    assert (int8.CONV_LAUNCHES, int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_K_TILED_LAUNCHES) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)


def test_int8_forward_on_card_matches_cpu(card):
    """The same quantized tree on the card and on the CPU. The int8 products
    are exact on both; the float32 instance norm and log_softmax sum in
    another order, and a value within an ulp of a .5 boundary flips one int8
    step: log-probs within 1e-3, greedy ids >= 99% equal."""
    from convasr_tpu_torch.models import quantized
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.ops import int8
    torch.manual_seed(0)
    model = create_model('JasperNetBig', 16, (38,), base_width=8).eval()
    rng = np.random.RandomState(40)
    x = torch.from_numpy(rng.randn(2, 96, 16).astype(np.float32))
    xlen = torch.tensor([1.0, 0.625])
    qtree = quantized.quantize(model, [dict(x=x.numpy(), xlen=xlen.numpy())])
    cpu = quantized.quantized_apply(model, qtree, x, xlen)['log_probs'][0]
    model.to(card)
    tree = quantized.to_device(qtree, card)     # packs the 32 conv weights once
    before = (int8.CONV_LAUNCHES + int8.CONV_MMA_SYNC_LAUNCHES, int8.GEMM_WHOLE_K_LAUNCHES,
              int8.CONV_WEIGHT_PACKS)
    on_card = quantized.quantized_apply(model, tree, x.to(card),
                                        xlen.to(card))['log_probs'][0].cpu()
    # at base width 8 some convs have Cin 24 or 40 and take the mma.sync loop
    assert int8.CONV_LAUNCHES + int8.CONV_MMA_SYNC_LAUNCHES == before[0] + 32
    assert int8.GEMM_WHOLE_K_LAUNCHES == before[1] + 12 and int8.CONV_WEIGHT_PACKS == before[2]
    np.testing.assert_allclose(on_card.numpy(), cpu.numpy(), rtol=0, atol=1e-3)
    assert (on_card.argmax(-1) == cpu.argmax(-1)).float().mean() >= 0.99


# --- whole-T CTC loss kernels K2f/K2b (csrc/ctc_loss_whole_t.cu) -----------

WHOLE_T_CASES = dict(
    base=dict(seed=40),                                        # ragged xlen and ylen
    odd_rows=dict(seed=41, B=3, T=19),                         # rows not 16-byte aligned
    zero_input_length=dict(seed=42, B=3, T=24, zero_xlen_row=True),
    infeasible_row=dict(seed=43, B=4, T=28, L=6, infeasible_row=True),
    non_last_blank=dict(seed=44, B=4, T=26, C=9, L=6, blank=0),
    repeated_labels=dict(seed=45, B=6, T=40, C=5, L=8, repeated=True),
    many_states=dict(seed=46, B=3, T=120, C=40, L=700),        # 1401 states: 2 per thread
    guard_edge=dict(seed=47, B=2, T=1521, C=38, L=60),         # the largest T that fits
)


@pytest.mark.parametrize('case', WHOLE_T_CASES)
def test_whole_t_kernels_equal_plain(card, case):
    from convasr_tpu_torch.ops import ctc_loss, ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = loss_batch(**WHOLE_T_CASES[case])
    if case == 'zero_input_length':               # also a row of xlen 0 that takes frame 0
        xlen[0], ylen[0] = 0, 1
    g = torch.from_numpy(np.random.RandomState(2).uniform(0.5, 1.5, lp.shape[0]).astype(np.float32))
    alpha, ll = k2.alpha_whole_t_plain(lp, y, xlen, ylen, blank)
    grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, alpha, ll, g, blank)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    before = (k2.ALPHA_LAUNCHES, k2.BETA_GRAD_LAUNCHES)
    k_alpha, k_ll = k2.alpha_kernel(*on_card, blank)
    k_grad = k2.beta_grad_kernel(*on_card, k_alpha, k_ll, g.to(card), blank)
    torch.cuda.synchronize()
    assert (k2.ALPHA_LAUNCHES, k2.BETA_GRAD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    feasible = ll > -5e29
    assert torch.equal(k_ll.cpu() > -5e29, feasible)
    if case == 'zero_input_length':
        assert feasible[0] and feasible[-1]       # frame 0 gives rows of xlen 0 an ll
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(k_ll.cpu()[feasible].numpy(), ll[feasible].numpy(), rtol=1e-5)
    # gamma in [0, 1] summed per class with shared-memory atomics in any order
    np.testing.assert_allclose(k_grad.cpu().numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (k_grad.cpu()[~feasible | (xlen == 0)] == 0).all()


def test_whole_t_guard_raises_on_the_card(card):
    from convasr_tpu_torch.ops import ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = loss_batch(seed=48, B=1, T=1522, C=38, L=60)
    assert not k2.smem_fits(1522, 60, 38)
    before = k2.ALPHA_LAUNCHES
    with pytest.raises(ValueError, match='shared memory'):
        k2.ctc_loss_whole_t(*(t.to(card) for t in (lp, y, xlen, ylen)))
    assert k2.ALPHA_LAUNCHES == before


def test_ctc_loss_whole_t_runs_both_kernels(card):
    from convasr_tpu_torch.ops import ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = loss_batch(seed=49, B=5, T=33, zero_xlen_row=True)
    x = lp.to(card).requires_grad_()
    before = (k2.ALPHA_LAUNCHES, k2.BETA_GRAD_LAUNCHES)
    loss = k2.ctc_loss_whole_t(x, *(t.to(card) for t in (y, xlen, ylen)), blank=blank)
    loss.mean().backward()            # an expanded (stride 0) cotangent
    torch.cuda.synchronize()
    assert (k2.ALPHA_LAUNCHES, k2.BETA_GRAD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    x_cpu = lp.clone().requires_grad_()
    ref = k2.ctc_loss_whole_t(x_cpu, y, xlen, ylen, blank=blank)
    ref.mean().backward()
    assert torch.isfinite(ref).all()  # the row of xlen 0 and ylen 0 takes frame 0's blank
    np.testing.assert_allclose(loss.detach().cpu().numpy(), ref.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.cpu().numpy(), x_cpu.grad.numpy(), rtol=1e-3, atol=1e-4)


# --- device beam (ops/beam_device.py) on the card against the CPU ----------

@pytest.mark.parametrize('with_lm', [False, True], ids=['no_lm', 'char_bigram'])
def test_device_beam_on_card_equals_cpu(card, with_lm):
    """Tokens and lengths bit-equal, scores within 1e-4: the same float32
    operations; expf/logf of the card and of the CPU differ in the last bit."""
    from convasr_tpu_torch.ops import beam_device
    rng = np.random.RandomState(50)
    B, T, C = 4, 60, 38
    lp = torch.log_softmax(torch.from_numpy(rng.randn(B, T, C).astype(np.float32) * 3), -1)
    lengths = torch.tensor([60, 41, 60, 7])
    kw = dict(beam_width=16, cutoff_top_n=8, max_len=T + 1)
    if with_lm:
        kw.update(lm_table=torch.from_numpy(rng.randn(C, C - 1).astype(np.float32) - 3),
                  lm_alpha=0.5, lm_beta=0.2)
    cpu = beam_device.beam_search_device(lp, lengths, C - 1, **kw)
    on_card = beam_device.beam_search_device(lp.to(card), lengths.to(card), C - 1, **kw)
    assert all(t.is_cuda for t in on_card)
    assert torch.equal(on_card[0].cpu(), cpu[0]) and torch.equal(on_card[1].cpu(), cpu[1])
    np.testing.assert_allclose(on_card[2].cpu().numpy(), cpu[2].numpy(), rtol=0, atol=1e-4)
