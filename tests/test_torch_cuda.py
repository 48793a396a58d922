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


def make_batch(seed, B=4, T=24, C=7, L=5, blank=None, empty_row=False, full_row=True,
               constant=False, repeated=False, xlen_rows=()):
    """A seeded batch. constant: every log-prob equal, so every predecessor
    of every state ties; repeated: runs of one label, where skips are barred;
    xlen_rows: the input lengths of the last rows."""
    rng = np.random.RandomState(seed)
    blank = C - 1 if blank is None else blank
    lp = torch.log_softmax(torch.from_numpy(rng.randn(B, T, C).astype(np.float32)), -1)
    if constant:
        lp = torch.full((B, T, C), -float(np.log(C)), dtype=torch.float32)
    labels = [c for c in range(C) if c != blank]
    y = rng.choice(labels, size=(B, L)).astype(np.int32)
    if repeated:
        y[:, 1::2] = y[:, 0:-1:2]
    xlen = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    if full_row:
        xlen[0] = T
    if xlen_rows:
        xlen[-len(xlen_rows):] = xlen_rows
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
    # every predecessor ties: the strict '>' keeps the lower move everywhere
    tie_heavy=dict(seed=11, B=4, T=20, C=5, L=6, constant=True, repeated=True),
    tie_heavy_skips=dict(seed=12, B=4, T=25, C=7, L=6, constant=True, empty_row=True),
    xlen_0_and_1=dict(seed=13, B=5, T=18, xlen_rows=(0, 1)),
    many_states=dict(seed=6, B=3, T=700, C=40, L=700),   # 1401 states: 2 per thread
    states_16_per_thread=dict(seed=9, B=2, T=40, C=38, L=7000),
    states_32_per_thread=dict(seed=10, B=2, T=30, C=38, L=14000),  # near the shared-memory limit
    # the route's crossover: S = WARP_S_MAX on the warp kernel, the next
    # lattice (S + 2) on the block pair
    crossover=dict(seed=14, B=3, T=90, C=38, L=(align.WARP_S_MAX - 1) // 2),
    past_crossover=dict(seed=15, B=3, T=90, C=38, L=(align.WARP_S_MAX + 1) // 2),
    # T frames of packed backpointers pass shared memory: the warp kernel's
    # spill route, with one word a lane a frame and with two
    spill=dict(seed=16, B=5, T=1900, C=38, L=20),
    spill_two_words=dict(seed=17, B=3, T=1000, C=38, L=300),
    unaligned_view=dict(seed=18, B=4, T=41, C=38, L=12, unaligned=True),
)
# the lattices the route sends to the block pair
VITERBI_BLOCK_CASES = ('many_states', 'states_16_per_thread', 'states_32_per_thread',
                       'past_crossover')


def viterbi_launches():
    return align.WARP_LAUNCHES, align.BLOCK_LAUNCHES


@pytest.mark.parametrize('case', CASES)
def test_viterbi_kernel_equals_plain(card, case):
    """The kernel the route names, bit-equal to the plain version in char
    frames and final alpha, and the warp kernel also wherever it reaches
    (S <= 1024) and the block pair everywhere, as measurement routes that
    count nothing."""
    c = dict(CASES[case])
    unaligned = c.pop('unaligned', False)
    lp, y, xlen, ylen, blank = make_batch(**c)
    frames, final = ctc_alignment(lp, y, xlen, ylen, blank=blank, return_final=True)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    if unaligned:                     # log-probs that do not start on 16 bytes: copied first
        shifted = torch.empty(lp.numel() + 1, device=card)[1:].view(lp.shape)
        shifted.copy_(on_card[0])
        assert shifted.data_ptr() % 16 != 0
        on_card[0] = shifted
    route = align.viterbi_route(y.shape[1], lp.shape[2])
    assert route == ('block' if case in VITERBI_BLOCK_CASES else 'warp')
    before = viterbi_launches()
    k_frames, k_final = align.ctc_alignment_kernel(*on_card, blank=blank, return_final=True)
    torch.cuda.synchronize()
    assert viterbi_launches() == (before[0] + (route == 'warp'), before[1] + (route == 'block'))
    np.testing.assert_array_equal(k_frames.cpu().numpy(), frames.numpy())
    np.testing.assert_array_equal(k_final.cpu().numpy(), final.numpy())
    routes = ['block'] + (['warp'] if 2 * y.shape[1] + 1 <= 1024 else [])
    for other in routes:
        k_frames, k_final = align._alignment_route(*on_card, blank=blank, route=other,
                                                   return_final=True)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(k_frames.cpu().numpy(), frames.numpy())
        np.testing.assert_array_equal(k_final.cpu().numpy(), final.numpy())
    assert viterbi_launches() == (before[0] + (route == 'warp'), before[1] + (route == 'block'))


def test_viterbi_route_at_the_crossover(card):
    """The library's rule agrees with the constant read from the source: the
    warp kernel up to WARP_S_MAX states, the block pair past it; the spill
    route exactly where T frames of packed backpointers pass shared memory."""
    lib = align._library()
    L = (align.WARP_S_MAX - 1) // 2
    assert align.viterbi_route(L, 38) == 'warp' and lib.ctc_viterbi_warp_fits(L, 38) == 1
    assert align.viterbi_route(L + 1, 38) == 'block' and lib.ctc_viterbi_warp_fits(L + 1, 38) == 0
    assert align.viterbi_route(128, 20000) == 'block'     # the warp kernel's ring passes 227 KB
    assert lib.ctc_viterbi_warp_spill_words(301, 128, 38) == 0      # the path's: on chip
    assert lib.ctc_viterbi_warp_spill_words(1500, 400, 38) == 1500 * 64
    assert lib.ctc_viterbi_warp_spill_words(1900, 20, 38) == 1900 * 32


def test_viterbi_kernel_refuses_too_many_states(card):
    lp, y, xlen, ylen, blank = make_batch(seed=7, B=1, T=4, L=30000)
    with pytest.raises(ValueError, match='shared memory'):
        align.ctc_alignment_kernel(*(t.to(card) for t in (lp, y, xlen, ylen)))


def test_auto_dispatches_to_kernel(card):
    lp, y, xlen, ylen, blank = make_batch(seed=8)
    before = viterbi_launches()
    out = align.ctc_alignment_auto(*(t.to(card) for t in (lp, y, xlen, ylen)), blank=blank)
    assert out.is_cuda and viterbi_launches() == (before[0] + 1, before[1])


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
    # the forward's ring of log-prob frames (ALPHA_DEPTH deep)
    t_below_ring_depth=dict(seed=29, B=3, T=3, C=7, L=1),
    t_not_a_ring_multiple=dict(seed=30, B=5, T=37, C=38, L=9),
    unaligned_view=dict(seed=31, B=4, T=41, C=38, L=12, unaligned=True),
    long_row=dict(seed=32, B=2, T=2500, C=38, L=511),
    wide_classes=dict(seed=33, B=3, T=30, C=20000, L=16),      # a ring of 2 frames fits
)
# the lattices the route sends to the block backward kernel
LOSS_BLOCK_CASES = ('many_states', 'wide_classes')


def backward_launches():
    """(forward, warp backward, block backward) launches of csrc/ctc_loss.cu."""
    from convasr_tpu_torch.ops import ctc_loss
    return (ctc_loss.ALPHA_LAUNCHES, ctc_loss.BETA_GRAD_WARP_LAUNCHES,
            ctc_loss.BETA_GRAD_LAUNCHES)


@pytest.mark.parametrize('case', LOSS_CASES)
def test_ctc_loss_kernels_equal_plain(card, case):
    from convasr_tpu_torch.ops import ctc_loss
    c = dict(LOSS_CASES[case])
    unaligned = c.pop('unaligned', False)
    lp, y, xlen, ylen, blank = loss_batch(**c)
    g = torch.from_numpy(np.random.RandomState(1).uniform(0.5, 1.5, lp.shape[0]).astype(np.float32))
    alpha, ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
    grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, alpha, ll, g, blank)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    if unaligned:                     # log-probs that do not start on 16 bytes: copied first
        shifted = torch.empty(lp.numel() + 1, device=card)[1:].view(lp.shape)
        shifted.copy_(on_card[0])
        assert shifted.data_ptr() % 16 != 0
        on_card[0] = shifted
    warp = ctc_loss.beta_grad_warp_fits(y.shape[1], lp.shape[2])
    assert warp == (case not in LOSS_BLOCK_CASES and 2 * y.shape[1] + 1 <= ctc_loss.WARP_S_MAX)
    before = backward_launches()
    k_alpha, k_ll = ctc_loss.alpha_kernel(*on_card, blank)
    k_grad = ctc_loss.beta_grad_kernel(*on_card, k_alpha, k_ll, g.to(card), blank)
    torch.cuda.synchronize()
    assert backward_launches() == (before[0] + 1, before[1] + warp, before[2] + (not warp))
    feasible = ll > -5e29
    assert torch.equal(k_ll.cpu() > -5e29, feasible)
    # the recursions are the same float32 operations; expf/logf of the card's
    # library and of the CPU's differ in the last bit
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(k_ll.cpu()[feasible].numpy(), ll[feasible].numpy(), rtol=1e-5)
    assert (k_ll.cpu()[xlen == 0] == -1e30).all()
    # gamma in [0, 1] summed per class with shared-memory atomics in any order
    np.testing.assert_allclose(k_grad.cpu().numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (k_grad.cpu()[~feasible] == 0).all()


@pytest.mark.parametrize('depth', [2, 4, 8, 16, 32])
def test_ctc_alpha_ring_depths_equal_plain(card, depth):
    """Every ring depth of the forward kernel (two chunks of depth / 2
    frames), on rows shorter than the ring, rows that end inside a chunk or
    at its end, and a row with xlen = 0; counts no launch."""
    from convasr_tpu_torch.ops import ctc_loss
    lp, y, xlen, ylen, blank = loss_batch(seed=34, B=6, T=45, C=38, L=10, zero_xlen_row=True)
    xlen[1], xlen[2], xlen[3] = 1, depth - 1, depth // 2
    alpha, ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
    before = backward_launches()
    k_alpha, k_ll = ctc_loss._alpha_depth(*(t.to(card) for t in (lp, y, xlen, ylen)), blank,
                                          depth)
    torch.cuda.synchronize()
    assert backward_launches() == before
    feasible = ll > -5e29
    assert torch.equal(k_ll.cpu() > -5e29, feasible) and k_ll[-1] == -1e30
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(k_ll.cpu()[feasible].numpy(), ll[feasible].numpy(), rtol=1e-5)


def test_ctc_loss_auto_runs_both_kernels(card):
    from convasr_tpu_torch.ops import ctc_loss
    lp, y, xlen, ylen, blank = loss_batch(seed=28, B=5, T=33)
    x = lp.to(card).requires_grad_()
    before = backward_launches()
    loss = ctc_loss.ctc_loss_auto(x, *(t.to(card) for t in (y, xlen, ylen)), blank=blank)
    loss.mean().backward()            # an expanded (stride 0) cotangent
    torch.cuda.synchronize()
    assert backward_launches() == (before[0] + 1, before[1] + 1, before[2])
    x_cpu = lp.clone().requires_grad_()
    ref = ctc_loss.ctc_loss_auto(x_cpu, y, xlen, ylen, blank=blank)
    ref.mean().backward()
    np.testing.assert_allclose(loss.detach().cpu().numpy(), ref.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.cpu().numpy(), x_cpu.grad.numpy(), rtol=1e-3, atol=1e-4)


WARP_CASES = dict(
    ragged=dict(seed=60, B=9, T=70, C=38, L=20),                 # ragged xlen; 9 rows: 5 blocks
    empty_target=dict(seed=61, B=5, T=25, empty_row=True),
    repeated_labels=dict(seed=62, B=6, T=40, C=5, L=8, repeated=True),
    infeasible_row=dict(seed=63, B=4, T=28, L=6, infeasible_row=True),
    non_last_blank=dict(seed=64, B=4, T=26, C=9, L=6, blank=0),
    zero_input_length=dict(seed=65, B=3, T=24, zero_xlen_row=True),
    train_shape=dict(seed=66, B=8, T=120, C=38, L=128),           # S 257: 9 states a lane
    states_16=dict(seed=67, B=3, T=60, C=38, L=255),              # S 511: 16 a lane
    rule_edge=dict(seed=68, B=2, T=1100, C=38, L=511),            # S 1023: the warp kernel's most
    past_rule=dict(seed=69, B=2, T=1100, C=38, L=512),            # S 1025: the block kernel
    # a minute of audio at 50 frames a second and more: beta's error must not grow with xlen
    long_t_l128=dict(seed=70, B=3, T=3000, C=38, L=128),
    long_t_l511=dict(seed=71, B=2, T=2500, C=38, L=511),
    past_shared_memory=dict(seed=72, B=2, T=300, C=7000, L=128),  # a row's buffers pass 227 KB
)
# the lattices the warp kernel does not reach
BLOCK_CASES = ('past_rule', 'past_shared_memory')


@pytest.mark.parametrize('case', WARP_CASES)
def test_beta_grad_warp_kernel_equals_plain(card, case):
    """The backward kernel the route names against beta_grad_plain, within the
    stated tolerance, and the warp kernel also where it reaches past the route
    (S up to 1024); the counters name the kernel the rule names."""
    from convasr_tpu_torch.ops import ctc_loss
    lp, y, xlen, ylen, blank = loss_batch(**WARP_CASES[case])
    g = torch.from_numpy(np.random.RandomState(3).uniform(0.5, 1.5, lp.shape[0]).astype(np.float32))
    alpha, ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
    grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, alpha, ll, g, blank)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen, alpha, ll, g)]
    reach = case not in BLOCK_CASES
    warp = ctc_loss.beta_grad_warp_fits(y.shape[1], lp.shape[2])
    assert warp == (reach and 2 * y.shape[1] + 1 <= ctc_loss.WARP_S_MAX)
    before = backward_launches()
    k_grad = ctc_loss.beta_grad_kernel(*on_card, blank)
    torch.cuda.synchronize()
    assert backward_launches() == (before[0], before[1] + warp, before[2] + (not warp))
    feasible = ll > -5e29
    # gamma in [0, 1] summed per class with shared-memory atomics in any order
    np.testing.assert_allclose(k_grad.cpu().numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (k_grad.cpu()[~feasible] == 0).all()
    if reach and not warp:            # the warp kernel past the route: a measurement route
        got = ctc_loss._beta_grad_route(*on_card, blank, 'warp')
        np.testing.assert_allclose(got.cpu().numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
    if case == 'ragged':
        # log-probs that do not start on 16 bytes (a view): copied before the launch
        shifted = torch.empty(lp.numel() + 1, device=card)[1:].view(lp.shape)
        shifted.copy_(on_card[0])
        assert shifted.data_ptr() % 16 != 0
        got = ctc_loss._beta_grad_route(shifted, *on_card[1:], blank, 'warp')
        np.testing.assert_allclose(got.cpu().numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
        assert backward_launches() == (before[0], before[1] + 1, before[2])


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
    block1_res0=dict(M=2408, K=256, N=256),                  # the wgmma GEMM on the path
    block6_fused=dict(M=2408, K=1792, N=512),
    head=dict(M=2408, K=1024, N=38),
    block10_fused=dict(M=2408, K=4096, N=768),               # the deepest on the path
    ragged_whole_k=dict(M=7, K=13, N=38),                    # K % 16: the mma.sync whole-K kernel
    ragged_k_tiled=dict(M=33, K=1801, N=17),                 # K % 16, past 1792: K-tiled
    overflow_edge=dict(M=70, K=4096, N=16, full=True),
    # the wgmma GEMM's edges: BM 128 rows, BN 64/128/192, 128-byte K chunks
    k16=dict(M=130, K=16, N=64),
    k272_ragged=dict(M=257, K=272, N=200),
    m_ragged_n_odd=dict(M=1000, K=512, N=77),
    one_row=dict(M=1, K=64, N=8),
    overflow_edge_whole_k=dict(M=129, K=1792, N=40, full=True),
    probe=dict(M=4096, K=1792, N=4096),
    # the wgmma GEMM past 1792: 64 K chunks through the ring of stages, all +-127
    wgmma_k8192_full=dict(M=150, K=8192, N=72, full=True),
    wgmma_k2304_ragged=dict(M=1001, K=2304, N=77),            # block 7's K
)


def gemm_launches():
    from convasr_tpu_torch.ops import int8
    return dict(wgmma=int8.GEMM_WGMMA_LAUNCHES, whole_k=int8.GEMM_WHOLE_K_LAUNCHES,
                k_tiled=int8.GEMM_K_TILED_LAUNCHES)


@pytest.mark.parametrize('case', INT8_GEMM_CASES)
def test_int8_gemm_kernels_equal_plain(card, case):
    """Bit-equal to the float64 plain version; the counters say which kernel
    ran, as the rule says."""
    from convasr_tpu_torch.ops import int8
    c = INT8_GEMM_CASES[case]
    a, b = (t.to(card) for t in int8_tensors(20 + sorted(INT8_GEMM_CASES).index(case),
                                             (c['M'], c['K']), (c['K'], c['N']),
                                             full=c.get('full', False)))
    route = int8.gemm_route(c['K'])
    assert bool(int8._gemm_library().int8_gemm_wgmma_fits(c['K'])) == (route == 'wgmma')
    before = gemm_launches()
    got = int8.int8_matmul(a, b)
    want = int8.int8_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert gemm_launches() == {k: v + (k == route) for k, v in before.items()}
    assert got.shape == want.shape and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_int8_gemm_unaligned_input_is_copied_for_the_wgmma_kernel(card):
    from convasr_tpu_torch.ops import int8
    buf, b = (t.to(card) for t in int8_tensors(40, (33 * 272 + 1,), (272, 40)))
    a = buf[1:].view(33, 272)                  # contiguous, 1 byte past 16-byte alignment
    assert a.is_contiguous() and a.data_ptr() % 16 == 1
    packed = int8.pack_gemm_weight(b)
    before = gemm_launches()
    got = int8.int8_matmul(a, b, b_packed=packed)
    torch.cuda.synchronize()
    assert gemm_launches() == dict(before, wgmma=before['wgmma'] + 1)
    assert torch.equal(got, int8.int8_matmul_plain(a, b))


def test_int8_gemm_packed_weight_is_used_as_given(card):
    from convasr_tpu_torch.ops import int8
    a, b = (t.to(card) for t in int8_tensors(41, (2408, 1024), (1024, 38)))
    packed = int8.pack_gemm_weight(b)
    assert len(packed.maps) == int8.GEMM_NUM_BN * int8.GEMM_MAP_BYTES
    assert int8.wgmma_gemm_bn(2408, 38) == 64 and int8.wgmma_gemm_bn(2408, 512) == 128
    packs, before = int8.GEMM_WEIGHT_PACKS, gemm_launches()
    got = int8.int8_matmul_auto(a, None, b_packed=packed)
    torch.cuda.synchronize()
    assert int8.GEMM_WEIGHT_PACKS == packs
    assert gemm_launches() == dict(before, wgmma=before['wgmma'] + 1)
    assert torch.equal(got, int8.int8_matmul_plain(a, b))
    with pytest.raises(ValueError, match='not one weight'):
        int8.int8_matmul(a, b[:, :8].contiguous(), b_packed=packed)


def test_int8_auto_dispatch_counts_each_variant(card):
    from convasr_tpu_torch.ops import int8
    x, w = (t.to(card) for t in int8_tensors(30, (2, 20, 16), (3, 16, 8)))
    a, b_short, b_ragged, b_deep = (t.to(card) for t in int8_tensors(
        31, (5, 2001), (16, 8), (13, 8), (2001, 8)))
    before = (int8.CONV_LAUNCHES, int8.GEMM_WGMMA_LAUNCHES, int8.GEMM_WHOLE_K_LAUNCHES,
              int8.GEMM_K_TILED_LAUNCHES)
    int8.int8_conv1d_auto(x, w)
    int8.int8_matmul_auto(a[:, :16].contiguous(), b_short)
    int8.int8_matmul_auto(a[:, :13].contiguous(), b_ragged)
    int8.int8_matmul_auto(a, b_deep)
    torch.cuda.synchronize()
    assert (int8.CONV_LAUNCHES, int8.GEMM_WGMMA_LAUNCHES, int8.GEMM_WHOLE_K_LAUNCHES,
            int8.GEMM_K_TILED_LAUNCHES) == tuple(n + 1 for n in before)


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
    tree = quantized.to_device(qtree, card)     # packs the conv and GEMM weights once
    before = (int8.CONV_LAUNCHES + int8.CONV_MMA_SYNC_LAUNCHES,
              int8.GEMM_WGMMA_LAUNCHES + int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_WGMMA_LAUNCHES,
              int8.CONV_WEIGHT_PACKS, int8.GEMM_WEIGHT_PACKS)
    on_card = quantized.quantized_apply(model, tree, x.to(card),
                                        xlen.to(card))['log_probs'][0].cpu()
    # at base width 8 some convs have Cin 24 or 40 and take the mma.sync loop,
    # and some GEMMs K 24 or 40 and the whole-K kernel
    assert int8.CONV_LAUNCHES + int8.CONV_MMA_SYNC_LAUNCHES == before[0] + 32
    assert int8.GEMM_WGMMA_LAUNCHES + int8.GEMM_WHOLE_K_LAUNCHES == before[1] + 12
    assert int8.GEMM_WGMMA_LAUNCHES > before[2]
    assert (int8.CONV_WEIGHT_PACKS, int8.GEMM_WEIGHT_PACKS) == before[3:]
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


# the lattice K2b's route (K1b's) sends to the whole-T block kernel
WHOLE_T_BLOCK_CASES = ('many_states',)


def whole_t_launches():
    from convasr_tpu_torch.ops import ctc_loss_whole_t as k2
    return k2.ALPHA_LAUNCHES, k2.BETA_GRAD_WARP_LAUNCHES, k2.BETA_GRAD_LAUNCHES


@pytest.mark.parametrize('case', WHOLE_T_CASES)
def test_whole_t_kernels_equal_plain(card, case):
    """K2f and the K2b kernel its route names against the plain versions,
    within K1's tolerances, and K2b's other kernel too where it reaches, as a
    measurement route that counts nothing."""
    from convasr_tpu_torch.ops import ctc_loss, ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = loss_batch(**WHOLE_T_CASES[case])
    if case == 'zero_input_length':               # also a row of xlen 0 that takes frame 0
        xlen[0], ylen[0] = 0, 1
    g = torch.from_numpy(np.random.RandomState(2).uniform(0.5, 1.5, lp.shape[0]).astype(np.float32))
    alpha, ll = k2.alpha_whole_t_plain(lp, y, xlen, ylen, blank)
    grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, alpha, ll, g, blank)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    route = k2.beta_grad_route(y.shape[1], lp.shape[2])
    assert route == ('block' if case in WHOLE_T_BLOCK_CASES else 'warp')
    before = whole_t_launches()
    k_alpha, k_ll = k2.alpha_kernel(*on_card, blank)
    k_grad = k2.beta_grad_kernel(*on_card, k_alpha, k_ll, g.to(card), blank)
    torch.cuda.synchronize()
    assert whole_t_launches() == (before[0] + 1, before[1] + (route == 'warp'),
                                  before[2] + (route == 'block'))
    feasible = ll > -5e29
    assert torch.equal(k_ll.cpu() > -5e29, feasible)
    if case == 'zero_input_length':
        assert feasible[0] and feasible[-1]       # frame 0 gives rows of xlen 0 an ll
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(k_ll.cpu()[feasible].numpy(), ll[feasible].numpy(), rtol=1e-5)
    # gamma in [0, 1] summed per class with shared-memory atomics in any order
    np.testing.assert_allclose(k_grad.cpu().numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (k_grad.cpu()[~feasible | (xlen == 0)] == 0).all()
    reach = ['block'] + (['warp'] if 2 * y.shape[1] + 1 <= 1024 else [])
    for other in reach:
        got = k2._beta_grad_route(*on_card, k_alpha, k_ll, g.to(card), blank, other).cpu()
        np.testing.assert_allclose(got.numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
        assert (got[~feasible | (xlen == 0)] == 0).all()
    assert whole_t_launches() == (before[0] + 1, before[1] + (route == 'warp'),
                                  before[2] + (route == 'block'))


def test_whole_t_guard_raises_on_the_card(card):
    from convasr_tpu_torch.ops import ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = loss_batch(seed=48, B=1, T=1522, C=38, L=60)
    assert not k2.smem_fits(1522, 60, 38)
    before = k2.ALPHA_LAUNCHES
    with pytest.raises(ValueError, match='shared memory'):
        k2.ctc_loss_whole_t(*(t.to(card) for t in (lp, y, xlen, ylen)))
    assert k2.ALPHA_LAUNCHES == before


@pytest.mark.parametrize('route,L', [('warp', 5), ('block', 300)])
def test_ctc_loss_whole_t_runs_both_kernels(card, route, L):
    """ctc_loss_whole_t forward and backward on each route of K2b (S 11 on
    K1b's warp kernel, S 601 past WARP_S_MAX on the whole-T block kernel),
    with a row of xlen 0 whose loss is finite and whose gradient is 0."""
    from convasr_tpu_torch.ops import ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = loss_batch(seed=49, B=5, T=33 if L == 5 else 700, L=L,
                                          zero_xlen_row=True)
    xlen[0], ylen[0] = 0, 1           # takes frame 0: a finite loss
    assert k2.beta_grad_route(L, lp.shape[2]) == route
    x = lp.to(card).requires_grad_()
    before = whole_t_launches()
    loss = k2.ctc_loss_whole_t(x, *(t.to(card) for t in (y, xlen, ylen)), blank=blank)
    loss.mean().backward()            # an expanded (stride 0) cotangent
    torch.cuda.synchronize()
    assert whole_t_launches() == (before[0] + 1, before[1] + (route == 'warp'),
                                  before[2] + (route == 'block'))
    x_cpu = lp.clone().requires_grad_()
    ref = k2.ctc_loss_whole_t(x_cpu, y, xlen, ylen, blank=blank)
    ref.mean().backward()
    assert torch.isfinite(ref[[0, -1]]).all()  # the rows of xlen 0 take frame 0
    np.testing.assert_allclose(loss.detach().cpu().numpy(), ref.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.cpu().numpy(), x_cpu.grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (x.grad[0] == 0).all() and (x.grad[-1] == 0).all()


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
