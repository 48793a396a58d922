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
    # a BPE head's widths: the warp kernel stages the lattice's classes, with
    # repeated labels, a row of xlen 0 and one with no targets
    wide_head=dict(seed=19, B=4, T=30, C=1024, L=8, repeated=True, empty_row=True,
                   xlen_rows=(0, 30)),
    bpe_head=dict(seed=20, B=4, T=24, C=5000, L=6, repeated=True, empty_row=True,
                  xlen_rows=(0, 17)),
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
    warp kernel up to WARP_S_MAX states, the block pair past it, at any C
    (at 20000 classes the staging gathers the lattice's classes); the spill
    route exactly where T frames of packed backpointers pass shared memory."""
    lib = align._library()
    L = (align.WARP_S_MAX - 1) // 2
    assert align.viterbi_route(L, 38) == 'warp' and lib.ctc_viterbi_warp_fits(L, 38) == 1
    assert align.viterbi_route(L + 1, 38) == 'block' and lib.ctc_viterbi_warp_fits(L + 1, 38) == 0
    assert align.viterbi_route(128, 20000) == 'warp' and lib.ctc_viterbi_warp_fits(128, 20000)
    assert align.spill_words(301, 128, 38) == 0      # the path's: on chip
    assert align.spill_words(1500, 400, 38) == 1500 * 64
    assert align.spill_words(1900, 20, 38) == 1900 * 32
    # the BPE head's lattice, gathered: on chip at T 301, spilled at T 1900
    assert align.spill_words(301, 128, 5000) == 0
    assert align.spill_words(1900, 128, 5000) == 1900 * 32


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
    wide_classes=dict(seed=33, B=3, T=30, C=20000, L=16),      # the lattice's 17 classes staged
)
# the lattices the route sends to the block backward kernel
LOSS_BLOCK_CASES = ('many_states',)


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
    # whole rows would pass 227 KB; the lattice's 129 classes a frame fit
    past_shared_memory=dict(seed=72, B=2, T=300, C=7000, L=128),
)
# the lattices the warp kernel does not reach
BLOCK_CASES = ('past_rule',)


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
# the serving path's shapes: a Recognize of one 6 s request (B1, 601 frontend
# frames, 301 after the prologue's stride) and a tick of the batched engine
# with 4 slots of a 10 s window (B4, 1001 and 501 frames)
INT8_CONV_CASES.update({f'serve_b{B}_k{K}_{Cin}_{Cout}_s{s}': dict(
    B=B, T=(2 * T - 1) if s == 2 else T, Cin=Cin, Cout=Cout, K=K, stride=s)
    for B, T in ((1, 301), (4, 501))
    for K, Cin, Cout, s in ((11, 64, 256, 2), (13, 256, 384, 1), (25, 768, 768, 1),
                            (29, 768, 896, 1))})


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
    # the serving path's: M = 301 frames of one 6 s request, 2004 of an
    # engine tick of 4 x 10 s (neither a multiple of the 128-row tile)
    serve_b1_block1_res0=dict(M=301, K=256, N=256),
    serve_b1_block6_fused=dict(M=301, K=1792, N=512),
    serve_b1_block10_fused=dict(M=301, K=4096, N=768),
    serve_b1_head=dict(M=301, K=1024, N=38),
    serve_n4_block10_fused=dict(M=2004, K=4096, N=768),
    serve_n4_head=dict(M=2004, K=1024, N=38),
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



def int8_launches():
    from convasr_tpu_torch.ops import int8
    return (int8.CONV_LAUNCHES, int8.CONV_MMA_SYNC_LAUNCHES, int8.GEMM_WGMMA_LAUNCHES,
            int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_K_TILED_LAUNCHES)


@pytest.mark.parametrize('case', ['conv', 'conv_mma_sync', 'gemm', 'gemm_whole_k'])
def test_registered_ops_launch_the_kernels(card, case):
    """torch.ops.convasr.* on CUDA tensors launch the kernels (one launch,
    counted), bit-equal to the plain version, on the weight's cached packed
    copy (packed once: a second call packs nothing); torch.library.opcheck
    holds on the card."""
    from convasr_tpu_torch.ops import int8
    shapes = dict(conv=((2, 40, 32), (5, 32, 24)), conv_mma_sync=((2, 40, 24), (5, 24, 16)),
                  gemm=((33, 64), (64, 40)), gemm_whole_k=((33, 40), (40, 24)))[case]
    x, w = (t.to(card) for t in int8_tensors(50 + len(case), *shapes))
    if case.startswith('conv'):
        op, args, plain = torch.ops.convasr.int8_conv1d, (x, w, 1, 1), int8.int8_conv1d_plain
        slot = 0 if case == 'conv' else 1
    else:
        op, args, plain = torch.ops.convasr.int8_matmul, (x, w), int8.int8_matmul_plain
        slot = 2 if case == 'gemm' else 3
    before = int8_launches()
    got = op(*args)
    packs = (int8.CONV_WEIGHT_PACKS, int8.GEMM_WEIGHT_PACKS)
    again = op(*args)
    torch.cuda.synchronize()
    after = int8_launches()
    assert after == tuple(n + 2 * (i == slot) for i, n in enumerate(before)), (before, after)
    assert (int8.CONV_WEIGHT_PACKS, int8.GEMM_WEIGHT_PACKS) == packs
    assert torch.equal(got, plain(*args)) and torch.equal(again, got)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize('traced_on', ['cuda', 'cpu'])
def test_exported_int8_program_launches_the_kernels(card, traced_on, tmp_path):
    """An int8 program of cli/export.py, traced on the card or on the CPU and
    loaded on the card, launches the hand kernels as the live forward does
    (the same counts, no weight packed by the forward) and gives the live
    forward's logits, bit for bit."""
    from convasr_tpu_torch.cli import export
    from convasr_tpu_torch.models import quantized
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.ops import int8
    torch.manual_seed(0)
    model = create_model('JasperNetBig', 16, (38,), base_width=16).eval()
    rng = np.random.RandomState(41)
    x = torch.from_numpy(rng.randn(2, 96, 16).astype(np.float32))
    xlen = torch.tensor([1.0, 0.625])
    path = str(tmp_path / 'int8.pt2')
    device = torch.device(traced_on)
    export.export_quantized(model.to(device), [dict(x=x.numpy(), xlen=xlen.numpy())],
                            x.to(device), xlen.to(device), path)
    model.to(card)
    program = export.Program(path, card)
    live = quantized.quantized_apply(model, program.qtree, x.to(card), xlen.to(card))
    before, packs = int8_launches(), (int8.CONV_WEIGHT_PACKS, int8.GEMM_WEIGHT_PACKS)
    quantized.quantized_apply(model, program.qtree, x.to(card), xlen.to(card))
    torch.cuda.synchronize()
    live_counts = [a - b for a, b in zip(int8_launches(), before)]
    before = int8_launches()
    logits, _ = program(x.to(card), xlen.to(card))
    torch.cuda.synchronize()
    program_counts = [a - b for a, b in zip(int8_launches(), before)]
    assert program_counts == live_counts and sum(program_counts) == 44, program_counts
    assert (int8.CONV_WEIGHT_PACKS, int8.GEMM_WEIGHT_PACKS) == packs
    assert torch.equal(logits, live['logits'][0])


def test_exported_bf16_program_matches_the_model(card, tmp_path):
    from convasr_tpu_torch.cli import export
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.zoo import create_model
    torch.manual_seed(0)
    model = create_model('JasperNetSmall', 16, (38,), base_width=16, dtype=torch.bfloat16,
                         frontend=LogFilterBankFrontend(16, 8000, 0.02, 0.01, dither=0.0))
    model.to(card).eval()
    x = torch.from_numpy(0.1 * np.random.RandomState(42).randn(2, 8000).astype(np.float32))
    xlen = torch.tensor([1.0, 0.7])
    path = export.export_model(model, x.to(card), xlen.to(card), str(tmp_path / 'bf16.pt2'))
    assert export.validate_export(model, x.to(card), xlen.to(card), path, fp16=True)


# --- whole-T CTC loss K2f/K2b (csrc/ctc_loss.cu, csrc/ctc_loss_whole_t.cu) --

WHOLE_T_CASES = dict(
    base=dict(seed=40),                                        # ragged xlen and ylen
    odd_rows=dict(seed=41, B=3, T=19),                         # rows not 16-byte aligned
    zero_input_length=dict(seed=42, B=3, T=24, zero_xlen_row=True),
    infeasible_row=dict(seed=43, B=4, T=28, L=6, infeasible_row=True),
    non_last_blank=dict(seed=44, B=4, T=26, C=9, L=6, blank=0),
    repeated_labels=dict(seed=45, B=6, T=40, C=5, L=8, repeated=True),
    many_states=dict(seed=46, B=3, T=120, C=40, L=700),        # 1401 states: 2 per thread
    guard_edge=dict(seed=47, B=2, T=1521, C=38, L=60),         # the largest T that fits
    past_shared_memory=dict(seed=48, B=4, T=1600, C=38, L=300),  # 248 KB a row
)


def whole_t_route(case):
    """K2b's route for a WHOLE_T_CASES case: K1b's warp kernel to S 513, the
    whole-T block kernel past it where a row fits a block, K1b's block
    kernel beyond."""
    return dict(many_states='block', past_shared_memory='k1_block').get(case, 'warp')


def whole_t_launches():
    from convasr_tpu_torch.ops import ctc_loss_whole_t as k2
    return (k2.ALPHA_LAUNCHES, k2.BETA_GRAD_WARP_LAUNCHES, k2.BETA_GRAD_LAUNCHES,
            k2.BETA_GRAD_K1_BLOCK_LAUNCHES)


def launched(before, route):
    """whole_t_launches() after one forward and one backward on `route`."""
    return (before[0] + 1, before[1] + (route == 'warp'), before[2] + (route == 'block'),
            before[3] + (route == 'k1_block'))


@pytest.mark.parametrize('case', WHOLE_T_CASES)
def test_whole_t_kernels_equal_plain(card, case):
    """K2f (K1f's ring kernel with frame 0 taken by every row) and the K2b
    kernel its route names against the plain versions, within K1's
    tolerances; the whole-T forward and K2b's other kernels too where
    they reach, as measurement routes that count nothing."""
    from convasr_tpu_torch.ops import ctc_loss, ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = loss_batch(**WHOLE_T_CASES[case])
    if case == 'zero_input_length':               # also a row of xlen 0 that takes frame 0
        xlen[0], ylen[0] = 0, 1
    g = torch.from_numpy(np.random.RandomState(2).uniform(0.5, 1.5, lp.shape[0]).astype(np.float32))
    alpha, ll = k2.alpha_whole_t_plain(lp, y, xlen, ylen, blank)
    grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, alpha, ll, g, blank)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    (B, T, C), L = lp.shape, y.shape[1]
    route = k2.beta_grad_route(T, L, C)
    assert route == whole_t_route(case)
    before = whole_t_launches()
    k_alpha, k_ll = k2.alpha_kernel(*on_card, blank)
    k_grad = k2.beta_grad_kernel(*on_card, k_alpha, k_ll, g.to(card), blank)
    torch.cuda.synchronize()
    assert whole_t_launches() == launched(before, route)
    feasible = ll > -5e29
    fits = k2.smem_fits(T, L, C)
    for other in ['ring'] + (['whole_t'] if fits else []):
        o_alpha, o_ll = k2._alpha_route(*on_card, blank, other)
        assert torch.equal(o_ll.cpu() > -5e29, feasible), other
        if case == 'zero_input_length':
            assert feasible[0] and feasible[-1]   # frame 0 gives rows of xlen 0 an ll
        np.testing.assert_allclose(o_alpha.cpu().numpy(), alpha.numpy(), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(o_ll.cpu()[feasible].numpy(), ll[feasible].numpy(),
                                   rtol=1e-5)
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(k_ll.cpu()[feasible].numpy(), ll[feasible].numpy(), rtol=1e-5)
    # gamma in [0, 1] summed per class with shared-memory atomics in any order
    np.testing.assert_allclose(k_grad.cpu().numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (k_grad.cpu()[~feasible | (xlen == 0)] == 0).all()
    reach = ['k1_block'] + (['block'] if fits else []) + (['warp'] if 2 * L + 1 <= 1024 else [])
    for other in reach:
        got = k2._beta_grad_route(*on_card, k_alpha, k_ll, g.to(card), blank, other).cpu()
        np.testing.assert_allclose(got.numpy(), grad.numpy(), rtol=1e-3, atol=1e-4)
        assert (got[~feasible | (xlen == 0)] == 0).all()
    assert whole_t_launches() == launched(before, route)


@pytest.mark.parametrize('route,T,L', [('warp', 1522, 60), ('k1_block', 1600, 300)])
def test_whole_t_past_shared_memory_matches_plain(card, route, T, L):
    """A T past smem_fits, which the card refused before: forward on the ring
    kernel and backward on the route (K1b's warp kernel at S 121, its block
    kernel at S 601), against the plain versions on the CPU."""
    from convasr_tpu_torch.ops import ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = loss_batch(seed=48, B=3, T=T, C=38, L=L)
    xlen[0], ylen[0] = 0, 1           # takes frame 0: a finite loss, a zero gradient
    assert not k2.smem_fits(T, L, 38) and k2.beta_grad_route(T, L, 38) == route
    x = lp.to(card).requires_grad_()
    before = whole_t_launches()
    loss = k2.ctc_loss_whole_t(x, *(t.to(card) for t in (y, xlen, ylen)), blank=blank)
    loss.sum().backward()
    torch.cuda.synchronize()
    assert whole_t_launches() == launched(before, route)
    x_cpu = lp.clone().requires_grad_()
    ref = k2.ctc_loss_whole_t(x_cpu, y, xlen, ylen, blank=blank)
    ref.sum().backward()
    assert torch.isfinite(ref).all()
    np.testing.assert_allclose(loss.detach().cpu().numpy(), ref.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.cpu().numpy(), x_cpu.grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (x.grad[0] == 0).all()


@pytest.mark.parametrize('route,L', [('warp', 5), ('block', 300), ('k1_block', 300)])
def test_ctc_loss_whole_t_runs_both_kernels(card, route, L):
    """ctc_loss_whole_t forward and backward on each route of K2b (S 11 on
    K1b's warp kernel; S 601 past WARP_S_MAX on the whole-T block kernel at T
    700 and on K1b's block kernel at T 1600 of C 38, past smem_fits), with a row of
    xlen 0 whose loss is finite and whose gradient is 0."""
    from convasr_tpu_torch.ops import ctc_loss_whole_t as k2
    T = dict(warp=33, block=700, k1_block=1600)[route]
    lp, y, xlen, ylen, blank = loss_batch(seed=49, B=5, T=T, C=38 if route == 'k1_block' else 7,
                                          L=L, zero_xlen_row=True)
    xlen[0], ylen[0] = 0, 1           # takes frame 0: a finite loss
    assert k2.beta_grad_route(T, L, lp.shape[2]) == route
    x = lp.to(card).requires_grad_()
    before = whole_t_launches()
    loss = k2.ctc_loss_whole_t(x, *(t.to(card) for t in (y, xlen, ylen)), blank=blank)
    loss.mean().backward()            # an expanded (stride 0) cotangent
    torch.cuda.synchronize()
    assert whole_t_launches() == launched(before, route)
    x_cpu = lp.clone().requires_grad_()
    ref = k2.ctc_loss_whole_t(x_cpu, y, xlen, ylen, blank=blank)
    ref.mean().backward()
    assert torch.isfinite(ref[[0, -1]]).all()  # the rows of xlen 0 take frame 0
    np.testing.assert_allclose(loss.detach().cpu().numpy(), ref.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.cpu().numpy(), x_cpu.grad.numpy(), rtol=1e-3, atol=1e-4)
    assert (x.grad[0] == 0).all() and (x.grad[-1] == 0).all()


# --- the native wav reader (native/wav_reader.cpp), built on the card's host -

@pytest.mark.parametrize('mono', [True, False], ids=['mono', 'stereo'])
def test_native_wav_reader_equals_scipy(card, tmp_path, mono):
    """The C++ wav reader, built by g++ where the card is, bit-equal to the
    scipy backend (an int16 stereo file, and its downmix)."""
    from convasr_tpu_torch.audio import read_audio, write_audio
    sig = (0.3 * np.random.RandomState(50).randn(2, 8000 * 3)).astype(np.float32)
    path = str(tmp_path / 'stereo.wav')
    write_audio(path, sig, 8000)
    native, sr = read_audio(path, sample_rate=8000, mono=mono, backend='native')
    ref, _ = read_audio(path, sample_rate=8000, mono=mono, backend='scipy')
    assert sr == 8000 and native.dtype == np.float32 and native.shape == ref.shape
    assert np.array_equal(native, ref)


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


# the int8 shapes of the benchmark CLI's default batch (-B 64 -T 6: 601
# frames, 301 after the prologue's stride): the path's convs and its 12 GEMMs
# (M = 64 * 301 rows; the fused residual GEMMs K 256-4096, the epilogue's
# one-tap conv and the head)
BENCH_GEMMS = [(256, 256), (512, 256), (768, 256), (1024, 384), (1408, 384), (1792, 512),
               (2304, 512), (2816, 640), (3456, 640), (4096, 768), (896, 1024), (1024, 38)]


@pytest.mark.parametrize('K,Cin,Cout,stride', PATH_CONVS,
                         ids=[f'k{K}_{Cin}_{Cout}_s{s}' for K, Cin, Cout, s in PATH_CONVS])
def test_benchmark_int8_conv_shapes_equal_plain(card, K, Cin, Cout, stride):
    from convasr_tpu_torch.ops import int8
    T = 601 if stride == 2 else 301
    x, w = (t.to(card) for t in int8_tensors(K * 7 + Cin, (64, T, Cin), (K, Cin, Cout)))
    got = int8.int8_conv1d(x, w, stride)
    want = int8.int8_conv1d_plain(x, w, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize('K,N', BENCH_GEMMS, ids=[f'k{K}_n{N}' for K, N in BENCH_GEMMS])
def test_benchmark_int8_gemm_shapes_equal_plain(card, K, N):
    from convasr_tpu_torch.ops import int8
    a, b = (t.to(card) for t in int8_tensors(K + N, (64 * 301, K), (K, N)))
    got = int8.int8_matmul(a, b)
    want = int8.int8_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_remat_matches_no_remat_on_card(card):
    """--remat on the card: a float32 step with dropout 0.2 and SpecAugment,
    one generator seed, with and without remat: the loss within 1e-5, every
    gradient and running statistic within rtol 1e-5, atol 1e-6 (the CPU
    test's tolerances, tests/test_torch_remat.py), the generator's state
    equal. cuDNN runs its deterministic algorithms for the comparison."""
    from convasr_tpu_torch.models.jasper import JasperNet
    from convasr_tpu_torch.train.loop import compute_losses
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 200, 16).astype(np.float32)).to(card)
    xlen = torch.tensor([1.0, 0.9, 0.6, 0.5], device=card)
    y = torch.from_numpy(rng.randint(0, 9, size=(4, 1, 12))).to(card)
    ylen = torch.full((4, 1), 12, device=card)
    results = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            torch.manual_seed(0)
            model = JasperNet(16, (10,), base_width=16, dropout=0.2, remat=remat,
                              spec_augment=(2, 10, 2, 3)).to(card).train()
            g = torch.Generator(device=card).manual_seed(5)
            loss = compute_losses(model(x, xlen, generator=g), y, ylen).mean()
            grads = torch.autograd.grad(loss, list(model.parameters()))
            results.append((loss, grads, model.state_dict(), g.get_state()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss0, grads0, sd0, g0), (loss1, grads1, sd1, g1) = results
    assert abs(loss0.item() - loss1.item()) <= 1e-5 * abs(loss0.item())
    for a, b in zip(grads0, grads1):
        assert torch.allclose(b, a, rtol=1e-5, atol=1e-6)
    for name, value in sd0.items():
        assert torch.allclose(sd1[name].double(), value.double(), rtol=1e-5, atol=1e-6), name
    assert torch.equal(g0, g1)


def test_fused_tick_ids_equal_legacy_argmax_on_card(card):
    """The batched streaming engine on the card (serve/streaming_batch.py):
    the fused tick's uint8 tail equals the argmax of the full-window
    log-probs of the same (N, W) ring, and its text the legacy tick's."""
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.serve.streaming_batch import BatchedStreamingEngine
    torch.manual_seed(0)
    model = create_model('JasperNetSmall', num_input_features=16, num_classes=(6,),
                         base_width=16, frontend=LogFilterBankFrontend(16, 8000, 0.02, 0.01,
                                                                       dither=0.0))
    model = model.to(card).eval()

    def apply_lp(m, x, xlen):
        return m(x, xlen=xlen)['log_probs'][0]

    def fused(x, xlen):
        with torch.inference_mode():
            best = apply_lp(model, x.to(card), xlen.to(card)).max(-1)
            return torch.stack([best.indices.float(), best.values], -1)

    class Tok:
        eps_id = 5

        def decode(self, tls):
            return [''.join('abcde.'[t] for t in ts) for ts in tls]

    audio = np.asarray(np.random.RandomState(11).randn(8000 * 3) * 0.1, np.float32)
    audio = (audio * 32767.0).round().astype(np.int16).astype(np.float32) / 32767.0
    chunk, texts = 2000, []
    for engine in (BatchedStreamingEngine(fused, 8000, n_slots=2, window_sec=2.0,
                                          chunk_sec=0.25, device=card),
                   BatchedStreamingEngine(None, 8000, n_slots=2, window_sec=2.0, chunk_sec=0.25,
                                          logprobs_provider=lambda: (apply_lp, lambda: model),
                                          max_lookahead_sec=0.6, device=card)):
        sessions = [engine.open(Tok(), lookahead_sec=0.5) for _ in range(2)]
        for lo in range(0, len(audio), chunk):
            for k, s in enumerate(sessions):
                s.accept(audio[lo:lo + chunk] * (1.0, 0.5)[k])
            engine.tick()
            assert engine._buf.is_cuda
            if engine.logprobs_provider is not None:
                with torch.inference_mode():
                    lp = apply_lp(model, engine._buf, torch.ones(2, device=card))
                want = lp.argmax(-1)[:, -engine.tail_frames:].to(torch.uint8).cpu().numpy()
                assert np.array_equal(np.stack([s.inbox[-1] for s in sessions]), want)
            for s in sessions:
                s.drain()
        for s in sessions:
            s.flush()
        texts.append([s.full_text() for s in sessions])
    assert texts[0] == texts[1]


# --- the device cache, several processes, the learned frontends -------------

def test_device_cache_gather_on_the_card(card):
    from convasr_tpu_torch.data.device_cache import DeviceDatasetCache, gather_batch
    rng = np.random.RandomState(3)
    bucket = dict(x=rng.randint(-32768, 32767, size=(6, 512)).astype(np.int16),
                  xlen=rng.rand(6).astype(np.float32),
                  y=rng.randint(0, 30, size=(6, 1, 8)).astype(np.int32),
                  ylen=rng.randint(1, 8, size=(6, 1)).astype(np.int32))
    cache = DeviceDatasetCache({0: dict(bucket)}, None, None, 0).upload(card)
    rows = np.asarray([4, 0, 5], np.int64)
    got = gather_batch(cache.device[0], torch.from_numpy(rows).to(card))
    for k, v in got.items():
        assert v.is_cuda and np.array_equal(v.cpu().numpy(), bucket[k][rows]), k


def _gloo_rank_on_card(rank, world, rdv, out_path):
    from convasr_tpu_torch.frontend.logmel import full_fp32
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.parallel import mesh
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    assert mesh.init_distributed(rdv, world, rank, timeout=60, backend='gloo',
                                 device=device) == 'gloo'
    torch.manual_seed(0)
    model = create_model('JasperNetSmall', num_input_features=16, num_classes=(8,),
                         base_width=8, dropout=0.0).to(device).train()
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 256, 16).astype(np.float32))
    with full_fp32():
        lp = model(x[rank * 2:rank * 2 + 2].to(device), xlen=torch.ones(2, device=device))
        lp['log_probs'][0].sum().backward()
    grads = [p.grad for p in model.parameters()]
    mesh.all_reduce_mean_(grads)
    torch.save(dict(lp=lp['log_probs'][0].detach().cpu(), grad=grads[0].cpu() * world), out_path)
    mesh.shutdown(wait=True)


def test_gloo_two_ranks_on_one_card(card, tmp_path):
    """Two Gloo ranks on cuda:0: each half-batch forward with the global
    batch-norm statistics and the averaged gradient equal one process's on
    the whole batch (float32 with cuDNN's TF32 off: 1e-3)."""
    import multiprocessing
    from convasr_tpu_torch.frontend.logmel import full_fp32
    from convasr_tpu_torch.models.zoo import create_model
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_gloo_rank_on_card,
                         args=(r, 2, f'file://{tmp_path}/rdv', str(tmp_path / f'r{r}.pt')))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    got = [torch.load(tmp_path / f'r{r}.pt') for r in range(2)]
    torch.manual_seed(0)
    model = create_model('JasperNetSmall', num_input_features=16, num_classes=(8,),
                         base_width=8, dropout=0.0).to(card).train()
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 256, 16).astype(np.float32))
    with full_fp32():
        lp = model(x.to(card), xlen=torch.ones(4, device=card))['log_probs'][0]
        lp.sum().backward()
    np.testing.assert_allclose(torch.cat([g['lp'] for g in got]).numpy(),
                               lp.detach().cpu().numpy(), rtol=0, atol=1e-3)
    for g in got:
        np.testing.assert_allclose(g['grad'].numpy(),
                                   next(model.parameters()).grad.cpu().numpy(),
                                   rtol=1e-3, atol=1e-3)


def test_nccl_world_of_one(card, tmp_path):
    import torch.distributed as dist
    from convasr_tpu_torch.parallel import mesh
    try:
        assert mesh.init_distributed(f'file://{tmp_path}/rdv', 1, 0, timeout=60,
                                     device=torch.device('cuda', 0)) == 'nccl'
        t = torch.arange(4.0, device=card)
        dist.all_reduce(t)
        assert torch.equal(t.cpu(), torch.arange(4.0))
        assert mesh.allgather_bytes(b'abc') == [b'abc'] and mesh.world() == 1
    finally:
        mesh.shutdown()


def test_wav2vec_and_vad_forwards_on_the_card(card):
    """The card's forwards against the CPU's, in float32 (cuDNN's TF32 off,
    as the model turns it off around the frontend): the wav2vec frontend
    within 1e-3, the VAD's features and forward within 1e-4."""
    from convasr_tpu_torch.audio.neural_vad import NeuralVAD, featurize
    from convasr_tpu_torch.frontend.logmel import full_fp32
    from convasr_tpu_torch.frontend.wav2vec import (Wav2VecFrontend, convert_fairseq_checkpoint,
                                                    fairseq_state_dict)
    fe = Wav2VecFrontend()
    fe.load_state_dict(convert_fairseq_checkpoint(fairseq_state_dict(0)))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16000).astype(np.float32) * 0.1)
    with torch.no_grad(), full_fp32():
        want = fe(x)
        got = fe.to(card)(x.to(card)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-3)
    torch.manual_seed(0)
    vad = NeuralVAD()
    feats = featurize(x, 8000)
    on_card = featurize(x.to(card), 8000).cpu()
    # the empty bands' constant is the rounding of a mean (featurize's docstring)
    live = np.ptp(feats.numpy(), axis=1).max(axis=0) > 0
    np.testing.assert_allclose(on_card.numpy()[..., live], feats.numpy()[..., live], rtol=0,
                               atol=1e-4)
    with torch.no_grad(), full_fp32():
        want = vad(feats)
        got = vad.to(card)(feats.to(card)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


# --- the BPE head's shapes (JasperNetBig's decoder.bpe_conv0/1, a 5000-piece
# vocabulary, as README's `tools bpetrain --vocab-size 5000` trains) --------

BPE_CLASSES = 5000


def bpe_loss_batch(seed, B, T, L):
    """A batch at the BPE head's width with a short row (xlen < T), an empty
    row (ylen 0), an infeasible row (ylen L in L // 2 frames) and a row whose
    labels repeat one class at every other position."""
    lp, y, xlen, ylen, blank = loss_batch(seed=seed, B=B, T=T, C=BPE_CLASSES, L=L)
    xlen[1] = T // 3
    ylen[2] = 0
    xlen[3], ylen[3] = L // 2, L
    y[4, ::2] = 7
    return lp, y, xlen, ylen, blank


def test_ctc_loss_kernels_at_the_bpe_head(card):
    """K1f and K1b at C 5000 (B6 T300 L40): both stage the lattice's 41
    classes a frame, so the forward keeps its ring of ALPHA_DEPTH frames and
    the route names the warp backward kernel; against the plain versions at
    phase 6's tolerances, the gradient's atol shrunk by 38 / C and each
    row's relative L2 within 1e-5 (grad_agreement); the infeasible row +inf
    and a zero gradient. The plain versions run on the card too: that L2
    bound is below what the CPU's exp and log change at this width."""
    from convasr_tpu_torch.ops import ctc_loss
    lp, y, xlen, ylen, blank = bpe_loss_batch(35, B=6, T=300, L=40)
    g = torch.from_numpy(np.random.RandomState(4).uniform(0.5, 1.5, 6).astype(np.float32))
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    alpha, ll = ctc_loss.alpha_plain(*on_card, blank)
    grad = ctc_loss.beta_grad_plain(*on_card, alpha, ll, g.to(card), blank)
    assert ctc_loss.gathers(y.shape[1], BPE_CLASSES, forward=True)
    assert ctc_loss.gathers(y.shape[1], BPE_CLASSES)
    assert ctc_loss.beta_grad_warp_fits(y.shape[1], BPE_CLASSES)
    before = backward_launches()
    k_alpha, k_ll = ctc_loss.alpha_kernel(*on_card, blank)
    k_grad = ctc_loss.beta_grad_kernel(*on_card, k_alpha, k_ll, g.to(card), blank)
    torch.cuda.synchronize()
    assert backward_launches() == (before[0] + 1, before[1] + 1, before[2])
    feasible = ll > -5e29
    assert feasible.tolist() == [True, True, True, False, True, True]
    assert torch.equal(k_ll > -5e29, feasible)
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.cpu().numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(k_ll.cpu()[feasible.cpu()].numpy(),
                               ll.cpu()[feasible.cpu()].numpy(), rtol=1e-5)
    ok, unit_err, row_l2 = ctc_loss.grad_agreement(k_grad, grad, g.to(card))
    assert ok, (unit_err, row_l2)
    assert bool((k_grad[3] == 0).all()) and bool((k_grad[1, xlen[1]:] == 0).all())
    loss = ctc_loss.ctc_loss_auto(on_card[0], *on_card[1:], blank=blank)
    assert bool(torch.isinf(loss[3])) and bool(torch.isfinite(loss[feasible]).all())


def test_whole_t_kernels_at_the_bpe_head(card):
    """K2f and K2b at C 5000 (B6 T300 L40) with a row of xlen 0 beside
    bpe_loss_batch's rows: K2f runs K1f's ring kernel on the gathered staging
    with frame 0 taken by every row, K2b K1b's warp kernel; against the plain
    versions on the card by K1's checks at this width (rtol 1e-5;
    grad_agreement); the row of xlen 0 a finite loss and a zero gradient,
    the infeasible row none."""
    from convasr_tpu_torch.ops import ctc_loss, ctc_loss_whole_t as k2
    lp, y, xlen, ylen, blank = bpe_loss_batch(37, B=6, T=300, L=40)
    xlen[5], ylen[5] = 0, 1           # takes frame 0
    g = torch.from_numpy(np.random.RandomState(6).uniform(0.5, 1.5, 6).astype(np.float32))
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    alpha, ll = k2.alpha_whole_t_plain(*on_card, blank)
    grad = ctc_loss.beta_grad_plain(*on_card, alpha, ll, g.to(card), blank)
    assert ctc_loss.gathers(y.shape[1], BPE_CLASSES, forward=True)
    assert k2.beta_grad_route(300, y.shape[1], BPE_CLASSES) == 'warp'
    before = whole_t_launches()
    k_alpha, k_ll = k2.alpha_kernel(*on_card, blank)
    k_grad = k2.beta_grad_kernel(*on_card, k_alpha, k_ll, g.to(card), blank)
    torch.cuda.synchronize()
    assert whole_t_launches() == launched(before, 'warp')
    feasible = ll > -5e29
    assert feasible.tolist() == [True, True, True, False, True, True]
    assert torch.equal(k_ll > -5e29, feasible)
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.cpu().numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(k_ll.cpu()[feasible.cpu()].numpy(),
                               ll.cpu()[feasible.cpu()].numpy(), rtol=1e-5)
    ok, unit_err, row_l2 = ctc_loss.grad_agreement(k_grad, grad, g.to(card))
    assert ok, (unit_err, row_l2)
    assert bool((k_grad[3] == 0).all()) and bool((k_grad[5] == 0).all())


@pytest.mark.parametrize('layout', ['rows', 'gather'])
@pytest.mark.parametrize('C,L', [(38, 20), (300, 20), (BPE_CLASSES, 128)],
                         ids=['c38', 'c300', 'c5000'])
def test_ctc_loss_layouts_equal_plain(card, layout, C, L):
    """Each staging of the two kernels, forced whatever the rule says, on a
    short, an empty, an infeasible and a repeated-label row (K1b's whole C
    5000 rows do not fit: the forward alone there)."""
    from convasr_tpu_torch.ops import ctc_loss
    T = 90 if L < 100 else 300
    lp, y, xlen, ylen, blank = loss_batch(seed=36, B=5, T=T, C=C, L=L, empty_row=True,
                                          infeasible_row=True)
    xlen[0] = T - 40
    y[2, ::2] = 3
    g = torch.from_numpy(np.random.RandomState(5).uniform(0.5, 1.5, 5).astype(np.float32))
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    alpha, ll = ctc_loss.alpha_plain(*on_card, blank)
    grad = ctc_loss.beta_grad_plain(*on_card, alpha, ll, g.to(card), blank)
    before = backward_launches()
    k_alpha, k_ll = ctc_loss._alpha_depth(*on_card, blank, ctc_loss.ALPHA_DEPTH, layout)
    torch.cuda.synchronize()
    feasible = ll > -5e29
    assert torch.equal(k_ll > -5e29, feasible) and not bool(feasible.all())
    np.testing.assert_allclose(k_alpha.cpu().numpy(), alpha.cpu().numpy(), rtol=1e-5, atol=1e-3)
    if layout == 'gather' or C < BPE_CLASSES:
        k_grad = ctc_loss._beta_grad_route(*on_card, alpha, ll, g.to(card), blank, 'warp',
                                           layout)
        torch.cuda.synchronize()
        ok, unit_err, row_l2 = ctc_loss.grad_agreement(k_grad, grad, g.to(card))
        assert ok, (unit_err, row_l2)
        assert bool((k_grad[~feasible] == 0).all())
    assert backward_launches() == before


def test_warp_route_rule_equals_the_library(card):
    """ops/ctc_loss.beta_grad_warp_fits, which reads the rule from the source
    without a build, names the route the library's own rule names."""
    from convasr_tpu_torch.ops import ctc_loss
    lib = ctc_loss._library()
    for L in (0, 1, 20, 40, 128, 255, 256, 257, 511, 600):
        for C in (2, 38, 129, 516, 517, 1028, 2048, 5000, 20000, 60000):
            assert ctc_loss.beta_grad_warp_fits(L, C) == bool(
                lib.ctc_loss_beta_grad_warp_fits(L, C)), (L, C)


def test_viterbi_at_the_bpe_head(card):
    """K3 at C 5000 (B4 T300 L40): the route names the warp kernel, which
    stages only the lattice's L+1 classes a frame at that width; char frames
    and final alpha bit-equal to the plain version."""
    lp, y, xlen, ylen, blank = make_batch(19, B=4, T=300, C=BPE_CLASSES, L=40)
    frames, final = ctc_alignment(lp, y, xlen, ylen, blank=blank, return_final=True)
    assert align.viterbi_route(y.shape[1], BPE_CLASSES) == 'warp'
    assert align.viterbi_gathers(y.shape[1], BPE_CLASSES)
    before = viterbi_launches()
    k_frames, k_final = align.ctc_alignment_kernel(*(t.to(card) for t in (lp, y, xlen, ylen)),
                                                   blank=blank, return_final=True)
    torch.cuda.synchronize()
    assert viterbi_launches() == (before[0] + 1, before[1])
    np.testing.assert_array_equal(k_frames.cpu().numpy(), frames.numpy())
    np.testing.assert_array_equal(k_final.cpu().numpy(), final.numpy())


# the gathered staging at a BPE head's C on each backpointer route: (B, T, L)
GATHERED_CASES = dict(L128_resident=(4, 301, 128), L40_resident=(5, 300, 40),
                      L128_spill=(3, 1900, 128), L40_spill=(3, 1900, 40))


@pytest.mark.parametrize('case', GATHERED_CASES)
def test_viterbi_gathered_routes(card, case):
    """The warp kernel at C 5000 with the lattice's classes staged, its
    backpointers resident in shared memory or spilled: bit-equal to the plain
    version with the rule's staging and with the gather forced; whole rows
    do not fit at that width, and forcing them raises (no fallback)."""
    B, T, L = GATHERED_CASES[case]
    lp, y, xlen, ylen, blank = make_batch(70 + L + T, B=B, T=T, C=BPE_CLASSES, L=L,
                                          repeated=True, empty_row=True, xlen_rows=(0, T))
    spill = 'spill' in case
    assert (align.spill_words(T, L, BPE_CLASSES) > 0) == spill
    frames, final = ctc_alignment(lp, y, xlen, ylen, blank=blank, return_final=True)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    for layout in ('rule', 'gather'):
        k_frames, k_final = align._alignment_route(*on_card, blank=blank, route='warp',
                                                   return_final=True, layout=layout)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(k_frames.cpu().numpy(), frames.numpy())
        np.testing.assert_array_equal(k_final.cpu().numpy(), final.numpy())
    with pytest.raises(RuntimeError, match='CUDA error 1 '):
        align._alignment_route(*on_card, blank=blank, route='warp', layout='rows')


@pytest.mark.parametrize('C', [38, 1024])
def test_viterbi_rows_and_gather_agree_where_both_fit(card, C):
    """Both stagings of the warp kernel, forced, bit-equal to the plain
    version at the char head's width and past the rule's crossover (C 1024,
    a short lattice: whole rows still fit there)."""
    L = 40 if C == 38 else 4
    lp, y, xlen, ylen, blank = make_batch(90 + L, B=6, T=120, C=C, L=L, repeated=True,
                                          empty_row=True, xlen_rows=(0, 120))
    frames, final = ctc_alignment(lp, y, xlen, ylen, blank=blank, return_final=True)
    on_card = [t.to(card) for t in (lp, y, xlen, ylen)]
    for layout in ('rows', 'gather'):
        k_frames, k_final = align._alignment_route(*on_card, blank=blank, route='warp',
                                                   return_final=True, layout=layout)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(k_frames.cpu().numpy(), frames.numpy())
        np.testing.assert_array_equal(k_final.cpu().numpy(), final.numpy())


def test_viterbi_block_pair_past_the_warp_kernel_at_the_bpe_head(card):
    """At C 5000 a lattice past WARP_S_MAX states (S 1201) still goes to the
    block pair, counted there."""
    lp, y, xlen, ylen, blank = make_batch(21, B=2, T=40, C=BPE_CLASSES, L=600)
    frames, final = ctc_alignment(lp, y, xlen, ylen, blank=blank, return_final=True)
    assert align.viterbi_route(600, BPE_CLASSES) == 'block'
    before = viterbi_launches()
    k_frames, k_final = align.ctc_alignment_kernel(*(t.to(card) for t in (lp, y, xlen, ylen)),
                                                   blank=blank, return_final=True)
    torch.cuda.synchronize()
    assert viterbi_launches() == (before[0], before[1] + 1)
    np.testing.assert_array_equal(k_frames.cpu().numpy(), frames.numpy())
    np.testing.assert_array_equal(k_final.cpu().numpy(), final.numpy())


def test_viterbi_route_rule_equals_the_library(card):
    """ops/align.viterbi_route and viterbi_gathers, which read the rules from
    the source without a build, name the route and the staging the
    library's own rules name, at every (L, C) of
    scripts/viterbi_layout_sweep.py and around the crossovers."""
    lib = align._library()
    for L in (0, 1, 20, 40, 128, 255, 256, 400, 511, 512, 600):
        for C in (2, 38, 129, 256, 516, 768, 1024, 2048, 5000, 20000):
            assert align.viterbi_route(L, C) == ('warp' if lib.ctc_viterbi_warp_fits(L, C)
                                                 else 'block'), (L, C)
            assert align.viterbi_gathers(L, C) == bool(
                lib.ctc_viterbi_warp_gathers(L, C, align.LAYOUTS['rule'])), (L, C)


@pytest.mark.parametrize('Cout', [1024, BPE_CLASSES], ids=['bpe_conv0', 'bpe_conv1'])
def test_int8_conv_at_the_bpe_head(card, Cout):
    """P3 on the BPE head's convs (K 15, Cin 1024, B8 T301): Cout 5000 is no
    multiple of the kernel's 128/192-channel tiles, so its last tile is
    ragged; bit-equal to the float64 plain version, on the wgmma kernel."""
    from convasr_tpu_torch.ops import int8
    x, w = (t.to(card) for t in int8_tensors(41 + Cout, (8, 301, 1024), (15, 1024, Cout)))
    assert int8.wgmma_conv_fits(301, 1024, 15, 1, 1)
    before = (int8.CONV_LAUNCHES, int8.CONV_MMA_SYNC_LAUNCHES)
    got = int8.int8_conv1d(x, w)
    want = int8.int8_conv1d_plain(x, w)
    torch.cuda.synchronize()
    assert (int8.CONV_LAUNCHES, int8.CONV_MMA_SYNC_LAUNCHES) == (before[0] + 1, before[1])
    assert got.shape == (8, 301, Cout) and torch.equal(got, want)


def test_a_traced_train_step_shares_the_profilers_clock(card):
    """One train step of a small JasperNet under torch.profiler: the span
    recorder's `train.update` lies within 1 ms of its own profiler range in
    the same profile, the card's timeline holds no copy of a span (which a
    reader of the trace would count as busy time), and no device operation
    of the step starts before its `train.step` span (the card's events are
    on the Unix clock too, as the benchmark's idle shares by span need)."""
    from torch.profiler import ProfilerActivity, profile
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.infra import profiler
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.train import loop
    from convasr_tpu_torch.train.optim import make_optimizer, noop_lr
    torch.manual_seed(0)
    model = create_model('JasperNetSmall', 64, (38,), dropout=0.0,
                         frontend=LogFilterBankFrontend(64, 8000, 0.02, 0.01, dither=0.0)).to(card)
    tx = loop.make_optimizer_with_accum(make_optimizer('NovoGrad', noop_lr(1e-3)), max_grad_norm=1.0)
    state, step = loop.init_train_state(model, tx), loop.make_train_step(model, tx)
    rng = np.random.RandomState(0)
    batch = dict(x=torch.from_numpy((0.1 * rng.randn(8, 32000)).astype(np.float32)).to(card),
                 xlen=torch.ones(8, device=card),
                 y=torch.from_numpy(rng.randint(0, 37, (8, 1, 40))).to(card),
                 ylen=torch.full((8, 1), 40, device=card))
    step(state, batch)                                    # builds and warms the kernels
    torch.cuda.synchronize()
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    spans = {s.name: s for s in profiler.snapshot()['spans']}
    profiler.reset()
    assert spans['train.update'].traced and spans['train.update'].id == 1
    events = list(prof.profiler.kineto_results.events())
    (update,) = [e for e in events if e.name() == 'train.update'
                 and e.device_type() != torch.autograd.DeviceType.CUDA]
    assert abs(update.start_ns() - spans['train.update'].start_ns) < 1_000_000
    assert abs(update.end_ns() - spans['train.update'].end_ns) < 1_000_000
    device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert device and not [e.name() for e in device if e.name().startswith('train.')]
    assert min(e.start_ns() for e in device) >= spans['train.step'].start_ns - 1_000_000


# --- NovoGrad's fused update (ops/novograd_update.py) against the chain ---

# JasperNet's kinds of leaves at small widths: conv weights (Cout, Cin, K),
# batch-norm scales and shifts, a one-tap head and its bias; two leaves of
# more than a block's CHUNK elements with ragged ends, one of 105 elements
FUSED_LEAVES = [(256, 64, 11), (256,), (256,), (256, 256, 13), (256,), (256,), (3, 5, 7),
                (38, 256, 1), (38,)]
# the kernels sum squares in another order than torch._foreach_norm, so the
# denominators and the clip's norm differ from the chain's by float32
# rounding of those sums; each element's own arithmetic rounds as the
# chain's does. Per leaf, the norm of the difference over the chain's norm:
FUSED_RTOL = 1e-5


def fused_leaves(card, seed):
    """FUSED_LEAVES' parameters on the card, the head's weight a view 4
    bytes past its buffer's start (the kernels' element-by-element path)."""
    gen = torch.Generator().manual_seed(seed)
    params = []
    for i, shape in enumerate(FUSED_LEAVES):
        x = 0.1 * torch.randn(shape, generator=gen)
        if i == 7:
            params.append(torch.empty(x.numel() + 1, device=card)[1:].view(shape).copy_(x))
        else:
            params.append(x.to(card))
    return params


def assert_leaves_close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        err = float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))
        assert err <= FUSED_RTOL, f'{what}[{i}] {tuple(b.shape)}: {err:.3g}'


def _flat_state(state):
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _flat_state(state[k])]
    if isinstance(state, (list, tuple)):
        return [t for s in state for t in _flat_state(s)]
    return [state] if torch.is_tensor(state) else []


@pytest.mark.parametrize('lr', ['float', 'device'])
@pytest.mark.parametrize('case', ['clipped_then_not', 'nonfinite', 'no_clip'])
def test_fused_novograd_equals_the_chain(card, case, lr):
    """Four steps of the fused update against the chain's from the same start
    on a JasperNet-shaped leaf list: the first step, steps above and below
    the clip's norm in turns, a step whose loss is not finite (nothing
    changes, grad_norm reads 0), no clip; the rate a Python float or a 0-dim
    tensor on the card (a schedule)."""
    from convasr_tpu_torch.ops import novograd_update
    from convasr_tpu_torch.train import loop, optim
    schedule = optim.noop_lr(1e-2) if lr == 'float' else optim.multistep_lr(1e-2, 0.5, [2])
    elements = sum(int(np.prod(s)) for s in FUSED_LEAVES)
    # gradients of unit deviation have a norm near sqrt(elements): scaled by
    # 4 they pass the clip's norm, by 0.25 they stay below it
    max_norm = 0.0 if case == 'no_clip' else float(np.sqrt(elements))
    tx = loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', schedule, weight_decay=1e-3, betas=(0.95, 0.5)),
        max_grad_norm=max_norm)
    params = fused_leaves(card, 0)
    chain_params = [p.clone() for p in params]
    state, chain_state = tx.init(params), tx.init(chain_params)
    assert tx.fused is not None
    scratch = novograd_update.Scratch([p.numel() for p in params], card)
    gen = torch.Generator().manual_seed(1)
    for k, scale in enumerate([4.0, 0.25, 4.0, 0.25]):
        grads = [(scale * torch.randn(p.shape, generator=gen)).to(card) for p in params]
        finite = torch.tensor(not (case == 'nonfinite' and k == 2), device=card)
        before = [t.clone() for t in params + _flat_state(state)]
        launches = (novograd_update.NORM_LAUNCHES, novograd_update.UPDATE_LAUNCHES)
        grad_norm, weight_norm = tx.fused.step(grads, state, params, finite, scratch)
        chain_state, chain_grad_norm, chain_weight_norm = loop.chain_update(
            tx, grads, chain_state, chain_params, finite)
        torch.cuda.synchronize()
        assert (novograd_update.NORM_LAUNCHES, novograd_update.UPDATE_LAUNCHES) == \
            (launches[0] + 1, launches[1] + 1)
        if not bool(finite):
            assert float(grad_norm) == float(chain_grad_norm) == 0.0
            after = params + _flat_state(state)
            assert all(torch.equal(a, b) for a, b in zip(after, before))
        else:
            assert float(scratch.clip[1]) == float(case != 'no_clip' and scale > 1)
        nv, schedule_state = tx.fused.parts(state)
        chain_nv, chain_schedule = tx.fused.parts(chain_state)
        assert int(nv['step']) == int(chain_nv['step']) and \
            int(schedule_state['count']) == int(chain_schedule['count'])
        assert_leaves_close(params, chain_params, f'step {k} params')
        assert_leaves_close(nv['momentum'], chain_nv['momentum'], f'step {k} momentum')
        assert_leaves_close([nv['grads_ema']], [chain_nv['grads_ema']], f'step {k} ema')
        np.testing.assert_allclose(float(grad_norm), float(chain_grad_norm), rtol=FUSED_RTOL)
        np.testing.assert_allclose(float(weight_norm), float(chain_weight_norm), rtol=FUSED_RTOL)
    assert int(tx.fused.parts(state)[0]['step']) == (3 if case == 'nonfinite' else 4)


def test_fused_novograd_repeats_bit_for_bit(card):
    """The sums reduce in a fixed order: the same step twice gives the same
    bits."""
    from convasr_tpu_torch.ops import novograd_update
    from convasr_tpu_torch.train import loop, optim
    tx = loop.make_optimizer_with_accum(optim.make_optimizer('NovoGrad', optim.noop_lr(1e-2)),
                                        max_grad_norm=1.0)
    runs = []
    for _ in range(2):
        params = fused_leaves(card, 3)
        state = tx.init(params)
        scratch = novograd_update.Scratch([p.numel() for p in params], card)
        gen = torch.Generator().manual_seed(4)
        for _ in range(2):
            grads = [torch.randn(p.shape, generator=gen).to(card) for p in params]
            norms = tx.fused.step(grads, state, params, torch.tensor(True, device=card), scratch)
        runs.append([t.cpu() for t in params + _flat_state(state) + list(norms)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def small_jasper(card, name='JasperNetSmall'):
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.zoo import create_model
    torch.manual_seed(0)
    return create_model(name, 64, (38,), dropout=0.0, base_width=8,
                        frontend=LogFilterBankFrontend(64, 8000, 0.02, 0.01, dither=0.0)).to(card)


def small_batch(card, infeasible=False):
    rng = np.random.RandomState(0)
    batch = dict(x=torch.from_numpy((0.1 * rng.randn(4, 16000)).astype(np.float32)).to(card),
                 xlen=torch.ones(4, device=card),
                 y=torch.from_numpy(rng.randint(0, 37, (4, 1, 20))).to(card),
                 ylen=torch.full((4, 1), 20, device=card))
    if infeasible:   # 20 labels in a few frames: an infinite loss
        batch['xlen'][1] = 0.01
    return batch


def test_fused_train_step_skips_a_nonfinite_loss(card):
    """The train step on the fused route: a finite step launches each kernel
    once; a step whose loss is not finite leaves the parameters, the
    optimizer state and the batch norms' running statistics bit for bit as
    they were, and reads grad_norm 0."""
    from convasr_tpu_torch.infra import profiler
    from convasr_tpu_torch.ops import novograd_update
    from convasr_tpu_torch.train import loop, optim
    model = small_jasper(card)
    tx = loop.make_optimizer_with_accum(optim.make_optimizer('NovoGrad', optim.noop_lr(1e-3)),
                                        max_grad_norm=1.0)
    state, step = loop.init_train_state(model, tx), loop.make_train_step(model, tx)
    counts = lambda: (novograd_update.NORM_LAUNCHES, novograd_update.UPDATE_LAUNCHES,  # noqa: E731
                      novograd_update.STASH_LAUNCHES, novograd_update.RESTORE_LAUNCHES)
    before = counts()
    previous = profiler.enable(True)
    profiler.reset()
    try:
        m = step(state, small_batch(card))
        fused_counts = [c for c in profiler.snapshot()['counts'] if c.name == 'train.update.fused']
    finally:
        profiler.enable(previous)
        profiler.reset()
    assert float(m['finite']) == 1.0 and float(m['grad_norm']) > 0
    assert counts() == tuple(c + 1 for c in before) and len(fused_counts) == 1
    opt_state = state.opt_state
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    kept_opt = [t.clone() for t in _flat_state(opt_state)]
    m = step(state, small_batch(card, infeasible=True))
    torch.cuda.synchronize()
    assert float(m['finite']) == 0.0 and float(m['grad_norm']) == 0.0
    assert state.opt_state is opt_state and state.step == 2
    for name, value in model.state_dict().items():
        if not name.endswith('num_batches_tracked'):
            assert torch.equal(value, kept[name]), name
    assert all(torch.equal(a, b) for a, b in zip(_flat_state(opt_state), kept_opt))


@pytest.mark.parametrize('case', ['float64', 'non_contiguous', 'too_many_leaves', 'train_step'])
def test_fused_route_refuses_what_its_kernels_cannot_take(card, case):
    """On the fused route (the composition carries it, the parameters are on
    the card) tensors the kernels cannot take raise ValueError, from the
    update and from the train step: the chain never runs in their place."""
    from convasr_tpu_torch.ops import novograd_update
    from convasr_tpu_torch.train import loop, optim
    tx = loop.make_optimizer_with_accum(optim.make_optimizer('NovoGrad', optim.noop_lr(1e-3)),
                                        max_grad_norm=1.0)
    if case == 'train_step':
        model = small_jasper(card)
        weight = next(p for p in model.parameters() if p.dim() == 3 and p.shape[2] > 1)
        weight.data = weight.data.transpose(0, 2).contiguous().transpose(0, 2)
        state, step = loop.init_train_state(model, tx), loop.make_train_step(model, tx)
        launches = novograd_update.UPDATE_LAUNCHES
        with pytest.raises(ValueError, match='non-contiguous'):
            step(state, small_batch(card))
        assert novograd_update.UPDATE_LAUNCHES == launches
        return
    n = novograd_update.MAX_LEAVES + 1 if case == 'too_many_leaves' else 3
    params = [torch.ones(2, 6, device=card, dtype=torch.float64 if case == 'float64'
                         else torch.float32) for _ in range(n)]
    if case == 'non_contiguous':
        params[1] = torch.ones(6, 2, device=card).t()
    state = tx.init(params)
    scratch = novograd_update.Scratch([p.numel() for p in params], card)
    match = dict(float64='torch.float64', non_contiguous='non-contiguous',
                 too_many_leaves='more than')[case]
    with pytest.raises(ValueError, match=match):
        tx.fused.step([torch.ones_like(p) for p in params], state, params,
                      torch.tensor(True, device=card), scratch)


def test_fused_update_launches_do_not_grow_with_the_leaves(card):
    """By torch.profiler: the launches (kernels, copies, fills) inside one
    `train.update` on the fused route are as many for JasperNetBig's leaves
    as for JasperNetSmall's, where the chain's grow with them."""
    from torch.profiler import ProfilerActivity, profile
    from convasr_tpu_torch.infra import profiler
    from convasr_tpu_torch.train import loop, optim
    launch = ('cudaLaunch', 'cuLaunch', 'cudaMemcpy', 'cudaMemset', 'cuMemcpy', 'cuMemset')
    counts = {}
    for name in ('JasperNetSmall', 'JasperNetBig'):
        for route in ('fused', 'chain'):
            model = small_jasper(card, name)
            tx = loop.make_optimizer_with_accum(
                optim.make_optimizer('NovoGrad', optim.noop_lr(1e-3)), max_grad_norm=1.0)
            if route == 'chain':
                tx = tx._replace(fused=None)
            state, step = loop.init_train_state(model, tx), loop.make_train_step(model, tx)
            step(state, small_batch(card))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(state, small_batch(card))
                torch.cuda.synchronize()
            profiler.reset()
            events = list(prof.profiler.kineto_results.events())
            (update,) = [e for e in events if e.name() == 'train.update'
                         and e.device_type() != torch.autograd.DeviceType.CUDA]
            counts[name, route] = (len(list(model.parameters())), len([
                e for e in events if e.name().startswith(launch)
                and e.device_type() != torch.autograd.DeviceType.CUDA
                and update.start_ns() <= e.start_ns() <= update.end_ns()]))
    small, big = counts['JasperNetSmall', 'fused'], counts['JasperNetBig', 'fused']
    assert big[0] > 2 * small[0], counts
    assert big[1] == small[1] and 0 < big[1] < 40, counts
    assert counts['JasperNetBig', 'chain'][1] > counts['JasperNetSmall', 'chain'][1] > big[1], \
        counts
