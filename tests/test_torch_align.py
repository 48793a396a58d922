"""The port's CTC alignment against the JAX package's: the plain PyTorch
Viterbi (ops/ctc.py) is bit-equal to both the JAX scan and the Pallas kernel
run in interpret mode. The CUDA kernel is held against the plain version on
the card in test_torch_cuda.py."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import convasr_tpu.ops.align_pallas as ap
import test_torch_cuda as cuda_cases
from convasr_tpu.ops.ctc import ctc_alignment as jax_scan_alignment
from convasr_tpu.ops.ctc_pallas import _prepare
from convasr_tpu_torch.ops import align as torch_align, build
from convasr_tpu_torch.ops.ctc import ctc_alignment, viterbi


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ap.pl, 'pallas_call',
                        functools.partial(ap.pl.pallas_call, interpret=True))


def make_batch(**case):
    """The card tests' seeded cases, as numpy arrays."""
    lp, y, xlen, ylen, blank = cuda_cases.make_batch(**case)
    return lp.numpy(), y.numpy(), xlen.numpy(), ylen.numpy(), blank


def port(lp, y, xlen, ylen, blank, **kw):
    return ctc_alignment(torch.from_numpy(lp), torch.from_numpy(y), torch.from_numpy(xlen),
                         torch.from_numpy(ylen), blank=blank, **kw)


# the small cases: the JAX scan and interpret-mode Pallas run on the CPU
CASES = {k: v for k, v in cuda_cases.CASES.items() if v.get('L', 5) <= 8}


@pytest.mark.parametrize('case', CASES)
def test_plain_equals_jax_scan(case):
    lp, y, xlen, ylen, blank = make_batch(**CASES[case])
    ours = port(lp, y, xlen, ylen, blank).numpy()
    ref = np.asarray(jax_scan_alignment(jnp.asarray(lp), jnp.asarray(y), jnp.asarray(xlen),
                                        jnp.asarray(ylen), blank=blank))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('case', CASES)
def test_plain_equals_pallas_interpret(case):
    lp, y, xlen, ylen, blank = make_batch(**CASES[case])
    args = (jnp.asarray(lp), jnp.asarray(y), jnp.asarray(xlen), jnp.asarray(ylen))
    ours = port(lp, y, xlen, ylen, blank).numpy()
    np.testing.assert_array_equal(ours, np.asarray(ap.ctc_alignment_pallas(*args, blank=blank)))

    # the recursion itself: backpointers and final alpha, state by state
    E, skip, _, _, _ = _prepare(*args, blank)
    bp_ref, final_ref = ap._run_viterbi(E, skip, args[2])
    S = 2 * y.shape[1] + 1
    bp, final = viterbi(torch.from_numpy(lp), torch.from_numpy(y), torch.from_numpy(xlen),
                        torch.from_numpy(ylen), blank)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bp_ref)[:, :, :S])
    np.testing.assert_array_equal(final.numpy(), np.asarray(final_ref)[:, :S])


def test_auto_takes_plain_on_cpu():
    lp, y, xlen, ylen, blank = make_batch(seed=6)
    before = (torch_align.WARP_LAUNCHES, torch_align.BLOCK_LAUNCHES)
    out = torch_align.ctc_alignment_auto(torch.from_numpy(lp), torch.from_numpy(y),
                                         torch.from_numpy(xlen), torch.from_numpy(ylen),
                                         blank=blank)
    np.testing.assert_array_equal(out.numpy(), port(lp, y, xlen, ylen, blank).numpy())
    assert (torch_align.WARP_LAUNCHES, torch_align.BLOCK_LAUNCHES) == before


def test_kernel_refuses_cpu_tensors():
    lp, y, xlen, ylen, blank = make_batch(seed=7)
    with pytest.raises(ValueError, match='CUDA tensors'):
        torch_align.ctc_alignment_kernel(torch.from_numpy(lp), torch.from_numpy(y),
                                         torch.from_numpy(xlen), torch.from_numpy(ylen))


@pytest.mark.parametrize('route', ['warp', 'block'])
def test_each_route_refuses_cpu_tensors(route):
    """Each Viterbi kernel is a card-only launch; the measurement route
    counts nothing."""
    lp, y, xlen, ylen, blank = make_batch(seed=8)
    before = (torch_align.WARP_LAUNCHES, torch_align.BLOCK_LAUNCHES)
    with pytest.raises(ValueError, match='CUDA tensors'):
        torch_align._alignment_route(*(torch.from_numpy(a) for a in (lp, y, xlen, ylen)),
                                     blank=blank, route=route)
    assert (torch_align.WARP_LAUNCHES, torch_align.BLOCK_LAUNCHES) == before


def test_crossover_constant_is_the_sources():
    """The route's crossover is the WARP_S_MAX line of csrc/ctc_viterbi.cu,
    an odd number of states within the warp kernel's reach (32 lanes of at
    most 32 states)."""
    source = (build.CSRC / 'ctc_viterbi.cu').read_text()
    assert f'constexpr int WARP_S_MAX = {torch_align.WARP_S_MAX};' in source
    assert torch_align.WARP_S_MAX % 2 == 1 and 257 <= torch_align.WARP_S_MAX <= 32 * 32


# (L, C) -> whether the library says the warp kernel's buffers fit
ROUTE_CASES = [
    ((128, 38), True),          # the path's: S = 257
    ((0, 38), True),            # no targets: one state
    ((400, 38), True),          # B64 T1500 L400: S = 801
    ((128, 20000), False),      # the warp kernel's ring of log-prob frames passes shared memory
    ('crossover', True),        # S = WARP_S_MAX
    ('past_crossover', True),   # S = WARP_S_MAX + 2: the block pair, the library not asked
    ((700, 40), True),          # 1401 states: the block pair
]


@pytest.mark.parametrize('shape,fits', ROUTE_CASES, ids=[str(c[0]) for c in ROUTE_CASES])
def test_viterbi_route_reads_the_crossover(shape, fits, monkeypatch):
    """The route sends S = 2L+1 past WARP_S_MAX to the block pair without
    asking the library; inside it, the library's shared-memory check (stubbed
    here with the case's answer; tests/test_torch_cuda.py asks the real one)
    decides."""
    L, C = {'crossover': ((torch_align.WARP_S_MAX - 1) // 2, 38),
            'past_crossover': ((torch_align.WARP_S_MAX + 1) // 2, 38)}.get(shape, shape)
    asked = []

    class Library:
        @staticmethod
        def ctc_viterbi_warp_fits(*args):
            asked.append(args)
            return int(fits)
    monkeypatch.setattr(torch_align, '_library', Library)
    inside = 2 * L + 1 <= torch_align.WARP_S_MAX
    assert torch_align.viterbi_route(L, C) == ('warp' if inside and fits else 'block')
    assert asked == ([(L, C)] if inside else [])
