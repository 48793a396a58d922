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
from convasr_tpu_torch.ops import align as torch_align
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
    before = torch_align.KERNEL_LAUNCHES
    out = torch_align.ctc_alignment_auto(torch.from_numpy(lp), torch.from_numpy(y),
                                         torch.from_numpy(xlen), torch.from_numpy(ylen),
                                         blank=blank)
    np.testing.assert_array_equal(out.numpy(), port(lp, y, xlen, ylen, blank).numpy())
    assert torch_align.KERNEL_LAUNCHES == before


def test_kernel_refuses_cpu_tensors():
    lp, y, xlen, ylen, blank = make_batch(seed=7)
    with pytest.raises(ValueError, match='CUDA tensors'):
        torch_align.ctc_alignment_kernel(torch.from_numpy(lp), torch.from_numpy(y),
                                         torch.from_numpy(xlen), torch.from_numpy(ylen))

