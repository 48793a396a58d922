"""The port's CTC loss against the JAX package's: `CTCLoss` (on the CPU, the
kernels' plain versions) against `ctc_loss_pallas_v2` in interpret mode, the
plain versions against the Pallas kernels' own runs, and the plain time scan
of ops/ctc.py against the JAX scan. The five cases of
tests/test_ctc_pallas_v2.py, and two more."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from convasr_tpu.ops.ctc import ctc_loss as jax_scan
from convasr_tpu.ops.ctc_pallas import _final_ll, _prepare
from convasr_tpu.ops.ctc_pallas_v2 import _run_alpha, _run_beta_grad, ctc_loss_pallas_v2
from convasr_tpu_torch.ops import ctc_loss as port
from convasr_tpu_torch.ops.ctc import ctc_loss as port_scan


def make_batch(seed, B=5, T=37, C=7, L=5, blank=None):
    """test_ctc_pallas_v2.make_batch, as numpy: log-probs, targets, lengths."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, C).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    blank = C - 1 if blank is None else blank
    labels = np.array([c for c in range(C) if c != blank])
    y = labels[rng.randint(0, C - 1, size=(B, L))].astype(np.int32)
    xlen = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    ylen = rng.randint(1, L + 1, size=B).astype(np.int32)
    return lp, y, xlen, ylen, blank


def infeasible_batch():
    B, T, C = 3, 18, 6
    rng = np.random.RandomState(4)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(rng.randn(B, T, C).astype(np.float32)), -1))
    y = np.tile(np.array([0, 1, 0, 1, 0], np.int32), (B, 1))
    xlen = np.array([18, 4, 18], np.int32)   # row 1 needs at least 9 frames
    ylen = np.array([5, 5, 3], np.int32)
    return lp, y, xlen, ylen, C - 1


def case_batch(case):
    if case == 'forward':
        return make_batch(0)
    if case == 'odd_shapes':      # B and T not multiples of the TPU tile and chunk
        return make_batch(1, B=3, T=19, C=6, L=4)
    if case == 'empty_target':
        lp, y, xlen, ylen, blank = make_batch(2, B=2)
        return lp, y, xlen, np.array([0, 3], np.int32), blank
    if case == 'gradient':
        return make_batch(3, B=2, T=21, C=6, L=4)
    if case == 'infeasible':
        return infeasible_batch()
    if case == 'non_last_blank':
        return make_batch(5, B=4, T=23, C=7, L=5, blank=0)
    raise KeyError(case)


CASES = ['forward', 'odd_shapes', 'empty_target', 'gradient', 'infeasible', 'non_last_blank']


def port_loss_and_grad(lp, y, xlen, ylen, blank):
    """CTCLoss on the CPU: per-row loss and the gradient of the sum of its
    finite entries (the masked sum of test_ctc_pallas_v2)."""
    x = torch.tensor(lp, requires_grad=True)
    loss = port.ctc_loss_auto(x, torch.from_numpy(y), torch.from_numpy(xlen),
                              torch.from_numpy(ylen), blank=blank)
    torch.where(torch.isfinite(loss), loss, 0.0).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def jax_loss_and_grad(fn, lp, y, xlen, ylen, blank):
    args = (jnp.asarray(y), jnp.asarray(xlen), jnp.asarray(ylen))

    def masked_sum(l):
        out = fn(l, *args, blank)
        return jnp.where(jnp.isfinite(out), out, 0.0).sum()
    return np.asarray(fn(jnp.asarray(lp), *args, blank)), \
        np.asarray(jax.grad(masked_sum)(jnp.asarray(lp)))


@pytest.mark.parametrize('case', CASES)
def test_ctc_loss_matches_pallas_v2(case):
    lp, y, xlen, ylen, blank = case_batch(case)
    loss, grad = port_loss_and_grad(lp, y, xlen, ylen, blank)
    ref_loss, ref_grad = jax_loss_and_grad(
        lambda l, y_, x_, yl_, b: ctc_loss_pallas_v2(l, y_, x_, yl_, b, True),
        lp, y, xlen, ylen, blank)
    assert np.array_equal(np.isinf(loss), np.isinf(ref_loss))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-3, atol=1e-4)
    if case == 'infeasible':
        assert np.isinf(loss[1]) and np.abs(grad[1]).max() == 0.0
        assert np.isfinite(grad).all()


@pytest.mark.parametrize('case', CASES)
def test_plain_scan_matches_jax_scan(case):
    lp, y, xlen, ylen, blank = case_batch(case)
    x = torch.tensor(lp, requires_grad=True)
    loss = port_scan(x, torch.from_numpy(y), torch.from_numpy(xlen), torch.from_numpy(ylen),
                     blank=blank)
    torch.where(torch.isfinite(loss), loss, 0.0).sum().backward()
    ref_loss, ref_grad = jax_loss_and_grad(
        lambda l, y_, x_, yl_, b: jax_scan(l, y_, x_, yl_, blank=b), lp, y, xlen, ylen, blank)
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize('case', CASES)
def test_plain_versions_match_pallas_kernels(case):
    """alpha_plain / beta_grad_plain against _run_alpha / _run_beta_grad in
    interpret mode; the JAX dE is scattered to classes as _bwd does."""
    lp, y, xlen, ylen, blank = case_batch(case)
    B, T, C = lp.shape
    S = 2 * y.shape[1] + 1
    E, skip, final_mask, ext, _ = _prepare(jnp.asarray(lp), jnp.asarray(y), jnp.asarray(xlen),
                                           jnp.asarray(ylen), blank)
    ref_alpha = _run_alpha(E, skip, jnp.asarray(xlen), interpret=True)
    ref_ll = _final_ll(ref_alpha, jnp.asarray(xlen), final_mask)
    dE = np.asarray(_run_beta_grad(E, skip, jnp.asarray(xlen), final_mask, ref_alpha, ref_ll,
                                   interpret=True))
    g = np.random.RandomState(7).uniform(0.5, 1.5, B).astype(np.float32)
    feasible = np.asarray(ref_ll) > -5e29
    onehot = np.eye(C, dtype=np.float32)[np.asarray(ext)]              # (B, S_pad, C)
    ref_grad = np.einsum('bts,bsc->btc', -dE * np.where(feasible, g, 0)[:, None, None], onehot)

    t = [torch.from_numpy(a) for a in (lp, y, xlen, ylen)]
    alpha, ll = port.alpha_plain(*t, blank=blank)
    grad = port.beta_grad_plain(*t, alpha, ll, torch.from_numpy(g), blank=blank)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha)[:, :, :S], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ll.numpy()[feasible], np.asarray(ref_ll)[feasible], rtol=1e-5)
    assert (ll.numpy()[~feasible] <= -5e29).all()
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=1e-3, atol=1e-5)


def test_plain_versions_hold_against_the_scan():
    """The plain versions' loss and gradient against the time scan of
    ops/ctc.py, their CPU oracle, on a batch with rows shorter than T."""
    lp, y, xlen, ylen, blank = make_batch(8, B=6, T=40, C=9, L=7)
    t = [torch.from_numpy(a) for a in (lp, y, xlen, ylen)]
    x = torch.tensor(lp, requires_grad=True)
    port.ctc_loss_auto(x, *t[1:], blank=blank).sum().backward()
    x_ref = torch.tensor(lp, requires_grad=True)
    ref = port_scan(x_ref, *t[1:], blank=blank)
    ref.sum().backward()
    alpha, ll = port.alpha_plain(*t, blank=blank)
    np.testing.assert_allclose(-ll.numpy(), ref.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), x_ref.grad.numpy(), rtol=1e-3, atol=1e-5)


def test_zero_input_length_differs_from_the_scan():
    """A row with xlen = 0: the TPU kernel (and the port's CTCLoss, which
    follows it) gives +inf and a zero gradient; the time scan takes frame 0
    anyway and gives a finite loss. The train path never feeds xlen = 0,
    since output lengths are ceil(fraction * T) of a positive fraction."""
    lp, y, xlen, ylen, blank = make_batch(6, B=3, T=20, C=6, L=3)
    xlen[1] = 0
    ylen[1] = 0
    loss, grad = port_loss_and_grad(lp, y, xlen, ylen, blank)
    ref_loss, ref_grad = jax_loss_and_grad(
        lambda l, y_, x_, yl_, b: ctc_loss_pallas_v2(l, y_, x_, yl_, b, True),
        lp, y, xlen, ylen, blank)
    scan = np.asarray(jax_scan(jnp.asarray(lp), jnp.asarray(y), jnp.asarray(xlen),
                               jnp.asarray(ylen)))
    assert np.isinf(loss[1]) and np.isinf(ref_loss[1]) and np.isfinite(scan[1])
    assert np.abs(grad[1]).max() == 0.0
    np.testing.assert_allclose(loss[[0, 2]], ref_loss[[0, 2]], rtol=1e-4)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-3, atol=1e-4)


def test_kernel_wrappers_refuse_cpu_tensors():
    lp, y, xlen, ylen, blank = make_batch(9, B=2, T=8)
    t = [torch.from_numpy(a) for a in (lp, y, xlen, ylen)]
    with pytest.raises(ValueError, match='CUDA tensors'):
        port.alpha_kernel(*t, blank=blank)
    before = (port.ALPHA_LAUNCHES, port.BETA_GRAD_LAUNCHES)
    port.ctc_loss_auto(*t, blank=blank)
    assert (port.ALPHA_LAUNCHES, port.BETA_GRAD_LAUNCHES) == before


@pytest.mark.parametrize('depth', [2, 4, 8, 16, 32])
def test_alpha_ring_depths_refuse_cpu_tensors(depth):
    """Each ring depth of the forward kernel (the path's is ALPHA_DEPTH, read
    from csrc/ctc_loss.cu) is a card-only launch that counts nothing."""
    assert port.ALPHA_DEPTH in (2, 4, 8, 16, 32)
    lp, y, xlen, ylen, blank = make_batch(11, B=2, T=8)
    t = [torch.from_numpy(a) for a in (lp, y, xlen, ylen)]
    before = port.ALPHA_LAUNCHES
    with pytest.raises(ValueError, match='CUDA tensors'):
        port._alpha_depth(*t, blank, depth)
    assert port.ALPHA_LAUNCHES == before


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    lp, y, xlen, ylen, blank = make_batch(10, B=2, T=8)
    t = [torch.from_numpy(a) for a in (lp, y, xlen, ylen)]
    alpha, ll = port.alpha_plain(*t, blank)
    g = torch.ones(2)
    before = (port.BETA_GRAD_LAUNCHES, port.BETA_GRAD_WARP_LAUNCHES)
    for route in ('warp', 'block'):
        with pytest.raises(ValueError, match='CUDA tensors'):
            port._beta_grad_route(*t, alpha, ll, g, blank, route)
    with pytest.raises(ValueError, match='CUDA tensors'):
        port.beta_grad_kernel(*t, alpha, ll, g, blank)
    assert (port.BETA_GRAD_LAUNCHES, port.BETA_GRAD_WARP_LAUNCHES) == before


# (L, C) -> whether the warp backward kernel takes the lattice
WARP_RULE_CASES = [
    ((128, 38), True),          # the train path: S = 257, 9 states a lane
    ((511, 38), False),         # S = 1023: the warp kernel's reach, past the crossover
    ((512, 38), False),         # S = 1025: past the warp kernel's reach, the block kernel
    ((700, 40), False),
    ((0, 38), True),            # no targets: one state
    ((128, 7000), False),       # two chunks of 8 rows of 7000 classes: past shared memory
    ((256, 38), True),          # S = 513: the most the route sends to the warp kernel
    ((257, 38), False),         # S = 515: past the crossover, the block kernel
]


@pytest.mark.parametrize('shape,fits', WARP_RULE_CASES, ids=[str(c[0]) for c in WARP_RULE_CASES])
def test_beta_grad_warp_rule(shape, fits, monkeypatch):
    """The rule reads WARP_S_MAX from csrc/ctc_loss.cu and refuses S past it
    without asking the library; inside that, the library's shared-memory check
    (stubbed here with the case's answer; tests/test_torch_cuda.py asks the
    real one) decides."""
    L, C = shape
    asked = []

    class Library:
        @staticmethod
        def ctc_loss_beta_grad_warp_fits(*args):
            asked.append(args)
            return int(fits)
    monkeypatch.setattr(port, '_library', Library)
    assert port.WARP_S_MAX == 513
    assert port.beta_grad_warp_fits(L, C) == fits
    assert asked == ([] if 2 * L + 1 > port.WARP_S_MAX else [(L, C)])
