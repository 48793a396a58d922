"""The port's whole-T CTC loss (ops/ctc_loss_whole_t.py; on the CPU, the
plain versions of K2f/K2b) against the JAX package's `ctc_loss_pallas` in
interpret mode: the six cases of tests/test_ctc_pallas.py, a row with
xlen = 0, an infeasible row, and the shared-memory guard. Losses within rtol
1e-5, gradients within atol 1e-5 (float32 sums in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from convasr_tpu.ops.ctc_pallas import _final_ll, _prepare, _run_alpha, ctc_loss_pallas, vmem_fits
from convasr_tpu_torch.ops import ctc_loss, ctc_loss_whole_t as port
from convasr_tpu_torch.ops.align import MAX_SHARED_BYTES


def make_batch(rng, B=4, T=24, C=7, L=5):
    """test_ctc_pallas.make_batch, as numpy."""
    logits = rng.randn(B, T, C).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    y = rng.randint(0, C - 1, size=(B, L)).astype(np.int32)
    xlen = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    ylen = rng.randint(1, L + 1, size=B).astype(np.int32)
    return lp, y, xlen, ylen


def case_inputs(case):
    """-> (inputs, lp is logits, per-row weights of the summed loss)."""
    if case.startswith('forward'):             # test_forward_matches_scan's three batches
        rng = np.random.RandomState(0)
        for _ in range(int(case[-1]) + 1):
            batch = make_batch(rng)
        return batch, False, None
    if case == 'empty_target':
        lp, y, xlen, _ = make_batch(np.random.RandomState(1), B=2)
        return (lp, y, xlen, np.array([0, 3], np.int32)), False, None
    if case == 'batch_not_multiple_of_tile':
        return make_batch(np.random.RandomState(2), B=3), False, None
    if case == 'gradient':                     # through log_softmax of the logits
        rng = np.random.RandomState(3)
        B, T, C, L = 2, 16, 6, 4
        logits = rng.randn(B, T, C).astype(np.float32)
        y = rng.randint(0, C - 1, size=(B, L)).astype(np.int32)
        return (logits, y, np.array([16, 12], np.int32), np.array([4, 3], np.int32)), True, None
    if case == 'weighted_cotangent':
        return make_batch(np.random.RandomState(4), B=2), False, np.array([0.5, 2.0], np.float32)
    raise KeyError(case)


def jax_loss_and_grad(lp, y, xlen, ylen, logits=False, w=None):
    w = np.ones(len(lp), np.float32) if w is None else w
    args = (jnp.asarray(y), jnp.asarray(xlen), jnp.asarray(ylen))

    def loss(x):
        return ctc_loss_pallas(jax.nn.log_softmax(x, axis=-1) if logits else x, *args, None, True)

    def weighted_sum(x):
        out = loss(x)
        return jnp.where(jnp.isfinite(out), jnp.asarray(w) * out, 0.0).sum()
    return np.asarray(loss(jnp.asarray(lp))), np.asarray(jax.grad(weighted_sum)(jnp.asarray(lp)))


def port_loss_and_grad(lp, y, xlen, ylen, logits=False, w=None, fn=port.ctc_loss_whole_t):
    w = torch.ones(len(lp)) if w is None else torch.from_numpy(w)
    x = torch.tensor(lp, requires_grad=True)
    loss = fn(torch.log_softmax(x, -1) if logits else x, torch.from_numpy(y),
              torch.from_numpy(xlen), torch.from_numpy(ylen))
    torch.where(torch.isfinite(loss), w * loss, 0.0).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


CASES = ['forward0', 'forward1', 'forward2', 'empty_target', 'batch_not_multiple_of_tile',
         'gradient', 'weighted_cotangent']


@pytest.mark.parametrize('case', CASES)
def test_matches_ctc_loss_pallas(case):
    batch, logits, w = case_inputs(case)
    loss, grad = port_loss_and_grad(*batch, logits=logits, w=w)
    ref_loss, ref_grad = jax_loss_and_grad(*batch, logits=logits, w=w)
    assert np.isfinite(ref_loss).all()
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=1e-5)


def test_alpha_plain_matches_the_pallas_alpha_kernel():
    """K2f's plain version against _run_alpha (the TPU kernel, interpret) on
    the states of the lattice, with rows of xlen 0 and ylen 0."""
    lp, y, xlen, ylen = make_batch(np.random.RandomState(5), B=5, T=19, C=6, L=4)
    xlen[1], ylen[2], xlen[3], ylen[3] = 0, 0, 0, 1
    E, skip, final_mask, _, _ = _prepare(jnp.asarray(lp), jnp.asarray(y), jnp.asarray(xlen),
                                         jnp.asarray(ylen), lp.shape[-1] - 1)
    ref_alpha = _run_alpha(E, skip, jnp.asarray(xlen), interpret=True)
    ref_ll = np.asarray(_final_ll(ref_alpha, jnp.asarray(xlen), final_mask))
    alpha, ll = port.alpha_whole_t_plain(*(torch.from_numpy(a) for a in (lp, y, xlen, ylen)),
                                         blank=lp.shape[-1] - 1)
    S = 2 * y.shape[1] + 1
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha)[:, :, :S], rtol=1e-5,
                               atol=1e-4)
    feasible = ref_ll > -5e29
    assert feasible[3] and np.array_equal(ll.numpy() > -5e29, feasible)
    np.testing.assert_allclose(ll.numpy()[feasible], ref_ll[feasible], rtol=1e-5)


def test_zero_input_length_row_takes_frame0():
    """A row with xlen = 0 still takes frame 0, as ctc_pallas.py:67-68 does:
    with ylen <= 1 its loss is finite and its gradient zero. K1's CTCLoss
    (the time-chunked v2 semantics) gives it +inf instead."""
    lp, y, xlen, ylen = make_batch(np.random.RandomState(6), B=4, T=20, C=6, L=3)
    xlen[1], ylen[1] = 0, 1            # finite: frame 0's label
    xlen[2], ylen[2] = 0, 0            # finite: frame 0's blank
    xlen[3], ylen[3] = 0, 3            # three labels cannot fit one frame: +inf
    loss, grad = port_loss_and_grad(lp, y, xlen, ylen)
    ref_loss, ref_grad = jax_loss_and_grad(lp, y, xlen, ylen)
    assert np.isfinite(loss[:3]).all() and np.isinf(loss[3]) and np.isinf(ref_loss[3])
    np.testing.assert_allclose(loss[1:3], [-lp[1, 0, y[1, 0]], -lp[2, 0, -1]], rtol=1e-6)
    np.testing.assert_allclose(loss[:3], ref_loss[:3], rtol=1e-5)
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=1e-5)
    assert np.abs(grad[1:]).max() == 0.0 and np.abs(grad[0]).max() > 0
    k1_loss, _ = port_loss_and_grad(lp, y, xlen, ylen, fn=ctc_loss.ctc_loss_auto)
    assert np.isinf(k1_loss[1:]).all()
    np.testing.assert_allclose(k1_loss[0], loss[0], rtol=1e-6)


def test_infeasible_row_gets_inf_and_zero_gradient():
    rng = np.random.RandomState(7)
    lp, y, xlen, ylen = make_batch(rng, B=3, T=18, C=6, L=5)
    y[:] = [0, 1, 0, 1, 0]
    xlen[:], ylen[:] = [18, 4, 18], [5, 5, 3]    # row 1 needs at least 9 frames
    loss, grad = port_loss_and_grad(lp, y, xlen, ylen)
    ref_loss, ref_grad = jax_loss_and_grad(lp, y, xlen, ylen)
    assert np.isinf(loss[1]) and np.isinf(ref_loss[1]) and np.abs(grad[1]).max() == 0.0
    np.testing.assert_allclose(loss[[0, 2]], ref_loss[[0, 2]], rtol=1e-5)
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=1e-5)


# test_vmem_guard's cases on the card's budget: K2 stages T x C float32 frames
# of a row plus 2(2L+1) + C floats in a block's 227 KB; the batch does not
# count (one block per row). At C = 38:
#   B64 T600 L60:   600 * 38 * 4 = 91,200 B of frames, 92,336 B in all: fits;
#   B64 T40000 L500: 6,080,000 B of frames: does not fit.
GUARD_CASES = [(600, 60, 38, True), (40000, 500, 38, False)]


@pytest.mark.parametrize('T, L, C, fits', GUARD_CASES, ids=['T600_L60', 'T40000_L500'])
def test_smem_guard_takes_the_vmem_guard_cases(T, L, C, fits):
    assert port.smem_fits(T, L, C) is fits
    assert vmem_fits(B=64, T=T, L=L) is fits
    assert (port.smem_bytes(T, L, C) <= MAX_SHARED_BYTES) is fits


def test_smem_guard_edge_and_no_limit_on_the_cpu():
    """The largest T that fits at L 60, C 38 is 1521 frames; one more frame
    does not fit the card, but the plain version on the CPU takes it."""
    L, C = 60, 38
    T = max(t for t in range(1400, 1700) if port.smem_fits(t, L, C))
    assert T == 1521 and not port.smem_fits(T + 1, L, C)
    assert port.smem_bytes(T, L, C) <= MAX_SHARED_BYTES < port.smem_bytes(T + 1, L, C)
    rng = np.random.RandomState(8)
    lp = torch.log_softmax(torch.from_numpy(rng.randn(1, T + 1, C).astype(np.float32)), -1)
    y = torch.from_numpy(rng.randint(0, C - 1, size=(1, 2)).astype(np.int32))
    loss = port.ctc_loss_whole_t(lp, y, torch.tensor([T + 1]), torch.tensor([2]))
    assert torch.isfinite(loss).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    lp, y, xlen, ylen = make_batch(np.random.RandomState(9), B=2, T=8)
    t = [torch.from_numpy(a) for a in (lp, y, xlen, ylen)]
    with pytest.raises(ValueError, match='CUDA tensors'):
        port.alpha_kernel(*t, blank=6)
    before = (port.ALPHA_LAUNCHES, port.BETA_GRAD_LAUNCHES)
    port.ctc_loss_whole_t(*t)
    assert (port.ALPHA_LAUNCHES, port.BETA_GRAD_LAUNCHES) == before


# (L, C, what K1b's warp rule says) -> K2b's route
ROUTE_CASES = [(128, 38, True), (256, 38, True), (257, 38, False), (700, 40, False),
               (0, 38, True), (128, 7000, False)]


@pytest.mark.parametrize('L, C, warp', ROUTE_CASES,
                         ids=[f'L{L}_C{C}' for L, C, _ in ROUTE_CASES])
def test_beta_grad_route_follows_the_warp_rule(L, C, warp, monkeypatch):
    """K2b takes K1b's route: K1b's warp kernel exactly where
    ops/ctc_loss.beta_grad_warp_fits takes the lattice (WARP_S_MAX read from
    csrc/ctc_loss.cu, the library's shared-memory check stubbed with the
    case's answer), the whole-T block kernel elsewhere."""
    class Library:
        @staticmethod
        def ctc_loss_beta_grad_warp_fits(*args):
            return int(warp)
    monkeypatch.setattr(ctc_loss, '_library', Library)
    assert port.beta_grad_route(L, C) == ('warp' if ctc_loss.beta_grad_warp_fits(L, C)
                                          else 'block')
    assert (port.beta_grad_route(L, C) == 'warp') == (warp and 2 * L + 1 <= ctc_loss.WARP_S_MAX)


@pytest.mark.parametrize('route', ['warp', 'block'])
def test_beta_grad_routes_refuse_cpu_tensors(route):
    """Each K2b kernel is a card-only launch; neither the wrapper nor the
    measurement route counts a launch on the CPU."""
    lp, y, xlen, ylen = make_batch(np.random.RandomState(10), B=2, T=8)
    t = [torch.from_numpy(a) for a in (lp, y, xlen, ylen)]
    alpha, ll = port.alpha_whole_t_plain(*t, blank=6)
    g = torch.ones(2)
    before = (port.BETA_GRAD_LAUNCHES, port.BETA_GRAD_WARP_LAUNCHES)
    with pytest.raises(ValueError, match='CUDA tensors'):
        port._beta_grad_route(*t, alpha, ll, g, 6, route)
    with pytest.raises(ValueError, match='CUDA tensors'):
        port.beta_grad_kernel(*t, alpha, ll, g, 6)
    assert (port.BETA_GRAD_LAUNCHES, port.BETA_GRAD_WARP_LAUNCHES) == before
