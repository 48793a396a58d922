"""The port's train step against the JAX package's make_train_step: the same
initial weights carried across by models/convert.py, the same batch, float32,
dropout 0 and no dither (random streams cannot match across frameworks), a
reduced JasperNetSmall with the log-mel frontend in front."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from convasr_tpu.frontend.logmel import LogFilterBankFrontend as JaxFrontend
from convasr_tpu.models.zoo import create_model as jax_create_model
from convasr_tpu.train import loop as jax_loop
from convasr_tpu.train import optim as jax_optim
from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
from convasr_tpu_torch.models.convert import from_jax_params
from convasr_tpu_torch.models.zoo import create_model
from convasr_tpu_torch.train import loop, optim

SR, FEATURES, CLASSES = 8000, 16, 12
LR = 1e-2
# Parameters after two steps: the gradients agree to ~1e-5 relative (float32
# convolutions summed in another order), and NovoGrad divides each tensor's
# gradient by its own norm, so an update of size lr carries that relative
# error: lr 1e-2 gives differences of ~1e-7 and a bound of 2e-6.
PARAM_ATOL = 2e-6
# batch-norm running statistics: a mean over the batch, float32
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6


def make_batch(seed, B=3, T=4000, L=4):
    """Seeds are chosen so that no ReLU input lies within float32 rounding of
    0 (seed 5 has one at 4.4e-6 in block2, where the two frameworks' ReLUs
    may differ and the gradients of earlier layers with them)."""
    rng = np.random.RandomState(seed)
    x = (0.1 * rng.randn(B, T)).astype(np.float32)
    xlen = np.array([1.0, 0.8, 0.65][:B], np.float32)
    y = rng.randint(0, CLASSES - 1, size=(B, 1, L)).astype(np.int64)
    ylen = rng.randint(1, L + 1, size=(B, 1)).astype(np.int64)
    return dict(x=x, xlen=xlen, y=y, ylen=ylen)


def models(seed=0):
    jax_model = jax_create_model('JasperNetSmall', FEATURES, (CLASSES,), dropout=0.0,
                                 frontend=JaxFrontend(FEATURES, SR, 0.02, 0.01, dither=0.0),
                                 base_width=8)
    variables = jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, SR), jnp.float32),
                               xlen=jnp.ones((1,), jnp.float32))
    torch_model = create_model('JasperNetSmall', FEATURES, (CLASSES,), dropout=0.0,
                               frontend=LogFilterBankFrontend(FEATURES, SR, 0.02, 0.01,
                                                              dither=0.0), base_width=8)
    torch_model.load_state_dict(from_jax_params(variables['params'], variables['batch_stats']))
    return jax_model, variables, torch_model


def jax_run(jax_model, variables, tx, batches):
    step = jax.jit(jax_loop.make_train_step(jax_model, tx))
    state = jax_loop.TrainState(step=jnp.zeros([], jnp.int32), params=variables['params'],
                                batch_stats=variables['batch_stats'],
                                opt_state=tx.init(variables['params']))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def torch_run(torch_model, tx, batches):
    state = loop.init_train_state(torch_model, tx)
    step = loop.make_train_step(torch_model, tx)
    metrics = []
    for b in batches:
        m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                 torch.Generator().manual_seed(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def noise_bound(name):
    """The bias of a 1x1 residual conv feeds a batch norm, which subtracts it
    again: its gradient is float32 rounding noise on both sides, and NovoGrad
    scales each tensor's gradient to unit norm, so its updates are noise of
    size lr: two steps move it at most ~2 lr on each side. That batch norm's
    running mean takes in the bias with weight 0.1 (the momentum). Only these
    bounds hold for the two; None for every other entry."""
    if 'conv_residual' in name and name.endswith('.bias'):
        return 4 * LR
    if 'bn_residual' in name and name.endswith('running_mean'):
        return 0.4 * LR
    return None


def assert_same_weights(torch_model, jax_state, atol=PARAM_ATOL):
    ref = from_jax_params(jax_state.params, jax_state.batch_stats)
    sd = torch_model.state_dict()
    for name, value in ref.items():
        if name.endswith('num_batches_tracked'):
            continue
        if noise_bound(name) is not None:
            np.testing.assert_allclose(sd[name].numpy(), value.numpy(), rtol=0,
                                       atol=noise_bound(name), err_msg=name)
        elif 'running_' in name:
            np.testing.assert_allclose(sd[name].numpy(), value.numpy(), rtol=STAT_RTOL,
                                       atol=STAT_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(sd[name].numpy(), value.numpy(), rtol=0, atol=atol,
                                       err_msg=name)


def optimizers(accumulate=1, mask=None, torch_mask=None):
    """The CLI's optimizer: NovoGrad at lr 1e-2, weight decay 1e-3, global-norm
    clip at 100."""
    jax_tx = jax_loop.make_optimizer_with_accum(
        jax_optim.make_optimizer('NovoGrad', jax_optim.noop_lr(LR), weight_decay=1e-3),
        max_grad_norm=100.0, accumulate_steps=accumulate, trainable_mask=mask)
    torch_tx = loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', optim.noop_lr(LR), weight_decay=1e-3),
        max_grad_norm=100.0, accumulate_steps=accumulate, trainable_mask=torch_mask)
    return jax_tx, torch_tx


@pytest.mark.parametrize('accumulate', [1, 2], ids=['two_steps', 'accumulate_2'])
def test_train_steps_match_jax(accumulate):
    jax_model, variables, torch_model = models()
    batches = [make_batch(1), make_batch(2)]
    jax_tx, torch_tx = optimizers(accumulate)
    jax_state, jax_metrics = jax_run(jax_model, variables, jax_tx, batches)
    state, metrics = torch_run(torch_model, torch_tx, batches)
    assert state.step == 2
    for m, r in zip(metrics, jax_metrics):
        np.testing.assert_allclose(m['loss'], r['loss'], rtol=1e-4)
        np.testing.assert_allclose(m['grad_norm'], r['grad_norm'], rtol=1e-4)
        np.testing.assert_allclose(m['entropy'], r['entropy'], rtol=1e-4)
        assert m['finite'] == r['finite'] == 1.0
    assert_same_weights(torch_model, jax_state)


def test_nonfinite_step_keeps_everything():
    """One infeasible row (6 targets in 2 frames) makes the batch mean
    infinite: parameters, optimizer state and BN statistics stay, on both
    sides."""
    jax_model, variables, torch_model = models(seed=1)
    good, bad = make_batch(3), make_batch(4, T=4000, L=6)
    bad['xlen'][2] = 0.05
    bad['ylen'][2] = 6
    jax_tx, torch_tx = optimizers()
    jax_state, jax_metrics = jax_run(jax_model, variables, jax_tx, [good, bad])
    state = loop.init_train_state(torch_model, torch_tx)
    step = loop.make_train_step(torch_model, torch_tx)
    step(state, {k: torch.from_numpy(v) for k, v in good.items()})
    before = {k: v.clone() for k, v in torch_model.state_dict().items()}
    opt_before = optim.tree_select(torch.tensor(True), state.opt_state, state.opt_state)
    m = step(state, {k: torch.from_numpy(v) for k, v in bad.items()})
    assert float(m['finite']) == jax_metrics[1]['finite'] == 0.0
    assert not np.isfinite(float(m['loss']))
    for name, value in torch_model.state_dict().items():
        if not name.endswith('num_batches_tracked'):
            assert torch.equal(value, before[name]), name
    flat = lambda s: [t for t in jax.tree.leaves(s) if torch.is_tensor(t)]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(state.opt_state), flat(opt_before)))
    assert_same_weights(torch_model, jax_state)


def jax_mask_by_name(params, **kw):
    mask = jax_loop.freeze_mask(params, **kw)
    leaf = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
    return {'.'.join([k.key for k in p[:-1]] + [leaf[p[-1].key]]): v
            for p, v in jax.tree_util.tree_leaves_with_path(mask)}


@pytest.mark.parametrize('kw', [dict(freeze_backbone=2), dict(freeze_decoder0=True),
                                dict(freeze_backbone=1, freeze_decoder0=True)],
                         ids=['backbone2', 'decoder', 'both'])
def test_freeze_mask_matches_jax(kw):
    jax_model, variables, torch_model = models()
    ref = jax_mask_by_name(variables['params'], **kw)
    mask = loop.freeze_mask(torch_model, **kw)
    names = [n for n, _ in torch_model.named_parameters()]
    assert dict(zip(names, mask)) == ref
    jax_tx, torch_tx = optimizers(mask=jax_loop.freeze_mask(variables['params'], **kw),
                                  torch_mask=mask)
    before = {n: p.detach().clone() for n, p in torch_model.named_parameters()}
    jax_state, _ = jax_run(jax_model, variables, jax_tx, [make_batch(1)])
    torch_run(torch_model, torch_tx, [make_batch(1)])
    for (n, p), trainable in zip(torch_model.named_parameters(), mask):
        assert torch.equal(p, before[n]) != trainable, n
    assert_same_weights(torch_model, jax_state)


@pytest.mark.parametrize('bpe_only', [False, True])
def test_compute_losses_two_heads(bpe_only):
    rng = np.random.RandomState(6)
    B, T, L = 3, 20, 4
    lps = [np.array(jax.nn.log_softmax(jnp.asarray(rng.randn(B, T, c).astype(np.float32)), -1))
           for c in (7, 11)]
    y = rng.randint(0, 6, size=(B, 2, L)).astype(np.int64)
    ylen = np.array([[4, 3], [2, 2], [3, 4]], np.int64)
    olen = np.array([20, 15, 18], np.int32)
    ref = jax_loop.compute_losses(dict(log_probs=[jnp.asarray(a) for a in lps],
                                       olen=[jnp.asarray(olen)] * 2),
                                  jnp.asarray(y), jnp.asarray(ylen), bpe_only=bpe_only)
    ours = loop.compute_losses(dict(log_probs=[torch.from_numpy(a) for a in lps],
                                    olen=[torch.from_numpy(olen)] * 2),
                               torch.from_numpy(y), torch.from_numpy(ylen), bpe_only=bpe_only)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize('dtype', ['int16', 'uint8', 'float32'])
def test_undo_int16_transport(dtype):
    rng = np.random.RandomState(7)
    info = np.iinfo(dtype) if dtype != 'float32' else None
    x = (rng.randint(info.min, info.max + 1, size=(2, 300)) if info
         else rng.randn(2, 300)).astype(dtype)
    ref = np.asarray(jax_loop.undo_int16_transport(jnp.asarray(x)))
    ours = loop.undo_int16_transport(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_eval_step_and_metrics_match_jax():
    jax_model, variables, torch_model = models(seed=2)
    b = make_batch(8)
    outputs, metrics = jax.jit(jax_loop.make_eval_step(jax_model))(
        variables['params'], variables['batch_stats'], {k: jnp.asarray(v) for k, v in b.items()})
    ours_out, ours = loop.make_eval_step(torch_model)({k: torch.from_numpy(v)
                                                       for k, v in b.items()})
    for key in ('loss', 'entropy', 'uncertainty'):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(metrics[key]), rtol=1e-4,
                                   err_msg=key)
    lp = ours_out['log_probs'][0]
    np.testing.assert_allclose(loop.margin(lp).numpy(),
                               np.asarray(jax_loop.margin(outputs['log_probs'][0])), atol=1e-4)


def test_reset_bn_stats():
    _, variables, torch_model = models()
    loop.reset_bn_stats(torch_model)
    ref = jax_loop.reset_bn_stats(variables['batch_stats'])
    sd = from_jax_params(variables['params'], ref)
    for name, value in torch_model.state_dict().items():
        if 'running_' in name:
            assert torch.equal(value, sd[name]), name
