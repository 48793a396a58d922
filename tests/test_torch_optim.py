"""The port's optimizers and schedules against the JAX package's
train/optim.py (optax underneath): identical numpy parameters and gradient
streams, a few steps, float32."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from convasr_tpu.train import optim as jax_optim
from convasr_tpu_torch.train import optim

# float32 rounding of a few steps; the per-tensor sums of squares are taken
# in another order (torch._foreach_norm) than optax's
RTOL, ATOL = 1e-6, 1e-7


def streams(seed=0, steps=4):
    rng = np.random.RandomState(seed)
    params = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in params] for _ in range(steps)]
    return params, grads


def run_both(jax_tx, torch_tx, seed=0, steps=4):
    params, grads = streams(seed, steps)
    jp = dict(a=jnp.asarray(params[0]), b=jnp.asarray(params[1]))
    js = jax_tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = torch_tx.init(tp)
    for g in grads:
        upd, js = jax_tx.update(dict(a=jnp.asarray(g[0]), b=jnp.asarray(g[1])), js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = torch_tx.update([torch.from_numpy(x) for x in g], ts, tp)
        optim.apply_updates(tp, tu)
        for t, j in zip(tp, (jp['a'], jp['b'])):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    return tp, ts


SCHEDULE = lambda step: 0.1  # noqa: E731

CASES = dict(
    novograd=lambda: (jax_optim.novograd(SCHEDULE), optim.novograd(SCHEDULE)),
    novograd_weight_decay=lambda: (jax_optim.novograd(SCHEDULE, weight_decay=1e-3),
                                   optim.novograd(SCHEDULE, weight_decay=1e-3)),
    novograd_dampening=lambda: (jax_optim.novograd(SCHEDULE, dampening=True),
                                optim.novograd(SCHEDULE, dampening=True)),
    novograd_cli=lambda: (jax_optim.make_optimizer('NovoGrad', 1e-2, weight_decay=1e-3),
                          optim.make_optimizer('NovoGrad', 1e-2, weight_decay=1e-3)),
    sgd_momentum=lambda: (jax_optim.make_optimizer('SGD', 1e-2, momentum=0.5, weight_decay=1e-3),
                          optim.make_optimizer('SGD', 1e-2, momentum=0.5, weight_decay=1e-3)),
    sgd_nesterov=lambda: (jax_optim.make_optimizer('SGD', 1e-2, momentum=0.9, nesterov=True),
                          optim.make_optimizer('SGD', 1e-2, momentum=0.9, nesterov=True)),
    adamw=lambda: (jax_optim.make_optimizer('AdamW', 1e-2, weight_decay=1e-2),
                   optim.make_optimizer('AdamW', 1e-2, weight_decay=1e-2)),
    larc_clip_sgd=lambda: (optax.chain(jax_optim.larc(0.1), jax_optim.make_optimizer('SGD', 0.1)),
                           optim.chain(optim.larc(0.1), optim.make_optimizer('SGD', 0.1))),
    larc_scale_sgd=lambda: (
        optax.chain(jax_optim.larc(0.1, mode='scale'), jax_optim.make_optimizer('SGD', 0.1)),
        optim.chain(optim.larc(0.1, mode='scale'), optim.make_optimizer('SGD', 0.1))),
    clip_then_novograd=lambda: (
        optax.chain(optax.clip_by_global_norm(1.5), jax_optim.novograd(SCHEDULE)),
        optim.chain(optim.clip_by_global_norm(1.5), optim.novograd(SCHEDULE))),
    multistep_schedule_novograd=lambda: (
        jax_optim.make_optimizer('NovoGrad', jax_optim.multistep_lr(0.1, 0.5, [1, 3])),
        optim.make_optimizer('NovoGrad', optim.multistep_lr(0.1, 0.5, [1, 3]))),
    polynomial_schedule_sgd=lambda: (
        jax_optim.make_optimizer('SGD', jax_optim.polynomial_decay_lr(
            0.1, 5, power=2.0, begin_decay_at=2, warmup_steps=2)),
        optim.make_optimizer('SGD', optim.polynomial_decay_lr(
            0.1, 5, power=2.0, begin_decay_at=2, warmup_steps=2))),
)


@pytest.mark.parametrize('case', CASES)
def test_optimizer_matches_jax(case):
    jax_tx, torch_tx = CASES[case]()
    run_both(jax_tx, torch_tx, seed=len(case))


@pytest.mark.parametrize('every_k', [1, 2, 3])
def test_multi_steps_matches_optax(every_k):
    jax_tx = optax.MultiSteps(jax_optim.novograd(SCHEDULE), every_k_schedule=every_k)
    torch_tx = optim.multi_steps(optim.novograd(SCHEDULE), every_k)
    _, state = run_both(jax_tx, torch_tx, steps=6)
    assert int(state['gradient_step']) == 6 // every_k


def test_masked_and_set_to_zero():
    mask = {'a': True, 'b': False}
    jax_tx = optax.chain(optax.masked(jax_optim.novograd(SCHEDULE), mask),
                         optax.masked(optax.set_to_zero(), {'a': False, 'b': True}))
    torch_tx = optim.chain(optim.masked(optim.novograd(SCHEDULE), [True, False]),
                           optim.masked(optim.set_to_zero(), [False, True]))
    params, _ = streams()
    tp, _ = run_both(jax_tx, torch_tx)
    np.testing.assert_array_equal(tp[1].numpy(), params[1])


@pytest.mark.parametrize('name,make', [
    ('noop', lambda m: m.noop_lr(0.3)),
    ('multistep', lambda m: m.multistep_lr(1.0, 0.1, [10, 20])),
    ('polynomial', lambda m: m.polynomial_decay_lr(1.0, 100, warmup_steps=10, begin_decay_at=10)),
    ('polynomial_power2', lambda m: m.polynomial_decay_lr(0.5, 40, power=2.0, end_lr=0.01)),
])
def test_schedules_match_jax(name, make):
    jax_fn, torch_fn = make(jax_optim), make(optim)
    for step in [0, 1, 5, 9, 10, 11, 15, 20, 25, 39, 60, 110]:
        np.testing.assert_allclose(float(torch_fn(torch.tensor(step, dtype=torch.int32))),
                                   float(jax_fn(jnp.int32(step))), rtol=1e-6, err_msg=str(step))


def test_select_keeps_old_state():
    tx = optim.novograd(SCHEDULE)
    params, grads = streams()
    tp = [torch.from_numpy(p) for p in params]
    state = tx.init(tp)
    _, new = tx.update([torch.from_numpy(g) for g in grads[0]], state, tp)
    kept = optim.tree_select(torch.tensor(False), new, state)
    assert int(kept[0]['step']) == 0 and all((m == 0).all() for m in kept[0]['momentum'])
    taken = optim.tree_select(torch.tensor(True), new, state)
    assert int(taken[0]['step']) == 1
