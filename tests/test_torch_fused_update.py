"""The fused NovoGrad route of the train step on the CPU (its kernels run on
the card only: tests/test_torch_cuda.py): which optimizers carry it, that the
CPU keeps the chain and matches it bit for bit through the same entry, and
the arithmetic the wrapper does around the kernels."""
import numpy as np
import pytest
import torch

from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
from convasr_tpu_torch.models.zoo import create_model
from convasr_tpu_torch.ops import novograd_update
from convasr_tpu_torch.train import loop, optim

LR = optim.noop_lr(1e-2)

# optimizer -> the clip's norm its fused update carries (None: no fused update)
ROUTES = dict(
    novograd=(lambda: optim.make_optimizer('NovoGrad', LR), 0.0),
    fused_novograd_name=(lambda: optim.make_optimizer('FusedNovoGrad', LR), 0.0),
    novograd_with_accum=(lambda: loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', LR)), 0.0),
    novograd_clip=(lambda: loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', LR), max_grad_norm=100.0), 100.0),
    novograd_schedule_clip=(lambda: loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', optim.multistep_lr(1e-2, 0.1, [5])),
        max_grad_norm=1.0), 1.0),
    novograd_mask=(lambda: loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', LR), trainable_mask=[True, False]), None),
    novograd_accumulate=(lambda: loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', LR), accumulate_steps=2), None),
    novograd_clip_accumulate=(lambda: loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', LR), max_grad_norm=1.0, accumulate_steps=2), None),
    novograd_chain=(lambda: optim.novograd(LR), None),
    larc_novograd=(lambda: optim.chain(optim.larc(LR), optim.make_optimizer('NovoGrad', LR)),
                   None),
    sgd=(lambda: loop.make_optimizer_with_accum(optim.make_optimizer('SGD', LR),
                                                max_grad_norm=1.0), None),
    adamw=(lambda: loop.make_optimizer_with_accum(optim.make_optimizer('AdamW', LR)), None),
)


@pytest.mark.parametrize('case', ROUTES)
def test_which_optimizers_carry_the_fused_update(case):
    make, max_norm = ROUTES[case]
    tx = make()
    if max_norm is None:
        assert tx.fused is None
    else:
        assert isinstance(tx.fused, optim.FusedNovoGrad) and tx.fused.max_norm == max_norm


@pytest.mark.parametrize('max_norm', [0.0, 3.0], ids=['no_clip', 'clip'])
def test_fused_update_finds_the_chains_state(max_norm):
    """The state keeps the chain's tree; `parts` finds NovoGrad's and the
    schedule's in it by their keys, behind the clip or not; a step on the
    CPU's tensors raises, naming the CUDA device the kernels run on."""
    params = [torch.zeros(3, 2), torch.zeros(4)]
    tx = loop.make_optimizer_with_accum(optim.make_optimizer('NovoGrad', LR),
                                        max_grad_norm=max_norm)
    state = tx.init(params)
    assert optim._same_tree(state, tx._replace(fused=None).init(params))
    nv, schedule = tx.fused.parts(state)
    assert set(nv) == {'step', 'grads_ema', 'momentum'} and set(schedule) == {'count'}
    assert nv['grads_ema'].shape == (2,) and [m.shape for m in nv['momentum']] == \
        [p.shape for p in params]
    scratch = novograd_update.Scratch([p.numel() for p in params], 'cpu')
    with pytest.raises(ValueError, match='CUDA device'):
        tx.fused.step([torch.ones_like(p) for p in params], state, params, torch.tensor(True),
                      scratch)


@pytest.mark.parametrize('name', ['SGD', 'AdamW'])
def test_fused_update_refuses_a_state_without_novograd(name):
    params = [torch.zeros(3, 2)]
    state = optim.make_optimizer(name, LR).init(params)
    with pytest.raises(ValueError, match='no NovoGrad'):
        optim.FusedNovoGrad(LR, (0.9, 0.999), 1e-8, 0.0).parts(state)


def test_holding_finds_a_key_depth_first():
    state = [{}, [dict(step=1, grads_ema=2), dict(count=3)], dict(count=4)]
    assert optim.holding(state, 'grads_ema') is state[1][0]
    assert optim.holding(state, 'count') is state[1][1]
    assert optim.holding(state, 'mu') is None


@pytest.mark.parametrize('case', ['cpu_device', 'too_many_leaves'])
def test_kernels_take_only_float32_cuda_tensors(case):
    """The launch's table raises ValueError for what the kernels cannot take:
    a device other than CUDA, more leaves than the table holds (the
    tensors' own dtype, layout and device are refused on the card:
    tests/test_torch_cuda.py)."""
    if case == 'cpu_device':
        tensors, device, match = [torch.zeros(4)], torch.device('cpu'), 'CUDA device'
    else:
        tensors = [torch.zeros(1)] * (novograd_update.MAX_LEAVES + 1)
        device, match = torch.device('cuda', 0), 'more than'
    with pytest.raises(ValueError, match=match):
        novograd_update.table(tensors, device, 'the leaves')


def test_the_leaf_table_and_blocks():
    """A block takes CHUNK elements of one leaf, 16-byte aligned where its
    leaf is; the table of MAX_LEAVES leaves (three addresses, a size and a
    first block each) fits the kernel parameter space of 32,764 bytes."""
    chunk, most = novograd_update.CHUNK, novograd_update.MAX_LEAVES
    assert chunk % 4 == 0
    assert 3 * 8 * most + 4 * most + 4 * (most + 1) + 4 + 128 <= 32764
    assert novograd_update.chunks([chunk, 1, chunk + 1, 0]) == 4
    scratch = novograd_update.Scratch([chunk, 1, chunk + 1], 'cpu')
    assert scratch.blocks == 4 and scratch.partial.numel() == 4
    assert scratch.denom.numel() == 3 and scratch.clip.numel() == 2
    assert scratch.counters.tolist() == [0, 0]


def _model():
    torch.manual_seed(0)
    return create_model('JasperNetSmall', 16, (38,), dropout=0.0, base_width=8,
                        frontend=LogFilterBankFrontend(16, 8000, 0.02, 0.01, dither=0.0))


def _batch(seed, infeasible=False):
    rng = np.random.RandomState(seed)
    batch = dict(x=torch.from_numpy((0.1 * rng.randn(2, 8000)).astype(np.float32)),
                 xlen=torch.ones(2), y=torch.from_numpy(rng.randint(0, 37, (2, 1, 10))),
                 ylen=torch.full((2, 1), 10))
    if infeasible:   # 10 labels in a frame or two: an infinite loss
        batch['xlen'][1] = 0.01
    return batch


@pytest.mark.parametrize('schedule,max_norm', [(LR, 0.0), (LR, 1.0),
                                               (optim.multistep_lr(1e-2, 0.5, [1]), 1.0)],
                         ids=['no_clip', 'clip', 'schedule_clip'])
def test_cpu_step_through_the_fused_entry_is_the_chain(schedule, max_norm):
    """On the CPU the train step of an optimizer that carries the fused
    update runs the chain: three steps (the second's loss not finite) equal
    those of the same optimizer without it, bit for bit."""
    tx = loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', schedule, weight_decay=1e-3), max_grad_norm=max_norm)
    runs = []
    for t in (tx, tx._replace(fused=None)):
        model = _model()
        state, step = loop.init_train_state(model, t), loop.make_train_step(model, t)
        metrics = [step(state, _batch(k, infeasible=k == 1)) for k in range(3)]
        runs.append((model.state_dict(), state, metrics))
    (sd, state, metrics), (chain_sd, chain_state, chain_metrics) = runs
    assert float(metrics[1]['finite']) == 0.0 and float(metrics[1]['grad_norm']) == 0.0
    assert all(torch.equal(sd[k], chain_sd[k]) for k in sd)
    flat = lambda s: [t for t in torch.utils._pytree.tree_leaves(s)]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(state.opt_state),
                                                 flat(chain_state.opt_state)))
    for m, c in zip(metrics, chain_metrics):
        assert all(torch.equal(m[k], c[k]) for k in m)
