"""The port's tensor-parallel layout on the CPU (spec: convasr_tpu/parallel/
mesh.state_shardings, tests/test_train_integration.py's TestTensorParallel
and test_batchnorm_stats_are_global): the layout leaf by leaf against the
JAX function's, a sharded train step of Gloo processes against the JAX
package's jitted single-device step, checkpoints across the two layouts, the
sharded cache gather on a data x model grid, and the parts the layout does
not cover.

Every process group meets through a file:// rendezvous in the test's own
directory, has a 60 s timeout, and every process is joined with a bound.
Processes run one torch thread each.
"""
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 60
TINY = dict(num_input_features=8, num_classes=(6,), repeat=1, num_subblocks=1, residual='dense',
            kernel_sizes=(3,), kernel_size_prologue=3, kernel_size_epilogue=3, base_width=4,
            out_width_factors=(2,), out_width_factors_large=(3, 3), dropout=0.0,
            temporal_mask=False, stride1=2)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_port_model():
    """tests/test_train_integration.tiny_model in the port."""
    from convasr_tpu_torch.models.jasper import JasperNet
    return JasperNet(**TINY)


def dropout_model(state_dict):
    """The tiny model with dropout 0.3 in every block."""
    from convasr_tpu_torch.models.jasper import JasperNet
    model = JasperNet(**dict(TINY, dropout=0.3, dropout_prologue=0.3, dropout_epilogue=0.3,
                             dropouts=(0.3,)))
    model.load_state_dict(state_dict)
    return model


def port_optimizer(spec):
    from convasr_tpu_torch.train import loop, optim
    name, clip = spec
    base = optim.make_optimizer('sgd', lambda s: 1e-2) if name == 'sgd' else \
        optim.make_optimizer('novograd', lambda s: 1e-2, betas=(0.95, 0.98), weight_decay=1e-3)
    return loop.make_optimizer_with_accum(base, max_grad_norm=clip)


def jax_optimizer(spec):
    from convasr_tpu.train.loop import make_optimizer_with_accum
    from convasr_tpu.train.optim import make_optimizer
    name, clip = spec
    base = make_optimizer('sgd', lambda s: 1e-2) if name == 'sgd' else \
        make_optimizer('novograd', lambda s: 1e-2, betas=(0.95, 0.98), weight_decay=1e-3)
    return make_optimizer_with_accum(base, max_grad_norm=clip)


def jax_steps(spec, batches):
    """The JAX package's jitted single-device steps from PRNGKey(0)'s
    weights: (initial port state_dict, per-step metrics, final port
    state_dict)."""
    import jax
    from test_train_integration import tiny_model
    from convasr_tpu.train.loop import init_train_state, make_train_step
    from convasr_tpu_torch.models.convert import from_jax_params
    model, tx = tiny_model(), jax_optimizer(spec)
    state = init_train_state(model, tx, batches[0], jax.random.PRNGKey(0))
    first = from_jax_params(state.params, state.batch_stats)
    step = jax.jit(make_train_step(model, tx))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, b, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return first, metrics, from_jax_params(state.params, state.batch_stats)


def _bucket():
    rng = np.random.RandomState(5)
    return dict(x=rng.randint(-32768, 32767, size=(7, 384)).astype(np.int16),
                xlen=rng.rand(7).astype(np.float32),
                y=rng.randint(0, 30, size=(7, 1, 16)).astype(np.int32),
                ylen=rng.randint(1, 16, size=(7, 1)).astype(np.int32))


def _tp_rank(rank, world, n_model, rdv, inputs_path, out_path):
    """One rank of a data x model grid: the tiny model from the JAX weights,
    sharded at min_channels 8, its steps on this data index's rows; then a
    sharded checkpoint written, a one-process checkpoint loaded, and the
    sharded cache gather. The results go to out_path for the parent."""
    torch.set_num_threads(1)
    from convasr_tpu_torch.data.device_cache import DeviceDatasetCache, sharded_gather
    from convasr_tpu_torch.parallel import mesh, tensor_parallel
    from convasr_tpu_torch.train import checkpoints, loop
    inputs = torch.load(inputs_path, weights_only=False)
    mesh.init_distributed(rdv, world, rank, timeout=TIMEOUT)
    grid = mesh.make_groups(n_model)

    def sharded_model():
        model = tiny_port_model()
        model.load_state_dict(inputs['state_dict'])
        layout = tensor_parallel.state_shardings(model, n_model, min_channels=8)
        return tensor_parallel.shard_model_(model, layout, grid)

    model = sharded_model()
    tx = port_optimizer(inputs['optimizer'])
    state = loop.init_train_state(model, tx)
    step = loop.make_train_step(model, tx)
    per = inputs['batches'][0]['x'].shape[0] // grid.n_data
    rows = mesh.process_local_batch_slice(per * grid.n_data)
    out = dict(grid=tuple(grid[:4]), metrics=[])
    for b in inputs['batches']:
        m = step(state, {k: torch.from_numpy(v[rows]) for k, v in b.items()})
        out['metrics'].append({k: float(v) for k, v in m.items()})
    params = list(model.parameters())
    out['local'] = {k: v.clone() for k, v in model.state_dict().items()}
    out['gathered'] = tensor_parallel.gather_state(model)
    out['gathered_opt'] = tensor_parallel.gather_opt_state(state.opt_state, params)
    checkpoints.save_train_checkpoint(inputs['save'], model, state)
    # a one-process checkpoint into a fresh sharded model and optimizer state
    loaded = sharded_model()
    loaded_state = loop.init_train_state(loaded, tx)
    checkpoints.restore_train_state_(loaded, checkpoints.load_train_checkpoint(inputs['load']),
                                     loaded_state)
    out['loaded'] = {k: v.clone() for k, v in loaded.state_dict().items()}
    out['loaded_opt'] = loaded_state.opt_state
    # dropout: each rank draws the whole tensor's masks from a generator
    # every model rank shares and keeps its channels
    drop = dropout_model(inputs['state_dict'])
    drop = tensor_parallel.shard_model_(drop, tensor_parallel.state_shardings(
        drop, n_model, min_channels=8), grid)
    assert tensor_parallel.is_sharded(drop)
    x = torch.from_numpy(inputs['batches'][0]['x'][rows])
    out['dropout_lp'] = drop.train()(x, xlen=torch.ones(x.shape[0]), generator=torch.Generator()
                                     .manual_seed(0))['log_probs'][0].detach()
    # the sharded cache over the data indices
    cache = DeviceDatasetCache({0: _bucket()}, None, None, 0)
    cache.upload_sharded(grid.data_index, grid.n_data, 'cpu')
    want = torch.tensor([6, 1, 3, 4], dtype=torch.int64)
    take = want[grid.data_index * 2:(grid.data_index + 1) * 2]
    out['cache_rows'] = take
    out['cache'] = sharded_gather(cache.device[0], take, grid.data_index, grid.n_data, grid.data)
    torch.save(out, out_path)
    mesh.shutdown(wait=True)


def spawn_grid(tmp, world, n_model, inputs):
    torch.save(inputs, tmp / 'inputs.pt')
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_tp_rank, args=(r, world, n_model, f'file://{tmp}/rdv',
                                                 str(tmp / 'inputs.pt'), str(tmp / f'r{r}.pt')))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(tmp / f'r{r}.pt', weights_only=False) for r in range(world)]


def synth_batches(seed, n, B=4):
    from test_train_integration import synth_batch
    rng = np.random.RandomState(seed)
    return [synth_batch(rng, B=B) for _ in range(n)]


def one_process_checkpoint(path, state_dict, spec, batch):
    """A one-process run's training checkpoint after one step (the optimizer
    state no longer zero)."""
    from convasr_tpu_torch.train import checkpoints, loop
    model = tiny_port_model()
    model.load_state_dict(state_dict)
    tx = port_optimizer(spec)
    state = loop.init_train_state(model, tx)
    loop.make_train_step(model, tx)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    checkpoints.save_train_checkpoint(str(path), model, state)
    return checkpoints.load_train_checkpoint(str(path))


def run_grid(tmp, world, n_model, spec, batches):
    first, jax_metrics, jax_final = jax_steps(spec, batches)
    host = [{k: np.array(v) for k, v in b.items()} for b in batches]
    full = one_process_checkpoint(tmp / 'one.pt', first, spec, host[0])
    ranks = spawn_grid(tmp, world, n_model, dict(
        state_dict=first, batches=host, optimizer=spec, save=str(tmp / 'tp.pt'),
        load=str(tmp / 'one.pt')))
    return dict(ranks=ranks, jax_metrics=jax_metrics, jax_final=jax_final, full=full, first=first,
                saved=torch.load(tmp / 'tp.pt', weights_only=False), layout=layout_of(first))


def layout_of(state_dict):
    from convasr_tpu_torch.parallel import tensor_parallel
    model = tiny_port_model()
    model.load_state_dict(state_dict)
    return tensor_parallel.state_shardings(model, 2, min_channels=8)


@pytest.fixture(scope='module')
def one_by_two(tmp_path_factory):
    """TestTensorParallel's spec at 1 data x 2 model processes: the tiny
    model, B 4, SGD lr 1e-2, one step."""
    return run_grid(tmp_path_factory.mktemp('tp12'), 2, 2, ('sgd', 0.0), synth_batches(7, 1))


@pytest.fixture(scope='module')
def two_by_two(tmp_path_factory):
    """2 data x 2 model processes, NovoGrad with a global-norm clip at a
    quarter of the first step's gradient norm, two steps: a miss of the
    model group in any norm moves the second step."""
    import jax
    from test_train_integration import tiny_model
    from convasr_tpu.train.loop import init_train_state
    from convasr_tpu_torch.models.convert import from_jax_params
    from convasr_tpu_torch.train import loop
    batches = synth_batches(11, 2)
    state = init_train_state(tiny_model(), jax_optimizer(('novograd', 0.0)), batches[0],
                             jax.random.PRNGKey(0))
    model = tiny_port_model()
    model.load_state_dict(from_jax_params(state.params, state.batch_stats))
    tx = port_optimizer(('novograd', 0.0))
    m = loop.make_train_step(model, tx)(loop.init_train_state(model, tx), {
        k: torch.from_numpy(np.array(v)) for k, v in batches[0].items()})
    clip = float(m['grad_norm']) / 4
    out = run_grid(tmp_path_factory.mktemp('tp22'), 4, 2, ('novograd', clip), batches)
    out['clip'] = clip
    return out


def slices(t, n, dim=0):
    return list(torch.chunk(t, n, dim=dim))


def assert_params_close(gathered, want, rtol, atol, stats=False):
    for k, v in want.items():
        if k.endswith('num_batches_tracked') or k.endswith(('running_mean', 'running_var')) != stats:
            continue
        np.testing.assert_allclose(gathered[k].numpy(), v.numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


# ------------------------------------------------------------------- the layout

@pytest.mark.parametrize('which', ['tiny', 'jasper_big16'])
def test_layout_matches_jax_state_shardings(which):
    """The port's state_shardings shards exactly the leaves that the JAX
    function shards on the same model, compared through from_jax_params'
    names: the flax kernel's trailing dim is the torch conv weight's dim 0."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from test_train_integration import synth_batch, tiny_model
    from convasr_tpu.frontend.logmel import LogFilterBankFrontend as JaxFrontend
    from convasr_tpu.models.zoo import create_model as jax_create_model
    from convasr_tpu.parallel.mesh import make_mesh, state_shardings as jax_state_shardings
    from convasr_tpu.train.loop import init_train_state
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.convert import from_jax_params
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.parallel import tensor_parallel
    if which == 'tiny':
        jmodel, port, min_channels = tiny_model(), tiny_port_model(), 8
        batch = synth_batch(np.random.RandomState(0), B=2)
    else:
        jmodel = jax_create_model('JasperNetBig', 64, (38,), base_width=16, dtype=jnp.float32,
                                  frontend=JaxFrontend(64, 8000, 0.02, 0.01, dither=0.0))
        port = create_model('JasperNetBig', 64, (38,), base_width=16,
                            frontend=LogFilterBankFrontend(64, 8000, 0.02, 0.01, dither=0.0))
        min_channels = 32
        batch = dict(x=jnp.zeros((2, 2048), jnp.float32), xlen=jnp.ones((2,), jnp.float32),
                     y=jnp.zeros((2, 1, 8), jnp.int32), ylen=jnp.full((2, 1), 8, jnp.int32))
    tx = jax_optimizer(('novograd', 100.0))
    shapes = jax.eval_shape(lambda: init_train_state(jmodel, tx, batch, jax.random.PRNGKey(0)))
    ss = jax_state_shardings(make_mesh(n_data=4, n_model=2), shapes, min_channels=min_channels)

    def flags(tree, shape_tree):
        return jax.tree.map(lambda s, a: np.full(a.shape, float(s.spec != P()), np.float32),
                            tree, shape_tree)
    want = from_jax_params(flags(ss.params, shapes.params),
                           flags(ss.batch_stats, shapes.batch_stats))
    want = {k: bool(v.reshape(-1)[0]) for k, v in want.items() if v.ndim}
    got = tensor_parallel.state_shardings(port, 2, min_channels=min_channels)
    assert {k: got[k] is not None for k in want} == want
    # the tiny model's 6-class head is replicated; at base 16 every leaf is
    # at least 32 wide, the 38-class head too
    assert sum(want.values()) > 0 and all(want.values()) == (which != 'tiny')
    # the leaves with no flax counterpart are replicated; every sharded one
    # along its flax trailing dim
    assert all(got[k] is None for k in got if k not in want)
    assert all(got[k] == 0 for k, v in want.items() if v)
    # JAX's optimizer state follows its parameters: NovoGrad's momentum is
    # sharded with them, its per-leaf EMA scalars replicated
    [novograd] = [s for s in jax.tree.leaves(ss.opt_state, is_leaf=lambda n: hasattr(
        n, 'momentum')) if hasattr(s, 'momentum')]
    assert all(jax.tree.leaves(jax.tree.map(lambda a, b: a.spec == b.spec, novograd.momentum,
                                            ss.params)))
    assert all(s.spec == P() for s in jax.tree.leaves(novograd.grads_ema))


# ------------------------------------------------------------- the train step

def test_one_by_two_step_matches_jax(one_by_two):
    """The loss within rtol 1e-5 of the JAX single-device step's on every
    rank; the gathered parameters after the step within rtol 1e-4 / atol
    1e-5."""
    out = one_by_two
    for r in out['ranks']:
        assert r['grid'] == (1, 2, 0, r['grid'][3])
        np.testing.assert_allclose(r['metrics'][0]['loss'], out['jax_metrics'][0]['loss'],
                                   rtol=1e-5)
        assert_params_close(r['gathered'], out['jax_final'], rtol=1e-4, atol=1e-5)
    assert [r['grid'][3] for r in out['ranks']] == [0, 1]


def test_one_by_two_dropout_masks_equal_one_process(one_by_two):
    """Dropout under the layout: every rank's log-probs (gathered head input,
    each block's masks drawn whole from the shared generator) equal one
    process's with the same generator state."""
    from test_train_integration import synth_batch
    batch = synth_batch(np.random.RandomState(7), B=4)
    model = dropout_model(one_by_two['first'])
    x = torch.from_numpy(np.array(batch['x']))
    want = model.train()(x, xlen=torch.ones(4), generator=torch.Generator().manual_seed(0))[
        'log_probs'][0].detach()
    without = model(x, xlen=torch.ones(4))['log_probs'][0].detach()
    assert not torch.allclose(without, want, atol=1e-3)      # the masks bite
    for r in one_by_two['ranks']:
        np.testing.assert_allclose(r['dropout_lp'].numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_one_by_two_ranks_hold_their_slices(one_by_two):
    """Each rank holds its model index's rows of every sharded leaf, and the
    same whole tensor of every replicated one."""
    out = one_by_two
    sharded = [k for k, d in out['layout'].items() if d is not None]
    assert sharded and 'decoder.head0.weight' not in sharded
    for r in out['ranks']:
        m = r['grid'][3]
        for k, v in r['gathered'].items():
            want = slices(v, 2)[m] if out['layout'][k] is not None else v
            assert torch.equal(r['local'][k], want), k


@pytest.mark.parametrize('step', [0, 1])
def test_two_by_two_novograd_clip_matches_jax(two_by_two, step):
    """2 x 2, NovoGrad with the clip biting at each step: the loss and the
    global gradient norm within rtol 1e-5 of JAX's single-device steps."""
    out = two_by_two
    assert out['jax_metrics'][step]['grad_norm'] > out['clip']      # the clip bites
    for r in out['ranks']:
        m = r['metrics'][step]
        np.testing.assert_allclose(m['loss'], out['jax_metrics'][step]['loss'], rtol=1e-5)
        np.testing.assert_allclose(m['grad_norm'], out['jax_metrics'][step]['grad_norm'],
                                   rtol=1e-5)
        assert m['grad_norm'] > out['clip']
    assert sorted(r['grid'] for r in out['ranks']) == [(2, 2, d, m) for d in (0, 1)
                                                       for m in (0, 1)]


def test_two_by_two_parameters_match_jax(two_by_two):
    out = two_by_two
    for r in out['ranks']:
        assert_params_close(r['gathered'], out['jax_final'], rtol=1e-4, atol=1e-5)


def test_two_by_two_batchnorm_stats_are_global(two_by_two):
    """The running statistics of a 2 x 2 run equal the single-device ones
    (rtol 1e-4 / atol 1e-6): each is over the data group's rows."""
    out = two_by_two
    for r in out['ranks']:
        assert_params_close(r['gathered'], out['jax_final'], rtol=1e-4, atol=1e-6, stats=True)


# ---------------------------------------------------------------- checkpoints

def test_sharded_checkpoint_is_the_whole_state(one_by_two, two_by_two):
    """A sharded run's checkpoint, loaded in one process, equals gather_state
    bit for bit, its optimizer state gathered likewise; it loads into the
    one-process model."""
    for out in (one_by_two, two_by_two):
        saved = out['saved']
        for r in out['ranks']:
            assert saved['model_state_dict'].keys() == r['gathered'].keys()
            for k, v in r['gathered'].items():
                assert torch.equal(saved['model_state_dict'][k], v), k
            for a, b in zip(flat(saved['opt_state']), flat(r['gathered_opt'])):
                assert torch.equal(a, b)
        tiny_port_model().load_state_dict(saved['model_state_dict'])
        assert [list(t.shape) for t in flat(saved['opt_state'])] == \
            [list(t.shape) for t in flat(out['full']['opt_state'])]


def test_one_process_checkpoint_loads_as_slices(one_by_two, two_by_two):
    """A one-process checkpoint loaded under the grid gives each rank its
    exact slice of every sharded leaf and of its optimizer state."""
    for out in (one_by_two, two_by_two):
        full = out['full']
        params = dict(tiny_port_model().named_parameters())
        for r in out['ranks']:
            m = r['grid'][3]
            for k, v in full['model_state_dict'].items():
                want = slices(v, 2)[m] if out['layout'][k] is not None else v
                assert torch.equal(r['loaded'][k], want), k
            shapes = {tuple(slices(p, 2)[m].shape) if out['layout'][k] is not None
                      else tuple(p.shape) for k, p in params.items()}
            got, whole = flat(r['loaded_opt']), flat(full['opt_state'])
            assert len(got) == len(whole)
            for a, b in zip(got, whole):
                assert torch.equal(a, b) or (tuple(a.shape) in shapes and
                                             torch.equal(a, slices(b, 2)[m])), \
                    (a.shape, b.shape)


def flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flat(v)]
    return [tree] if torch.is_tensor(tree) else []


def test_sharded_gather_by_data_index(two_by_two):
    """The sharded cache under 2 x 2: rows shard over the data indices, both
    model ranks of a data index take the same rows, bit-equal to the
    unsharded gather."""
    from convasr_tpu_torch.data.device_cache import gather_batch
    cache = {k: torch.from_numpy(v) for k, v in _bucket().items()}
    by_data = {}
    for r in two_by_two['ranks']:
        want = gather_batch(cache, r['cache_rows'])
        for k in want:
            assert r['cache'][k].dtype == want[k].dtype and torch.equal(r['cache'][k], want[k]), k
        by_data.setdefault(r['grid'][2], []).append(r['cache'])
    for pair in by_data.values():
        assert all(torch.equal(pair[0][k], pair[1][k]) for k in pair[0])


# -------------------------------------------------------- what it does not cover

def _unsupported(kind):
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.frontend.wav2vec import Wav2VecFrontend
    from convasr_tpu_torch.models.jasper import JasperNet
    from convasr_tpu_torch.models.zoo import create_model
    small = dict(TINY, base_width=8)
    if kind == 'wav2vec':
        return create_model('JasperNetSmall', 512, (38,), base_width=8,
                            frontend=Wav2VecFrontend(512, 8000)), 256, 'frontend.'
    if kind == 'bpe':
        return JasperNet(**dict(small, num_classes=(6, 40), decoder_type='bpe')), 8, \
            'decoder.bpe_conv0.'
    if kind == 'separable':
        return JasperNet(**dict(small, separable=True, groups=4)), 8, 'block1.conv0.depthwise.'
    if kind == 'grouped':
        return JasperNet(**dict(small, groups=2)), 8, 'block1.conv0.conv.weight'
    return JasperNet(**dict(small, remat=True, frontend=LogFilterBankFrontend(
        8, 8000, 0.02, 0.01, dither=0.0))), 8, 'block0.conv0.conv.weight'


@pytest.mark.parametrize('kind', ['wav2vec', 'bpe', 'separable', 'grouped', 'remat'])
def test_unsupported_leaves_raise(kind):
    """A leaf the JAX rule shards in a part the sharded forward does not
    cover raises a ValueError that names it; none is replicated quietly."""
    from convasr_tpu_torch.parallel import tensor_parallel
    model, min_channels, leaf = _unsupported(kind)
    with pytest.raises(ValueError, match='^' + leaf.replace('.', r'\.')):
        tensor_parallel.state_shardings(model, 2, min_channels=min_channels)
    # at n_model 1 everything is replicated, as in the JAX package
    assert not any(tensor_parallel.state_shardings(model, 1, min_channels=min_channels).values())


def test_make_groups_needs_n_model_to_divide_the_world():
    from convasr_tpu_torch.parallel import mesh
    with pytest.raises(ValueError, match='does not divide the world size 1'):
        mesh.make_groups(2)
    assert mesh.make_groups(1) == mesh.Grid(1, 1, 0, 0, None, None)
    mesh.shutdown()


# ------------------------------------------------------ the dryrun at 2 x 2

@pytest.mark.slow
def test_dryrun_legs_at_two_by_two(tmp_path):
    """python -m convasr_tpu_torch.parallel.dryrun --ranks 4 --device cpu: 2
    data x 2 model Gloo processes, every leaf of JasperNetBig at base 16
    sharded (min_channels 32), held against __graft_entry__.dryrun_multichip's
    math run here by the JAX package in one process from the same weights:
    the three losses within rtol 1e-4 (the first step's gradient norm too);
    the sharded inference's log-probs within 1e-4 of JAX's with the same
    greedy ids and lengths, and the sharded beam's tokens and lengths
    bit-equal to JAX's single-device beam."""
    import jax
    import jax.numpy as jnp
    from convasr_tpu.cli.train import to_device_batch
    from convasr_tpu.data.dataset import AudioTextDataset, frame_count_bucket_fn
    from convasr_tpu.data.device_cache import DeviceDatasetCache, gather_batch
    from convasr_tpu.data.sampler import BucketingBatchSampler
    from convasr_tpu.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu.models.zoo import create_model
    from convasr_tpu.ops.beam_device import beam_search_device
    from convasr_tpu.text import ProcessingPipeline
    from convasr_tpu.train.loop import init_train_state, make_optimizer_with_accum, \
        make_train_step
    from convasr_tpu.train.optim import make_optimizer, multistep_lr
    from convasr_tpu_torch.models.convert import from_jax_params
    from convasr_tpu_torch.parallel import dryrun
    ranks, SR = 4, 8000
    B = ranks // dryrun.grid_shape(ranks)[1]
    model = create_model('JasperNetBig', num_input_features=64, num_classes=(38,),
                         base_width=16, dtype=jnp.float32,
                         frontend=LogFilterBankFrontend(out_channels=64, sample_rate=SR,
                                                        window_size=0.02, window_stride=0.01,
                                                        dither=0.0))
    batch, manifest, infer = dryrun.synthetic_inputs(ranks, str(tmp_path))
    assert batch['x'].shape == (2, dryrun.T)
    optimizer = make_optimizer_with_accum(
        make_optimizer('novograd', multistep_lr(1e-2, 0.1, [25000, 50000]), betas=(0.95, 0.98),
                       weight_decay=1e-3), max_grad_norm=100.0, accumulate_steps=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = init_train_state(model, optimizer, jbatch, jax.random.PRNGKey(0))
    weights = dict(train=from_jax_params(state.params, state.batch_stats))
    step = jax.jit(make_train_step(model, optimizer))
    state, m1 = step(state, jbatch, jax.random.PRNGKey(1))
    config = ProcessingPipeline.load_config(str(ROOT / 'configs' / 'ru_text_config.json'))
    ds = AudioTextDataset(manifest, [ProcessingPipeline.make(config, 'char_legacy')], SR,
                          time_padding_multiple=128, bucket_fn=frame_count_bucket_fn(0.01, 128),
                          mono=True, pop_meta=True)
    idx = next(iter(BucketingBatchSampler(ds, batch_size=B, world_size=1)))
    _, cli_batch = to_device_batch(ds.collate_fn([ds[i] for i in idx]))
    state, m2 = step(state, cli_batch, jax.random.PRNGKey(2))
    dcache = DeviceDatasetCache.build(ds, time_padding_multiple=128)
    bucket, rows = dcache.locate(idx)
    dcache.upload()
    _, m3 = step(state, gather_batch(dcache.device[bucket], jnp.asarray(rows)),
                 jax.random.PRNGKey(3))
    variables = model.init(jax.random.PRNGKey(4), jnp.zeros((1, dryrun.T), jnp.float32),
                           xlen=jnp.ones((1,), jnp.float32))
    weights['inference'] = from_jax_params(variables['params'], variables['batch_stats'])
    out = model.apply(variables, jnp.asarray(infer), xlen=jnp.ones((ranks + 1,), jnp.float32))
    lp_1, olen_1 = np.asarray(out['log_probs'][0]), np.asarray(out['olen'][0])
    kw = dict(beam_width=16, cutoff_top_n=8, max_len=int(lp_1.shape[1]) + 1, compact_tokens=True)
    t1, l1, _ = beam_search_device(jnp.asarray(lp_1), jnp.asarray(olen_1, jnp.int32), 37, **kw)
    torch.save(weights, tmp_path / 'weights.pt')

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'convasr_tpu_torch.parallel.dryrun', '--ranks', str(ranks),
         '--device', 'cpu', '--weights', str(tmp_path / 'weights.pt'), '--results',
         str(tmp_path / 'results.pt')], cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    lines = [line for line in proc.stdout.splitlines() if line.startswith('dryrun_multichip(4)')]
    assert [line.split(':')[0] for line in lines] == [
        'dryrun_multichip(4)', 'dryrun_multichip(4) CLI data path',
        'dryrun_multichip(4) sharded-device-cache path',
        'dryrun_multichip(4) sharded-inference path', 'dryrun_multichip(4) sharded-device-beam path']
    got = torch.load(tmp_path / 'results.pt', weights_only=False)
    assert got['grid'] == (2, 2) and got['backend'] == 'gloo'
    assert all(r['sharded'] > 0 and r['grid'][:2] == (2, 2) for r in got['ranks'])
    np.testing.assert_allclose(got['losses'], [float(m1['loss']), float(m2['loss']),
                                               float(m3['loss'])], rtol=1e-4)
    np.testing.assert_allclose(got['grad_norm'], float(m1['grad_norm']), rtol=1e-4)
    np.testing.assert_allclose(got['log_probs'].numpy(), lp_1, rtol=0, atol=1e-4)
    assert np.array_equal(got['log_probs'].numpy().argmax(-1), lp_1.argmax(-1))
    assert np.array_equal(got['olen'].numpy(), olen_1)
    assert np.array_equal(got['tokens'].numpy(), np.asarray(t1))
    assert np.array_equal(got['lengths'].numpy(), np.asarray(l1))
