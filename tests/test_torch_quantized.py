"""The port's int8 PTQ path (models/quantized.py) against the JAX package's,
one case for each case of tests/test_quantized.py, on weights carried across
by models/convert.py (base width 8, 16 features, B 2, T 96, randomized BN
statistics). On the CPU the int8 products run the plain versions of the
kernels (ops/int8.py), which are exact."""
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_model_parity import randomize_batch_stats

from convasr_tpu.models import quantized as jq
from convasr_tpu.models.zoo import create_model as jax_create_model
from convasr_tpu_torch.models import quantized as q
from convasr_tpu_torch.models.convert import from_jax_params
from convasr_tpu_torch.models.zoo import create_model

FEATURES, CLASSES = 16, 10
BPE = ('JasperNetBig', (('decoder_type', 'bpe'), ('num_classes', (CLASSES, 2 * CLASSES))))
MODELS = {
    'JasperNetBig': ('JasperNetBig', ()),              # flagship: dense, subblocks=2
    'JasperNet': ('JasperNet', ()),                    # temporal_mask=True path
    'JasperNetSeparable': ('JasperNetSeparable', (('groups', 8),)),  # depthwise+pointwise
    'JasperNetResidualBig': ('JasperNetResidualBig', ()),            # plain residual
    'bpe_head': BPE,
}


@functools.lru_cache(maxsize=None)
def build(name, kw=()):
    """(jax model, jax variables, port model, x, xlen), the port's model on
    the JAX weights; x (2, 96, 16) features, xlen [1, 0.625]."""
    kw = dict(kw)
    kw.setdefault('num_classes', (CLASSES,))
    jax_model = jax_create_model(name, num_input_features=FEATURES, dtype=jnp.float32,
                                 base_width=8, normalize_features=True, **kw)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 96, FEATURES).astype(np.float32)
    xlen = np.asarray([1.0, 0.625], np.float32)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), xlen=jnp.asarray(xlen))
    variables = randomize_batch_stats(variables, jax.random.PRNGKey(1))
    variables = jax.tree.map(np.asarray, variables)
    num_classes = kw.pop('num_classes')
    model = create_model(name, FEATURES, num_classes, base_width=8, normalize_features=True,
                         **kw).eval()
    model.load_state_dict(from_jax_params(variables['params'], variables['batch_stats']))
    return jax_model, variables, model, x, xlen


def t(a):
    return torch.from_numpy(np.asarray(a))


def cosine(a, b):
    return np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)


@functools.lru_cache(maxsize=None)
def jax_qtree(key, percentile=100.0):
    jax_model, variables, _, x, xlen = build(*MODELS[key])
    return jq.quantize(jax_model, variables, [dict(x=x, xlen=xlen)], percentile=percentile)


@pytest.mark.parametrize('key', MODELS)
def test_folded_matches_jax_and_model(key):
    jax_model, variables, model, x, xlen = build(*MODELS[key])
    got = q.folded_apply(model, t(x), t(xlen))
    ref = jq.folded_apply(jax_model, variables, jnp.asarray(x), xlen=jnp.asarray(xlen))
    with torch.no_grad():
        own = model(t(x), xlen=t(xlen))
    assert len(got['log_probs']) == len(ref['log_probs']) == (2 if key == 'bpe_head' else 1)
    for g, r, o in zip(got['log_probs'], ref['log_probs'], own['log_probs']):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=1e-3, atol=1e-4)
    for g, r, o in zip(got['olen'], ref['olen'], own['olen']):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), o.numpy())


@pytest.mark.parametrize('key', ['JasperNetBig', 'JasperNetSeparable', 'bpe_head'])
def test_folded_layers_match_jax(key):
    jax_model, variables, model, _, _ = build(*MODELS[key])
    got, ref = q.build_folded_layers(model), jq.build_folded_layers(jax_model, variables)
    assert list(got) == list(ref)               # the same names in the same order
    for name in ref:
        assert set(got[name]) == set(ref[name]), name
        for f in ref[name]:
            assert got[name][f].shape == ref[name][f].shape, (name, f)
            np.testing.assert_allclose(got[name][f], ref[name][f], rtol=0, atol=1e-6,
                                       err_msg=f'{name}.{f}')


@pytest.mark.parametrize('percentile', [100.0, 99.9])
@pytest.mark.parametrize('key', ['JasperNetBig', 'JasperNetSeparable'])
def test_calibration_matches_jax(key, percentile):
    jax_model, variables, model, x, xlen = build(*MODELS[key])
    batches = [dict(x=x, xlen=xlen)]
    got = q.calibrate(model, batches, percentile)
    ref = jq.calibrate(jax_model, variables, batches, percentile)
    assert set(got) == set(ref)
    # the folded float32 convs sum in another order than XLA's
    np.testing.assert_allclose([got[k] for k in ref], [ref[k] for k in ref], rtol=1e-5)


def test_percentile_matches_jnp_and_takes_large_inputs():
    rng = np.random.RandomState(4)
    for n, pct in [(1, 50.0), (7, 99.9), (1000, 99.9), (12345, 37.5), (4096, 100.0)]:
        a = np.abs(rng.randn(n)).astype(np.float32)
        # the same float32 operations; XLA may contract lv * lw + hv * hw to an FMA
        np.testing.assert_allclose(float(q.percentile(t(a), pct)),
                                   float(jnp.percentile(jnp.asarray(a), pct)), rtol=1e-5)
    # torch.quantile refuses more than 2^24 elements; a calibration batch of
    # long files passes that
    a = torch.arange(2 ** 24 + 3, dtype=torch.float32).flip(0)
    assert float(q.percentile(a, 50.0)) == pytest.approx((2 ** 24 + 2) / 2, rel=1e-6)


@pytest.mark.parametrize('key', ['JasperNetBig', 'JasperNetSeparable', 'JasperNetResidualBig'])
def test_quantize_matches_jax(key):
    """Given the same act scales, the int8 weights (fused residual GEMMs
    included) are bit-equal and the scales and biases equal to 1e-6."""
    jax_model, variables, model, _, _ = build(*MODELS[key])
    ref = jax_qtree(key)
    got = q.quantize(model, None, act_scales=ref['act_scales'])
    assert list(got['layers']) == list(ref['layers'])
    if key == 'JasperNetBig':
        assert any(k.endswith('.resfused') for k in got['layers'])
    for name, entry in ref['layers'].items():
        assert set(got['layers'][name]) == set(entry), name
        for f, want in entry.items():
            have = got['layers'][name][f]
            if np.asarray(want).dtype == np.int8:
                assert have.dtype == np.int8
                np.testing.assert_array_equal(have, want, err_msg=f'{name}.{f}')
            else:
                np.testing.assert_allclose(have, want, rtol=1e-6, atol=0, err_msg=f'{name}.{f}')


@pytest.mark.parametrize('epilogue', ['float32', 'bfloat16'])
@pytest.mark.parametrize('key', ['JasperNetBig', 'JasperNet', 'JasperNetSeparable', 'bpe_head'])
def test_quantized_apply_matches_jax(key, epilogue):
    """The same qtree through both packages. The int8 products are exact in
    both; the float epilogues run the same operations, but a value that lands
    within an ulp of a .5 boundary of the requant flips one int8 step in one
    package only, and the flip propagates. So: log-probs within 1e-3 and at
    least 99% of greedy ids equal (both are bit-equal on these inputs)."""
    jax_model, _, model, x, xlen = build(*MODELS[key])
    qtree = jax_qtree(key)
    got = q.quantized_apply(model, qtree, t(x), t(xlen), epilogue_dtype=getattr(torch, epilogue))
    ref = jq.quantized_apply(jax_model, qtree, jnp.asarray(x), xlen=jnp.asarray(xlen),
                             epilogue_dtype=getattr(jnp, epilogue))
    for g, r in zip(got['log_probs'], ref['log_probs']):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3)
        assert np.mean(g.argmax(-1) == r.argmax(-1)) >= 0.99
    for g, r in zip(got['olen'], ref['olen']):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_int8_tracks_float():
    _, _, model, x, xlen = build(*MODELS['JasperNetBig'])
    qtree = q.quantize(model, [dict(x=x, xlen=xlen)])
    with torch.no_grad():
        w = model(t(x), xlen=t(xlen))['log_probs'][0].numpy()
    g = q.quantized_apply(model, qtree, t(x), t(xlen))['log_probs'][0].numpy()
    assert cosine(w, g) > 0.99
    assert np.mean(w.argmax(-1) == g.argmax(-1)) > 0.95
    assert qtree['layers']['block1.conv0']['wq'].dtype == np.int8


def test_int8_convs_route_to_conv_and_gemm(monkeypatch):
    """JasperNetBig runs 32 convs with taps (prologue, 10 blocks x 3 repeats,
    the 29-tap epilogue) and 12 one-tap GEMMs (block1.res0, the fused residual
    GEMMs of blocks 2-10, the one-tap epilogue block, the head)."""
    _, _, model, x, xlen = build(*MODELS['JasperNetBig'])
    calls = route_calls(monkeypatch)
    q.quantized_apply(model, jax_qtree('JasperNetBig'), t(x), t(xlen))
    assert len(calls['conv']) == 32 and all(k > 1 for k, _, _ in calls['conv'])
    assert calls['packed'] == [None] * 32      # a tree on the CPU is not packed
    assert len(calls['gemm']) == 12
    # base width 8: the deepest fused GEMM concatenates 4*16 + 2*24 + 2*32 + 2*40
    assert max(k for k, _ in calls['gemm']) == 256 and calls['gemm'][-1][1] == CLASSES


def route_calls(monkeypatch):
    """Stand-ins for the two int8 dispatchers of models/quantized.py that
    record each call's weight shapes (and the packed conv weight's)."""
    calls = dict(conv=[], packed=[], gemm=[])
    conv, gemm = q.int8_conv1d_auto, q.int8_matmul_auto

    def spy_conv(x_, w, *a, w_packed=None, **kw):
        calls['conv'].append(tuple(w.shape))
        calls['packed'].append(None if w_packed is None else tuple(w_packed.shape))
        return conv(x_, w, *a, w_packed=w_packed, **kw)
    monkeypatch.setattr(q, 'int8_conv1d_auto', spy_conv)
    monkeypatch.setattr(q, 'int8_matmul_auto',
                        lambda a_, b, *a, **kw: calls['gemm'].append(tuple(b.shape))
                        or gemm(a_, b, *a, **kw))
    return calls


def packed_tree(qtree):
    """The tree as `to_device` leaves it on the card, built on the CPU: every
    int8 conv weight with taps also packed, 'wqp' = pack_conv_weight(wq)."""
    from convasr_tpu_torch.ops.int8 import pack_conv_weight
    tree = q.to_device(qtree, torch.device('cpu'))
    for layer in tree['layers'].values():
        if layer['wq'].ndim == 3 and layer['wq'].shape[0] > 1:
            layer['wqp'] = pack_conv_weight(layer['wq'])
    return tree


def test_packed_tree_routes_packed_weights_once(monkeypatch):
    """A tree as the card holds it carries every conv weight with taps also
    as (K, Cout, Cin), packed once: the forward hands the packed weight to
    each of the 32 convs and packs nothing. On the CPU `to_device` packs
    nothing and keeps what a tree has."""
    from convasr_tpu_torch.ops import int8
    _, _, model, x, xlen = build(*MODELS['JasperNetBig'])
    qtree = jax_qtree('JasperNetBig')
    packs = int8.CONV_WEIGHT_PACKS
    assert not any('wqp' in layer for layer in
                   q.to_device(qtree, torch.device('cpu'))['layers'].values())
    tree = packed_tree(qtree)
    assert int8.CONV_WEIGHT_PACKS == packs + 32
    assert q.to_device(tree, torch.device('cpu'))['layers']['block1.conv0']['wqp'] \
        is tree['layers']['block1.conv0']['wqp']            # already packed: kept as it is
    assert 'wqp' not in tree['layers']['block2.resfused'] and 'wqp' not in \
        tree['layers']['decoder.head0']                     # one-tap products stay GEMMs
    calls = route_calls(monkeypatch)
    got = q.quantized_apply(model, tree, t(x), t(xlen))['log_probs'][0]
    assert int8.CONV_WEIGHT_PACKS == packs + 32
    assert [(k, n, c) for k, c, n in calls['conv']] == calls['packed']
    want = q.quantized_apply(model, qtree, t(x), t(xlen))['log_probs'][0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_int8_jits_and_scale_invariance():
    """The counterpart of the JAX test's jit/eager check: two calls on the
    same qtree (once put on the device, once as numpy) give the same output."""
    _, _, model, x, xlen = build(*MODELS['JasperNetBig'])
    qtree = q.quantize(model, [dict(x=x, xlen=xlen)], percentile=99.9)
    a = q.quantized_apply(model, qtree, t(x), t(xlen))['log_probs'][0]
    b = q.quantized_apply(model, q.to_device(qtree, torch.device('cpu')), t(x),
                          t(xlen))['log_probs'][0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_calibration_batches_widen_scales():
    _, _, model, x, xlen = build(*MODELS['JasperNetBig'])
    s1 = q.quantize(model, [dict(x=x, xlen=xlen)])['act_scales']
    s2 = q.quantize(model, [dict(x=x, xlen=xlen), dict(x=5.0 * x, xlen=xlen)])['act_scales']
    assert all(s2[k] >= s1[k] - 1e-12 for k in s1)
    assert any(s2[k] > s1[k] for k in s1)


@pytest.mark.parametrize('writer', ['torch', 'jax'])
def test_act_scales_cache_both_ways(tmp_path, writer):
    """A scales cache written by either package loads in the port and gives
    the qtree and output of a fresh calibration bit for bit."""
    jax_model, variables, model, x, xlen = build(*MODELS['JasperNetBig'])
    path = str(tmp_path / 'scales.npz')
    if writer == 'torch':
        calibrated = q.quantize(model, [dict(x=x, xlen=xlen)])
        q.save_act_scales(path, calibrated['act_scales'])
    else:
        calibrated = q.quantize(model, None, act_scales=jax_qtree('JasperNetBig')['act_scales'])
        jq.save_act_scales(path, jax_qtree('JasperNetBig')['act_scales'])
    cached = q.quantize(model, None, act_scales=q.load_act_scales(path))
    assert list(cached['act_scales']) == list(calibrated['act_scales'])
    for k in calibrated['act_scales']:
        assert cached['act_scales'][k] == calibrated['act_scales'][k], k
    a = q.quantized_apply(model, calibrated, t(x), t(xlen))['log_probs'][0]
    b = q.quantized_apply(model, cached, t(x), t(xlen))['log_probs'][0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # and the JAX package reads the port's cache
    if writer == 'torch':
        loaded = jq.load_act_scales(path)
        assert {k: float(v) for k, v in loaded.items()} == \
            {k: float(v) for k, v in calibrated['act_scales'].items()}


def test_quantize_cached_writes_and_reads(tmp_path):
    _, _, model, x, xlen = build(*MODELS['JasperNetBig'])
    path = tmp_path / 'scales.npz'
    first = q.quantize_cached(model, [dict(x=x, xlen=xlen)], cache_path=str(path))
    assert path.exists()
    second = q.quantize_cached(model, batches=None, cache_path=str(path))
    for k in first['act_scales']:
        assert second['act_scales'][k] == first['act_scales'][k], k
    with pytest.raises(ValueError, match='no calibration batches'):
        q.quantize_cached(model, batches=None, cache_path=str(tmp_path / 'missing.npz'))


def test_residual_fusion_matches_per_conv():
    _, _, model, x, xlen = build(*MODELS['JasperNetBig'])
    qtree = q.quantize(model, [dict(x=x, xlen=xlen)])
    fused_names = [k for k in qtree['layers'] if k.endswith('.resfused')]
    assert fused_names, 'dense topology must produce fused residual entries'
    for k in fused_names:
        L = qtree['layers'][k]
        assert L['wq'].dtype == np.int8 and L['wq'].shape[0] == 1
        assert L['s'].shape == (L['wq'].shape[2],)
    unfused = dict(qtree, layers={k: v for k, v in qtree['layers'].items()
                                  if not k.endswith('.resfused')})
    a = q.quantized_apply(model, qtree, t(x), t(xlen))['log_probs'][0].numpy()
    b = q.quantized_apply(model, unfused, t(x), t(xlen))['log_probs'][0].numpy()
    assert cosine(a, b) > 0.999
    assert np.mean(a.argmax(-1) == b.argmax(-1)) > 0.99
    with torch.no_grad():
        want = model(t(x), xlen=t(xlen))['log_probs'][0].numpy()
    assert cosine(want, a) > 0.99


@pytest.mark.parametrize('writer', ['torch', 'jax'])
def test_qtree_file_both_ways(tmp_path, writer):
    """A .qtree.npz written by either package (JAX save_qtree is what
    `cli/export.py --quantize` writes) gives the same output in both."""
    jax_model, variables, model, x, xlen = build(*MODELS['JasperNetBig'])
    qtree = jax_qtree('JasperNetBig')
    path = str(tmp_path / 'model.qtree.npz')
    if writer == 'torch':
        q.save_qtree(path, q.quantize(model, None, act_scales=qtree['act_scales']))
    else:
        jq.save_qtree(path, qtree)
    with np.load(path) as z:
        assert 'layers/block2.resfused/wq' in z.files and 'act_scales/features' in z.files
    ours = q.quantized_apply(model, q.load_qtree(path), t(x), t(xlen))['log_probs'][0].numpy()
    theirs = np.asarray(jq.quantized_apply(jax_model, jq.load_qtree(path), jnp.asarray(x),
                                           xlen=jnp.asarray(xlen))['log_probs'][0])
    direct = q.quantized_apply(model, qtree, t(x), t(xlen))['log_probs'][0].numpy()
    np.testing.assert_array_equal(ours, direct)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-3)   # as quantized_apply above


def test_qtree_file_after_packing_matches_jax(tmp_path):
    """A .qtree.npz written from a packed tree (as the card holds it) has the
    JAX package's keys and arrays bit for bit: the packed weights stay out."""
    qtree = jax_qtree('JasperNetBig')
    ours, theirs = str(tmp_path / 'ours.qtree.npz'), str(tmp_path / 'theirs.qtree.npz')
    q.save_qtree(ours, packed_tree(qtree))
    jq.save_qtree(theirs, qtree)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) and not any('wqp' in k for k in a.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_int8_bpe_dual_head():
    _, _, model, x, xlen = build(*MODELS['bpe_head'])
    qtree = q.quantize(model, [dict(x=x, xlen=xlen)])
    with torch.no_grad():
        want = model(t(x), xlen=t(xlen))['log_probs']
    got = q.quantized_apply(model, qtree, t(x), t(xlen))['log_probs']
    assert len(got) == 2
    for w, g in zip(want, got):
        assert cosine(w.numpy(), g.numpy()) > 0.98
