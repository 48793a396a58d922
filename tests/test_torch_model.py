"""The port's JasperNet against the JAX package's, on weights carried across
by models/convert.py (reduced widths, float32, randomized BN statistics)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from convasr_tpu.frontend.logmel import LogFilterBankFrontend as JaxFrontend
from convasr_tpu.models.zoo import create_model as jax_create_model
from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
from convasr_tpu_torch.models.convert import from_jax_npz, from_jax_params
from convasr_tpu_torch.models.zoo import create_model

SR, FEATURES, CLASSES = 8000, 16, 38


def randomized_variables(model, x, xlen, seed):
    """flax init, then every BN statistic and affine made non-trivial."""
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), xlen=jnp.asarray(xlen))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (1 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        if p[-1].key == 'scale' else np.asarray(v), variables['params'])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * rng.randn(*v.shape)).astype(np.float32) if p[-1].key == 'mean'
        else rng.uniform(0.5, 2.0, v.shape).astype(np.float32), variables['batch_stats'])
    return dict(params=params, batch_stats=stats)


def both_models(name, seed=0, **overrides):
    kw = dict(base_width=8, **overrides)
    jax_model = jax_create_model(name, FEATURES, (CLASSES,), frontend=JaxFrontend(
        FEATURES, SR, 0.02, 0.01, dither=0.0), **kw)
    torch_model = create_model(name, FEATURES, (CLASSES,), frontend=LogFilterBankFrontend(
        FEATURES, SR, 0.02, 0.01, dither=0.0), **kw).eval()
    return jax_model, torch_model


def inputs(seed, B=3, T=4000, short=False):
    rng = np.random.RandomState(seed)
    x = (0.1 * rng.randn(B, T)).astype(np.float32)
    xlen = np.ones(B, np.float32)
    if short:
        xlen[1:] = [0.61, 0.83][:B - 1]
    return x, xlen


def compare(jax_model, torch_model, x, xlen, variables):
    torch_model.load_state_dict(from_jax_params(variables['params'], variables['batch_stats']))
    ref = jax_model.apply(variables, jnp.asarray(x), xlen=jnp.asarray(xlen))
    with torch.no_grad():
        out = torch_model(torch.from_numpy(x), xlen=torch.from_numpy(xlen))
    lp_ref = np.asarray(ref['log_probs'][0])
    lp = out['log_probs'][0].numpy()
    assert lp.shape == lp_ref.shape
    # atol 1e-3: float32 summation order differs over ~20 conv layers
    np.testing.assert_allclose(lp, lp_ref, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(out['olen'][0].numpy(), np.asarray(ref['olen'][0]))
    top2 = np.sort(lp_ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    np.testing.assert_array_equal(lp.argmax(-1)[clear], lp_ref.argmax(-1)[clear])


@pytest.mark.parametrize('short', [False, True], ids=['full', 'xlen_lt_1'])
@pytest.mark.parametrize('name', ['JasperNetBig', 'JasperNetSmall', 'Wav2LetterDense',
                                  'Wav2LetterFlat', 'JasperNetResidualBig'])
def test_log_probs_match_jax(name, short):
    jax_model, torch_model = both_models(name)
    x, xlen = inputs(1, short=short)
    variables = randomized_variables(jax_model, x[:1], np.ones(1, np.float32), seed=2)
    compare(jax_model, torch_model, x, xlen, variables)


def test_npz_checkpoint_round_trip(tmp_path):
    jax_model, torch_model = both_models('JasperNetBig')
    x, xlen = inputs(3, short=True)
    variables = randomized_variables(jax_model, x[:1], np.ones(1, np.float32), seed=4)
    flat = {'/'.join(['params'] + [k.key for k in p]): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(variables['params'])}
    flat.update({'/'.join(['batch_stats'] + [k.key for k in p]): np.asarray(v)
                 for p, v in jax.tree_util.tree_leaves_with_path(variables['batch_stats'])})
    np.savez(tmp_path / 'ckpt.npz', **flat)
    sd = from_jax_npz(str(tmp_path / 'ckpt.npz'))
    assert set(sd) == set(torch_model.state_dict())
    compare(jax_model, torch_model, x, xlen, variables)
