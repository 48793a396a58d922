"""The port's int8 conv and GEMM (ops/int8.py) against a numpy int64
reference and the JAX package's `quantized._conv1d(..., out_dtype=int32)`, on
the CPU, where the wrappers run their plain versions. The kernels themselves
are held against the plain versions on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convasr_tpu.models import quantized as jax_quantized
from convasr_tpu_torch.ops import int8


def conv_reference(x, w, stride, dilation):
    """numpy int64: x (B, T, Cin), w (K, Cin, Cout), pad dilation*K//2."""
    K = w.shape[0]
    pad = dilation * K // 2
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (0, 0)))
    T_out = (x.shape[1] + 2 * pad - dilation * (K - 1) - 1) // stride + 1
    out = np.zeros((x.shape[0], T_out, w.shape[2]), np.int64)
    for k in range(K):
        rows = xp[:, k * dilation:k * dilation + (T_out - 1) * stride + 1:stride]
        out += rows @ w[k].astype(np.int64)
    return out


def random_int8(rng, *shape):
    return rng.randint(-127, 128, size=shape).astype(np.int8)


CONV_CASES = dict(
    one_tap_ragged=dict(B=2, T=17, Cin=13, Cout=6, K=1, stride=1, dilation=1),
    k11=dict(B=2, T=31, Cin=16, Cout=24, K=11, stride=1, dilation=1),
    k11_stride2_odd_t=dict(B=2, T=33, Cin=12, Cout=10, K=11, stride=2, dilation=1),
    k29_longer_than_t=dict(B=1, T=23, Cin=8, Cout=16, K=29, stride=1, dilation=1),
    k11_dilation2=dict(B=2, T=41, Cin=24, Cout=20, K=11, stride=1, dilation=2),
    k29_stride2_dilation2=dict(B=1, T=57, Cin=20, Cout=12, K=29, stride=2, dilation=2),
    k1_stride2=dict(B=3, T=19, Cin=7, Cout=5, K=1, stride=2, dilation=1),
)


@pytest.mark.parametrize('case', CONV_CASES)
def test_plain_conv_equals_numpy_and_jax(case):
    c = CONV_CASES[case]
    rng = np.random.RandomState(sorted(CONV_CASES).index(case))
    x = random_int8(rng, c['B'], c['T'], c['Cin'])
    w = random_int8(rng, c['K'], c['Cin'], c['Cout'])
    want = conv_reference(x, w, c['stride'], c['dilation'])
    got = int8.int8_conv1d_auto(torch.from_numpy(x), torch.from_numpy(w), c['stride'],
                                c['dilation'])
    assert got.dtype == torch.int32
    assert got.shape[1] == int8.conv_output_length(c['T'], c['K'], c['stride'], c['dilation'])
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jax_quantized._conv1d(jnp.asarray(x), jnp.asarray(w), c['stride'], c['dilation'],
                                out_dtype=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_plain_conv_at_the_overflow_edge():
    """All +-127 at K 29, Cin 768: the largest |sum| of the int8 path,
    127^2 * 29 * 768 = 359,225,088 < 2^31, is exact in int32."""
    B, T, Cin, K = 1, 40, 768, 29
    x = np.full((B, T, Cin), 127, np.int8)
    x[:, ::3] = -127
    w = np.empty((K, Cin, 4), np.int8)
    w[..., 0], w[..., 1] = 127, -127
    w[..., 2] = np.where(np.arange(K)[:, None] % 3 == 0, -127, 127)
    w[..., 3] = random_int8(np.random.RandomState(3), K, Cin)
    want = conv_reference(x, w, 1, 1)
    got = int8.int8_conv1d_auto(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() == 127 ** 2 * K * Cin
    ref = jax_quantized._conv1d(jnp.asarray(x), jnp.asarray(w), out_dtype=jnp.int32)
    np.testing.assert_array_equal(got, np.asarray(ref))


GEMM_CASES = dict(
    ragged_head=dict(M=7, K=13, N=38),
    tile=dict(M=64, K=256, N=64),
    past_whole_k=dict(M=33, K=int8.WHOLE_K_MAX + 8, N=17),
    deep=dict(M=5, K=4096, N=9),
)


@pytest.mark.parametrize('case', GEMM_CASES)
def test_plain_matmul_equals_numpy_and_jax(case):
    c = GEMM_CASES[case]
    rng = np.random.RandomState(10 + sorted(GEMM_CASES).index(case))
    a, b = random_int8(rng, c['M'], c['K']), random_int8(rng, c['K'], c['N'])
    got = int8.int8_matmul_auto(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    # the one-tap conv of the JAX package computes the same product
    ref = jax_quantized._conv1d(jnp.asarray(a)[None], jnp.asarray(b)[None], out_dtype=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[0])


def test_plain_matmul_at_the_overflow_edge():
    a = np.full((3, 4096), -127, np.int8)
    b = np.full((4096, 2), 127, np.int8)
    b[:, 1] = -127
    got = int8.int8_matmul_auto(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got[:, 0], -(127 ** 2) * 4096)
    np.testing.assert_array_equal(got[:, 1], 127 ** 2 * 4096)


def cpu_pair(shape_x=(1, 8, 4), shape_w=(3, 4, 2)):
    return torch.zeros(shape_x, dtype=torch.int8), torch.zeros(shape_w, dtype=torch.int8)


@pytest.mark.parametrize('fn', [int8.int8_conv1d, int8.int8_conv1d_plain, int8.int8_conv1d_auto],
                         ids=['kernel', 'plain', 'auto'])
def test_conv_wrappers_refuse(fn):
    x, w = cpu_pair()
    with pytest.raises(ValueError, match='must be int8'):
        fn(x.float(), w)
    with pytest.raises(ValueError, match='must be int8'):
        fn(x, w.to(torch.int32))
    with pytest.raises(ValueError, match='input on cpu, weight on meta'):
        fn(x, w.to('meta'))
    with pytest.raises(ValueError, match='contiguous'):
        fn(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match='grouped'):
        fn(x, w[:, :2].contiguous(), groups=2)
    with pytest.raises(ValueError, match=r'\(B, T, Cin\)'):
        fn(x, torch.zeros((3, 5, 2), dtype=torch.int8))


@pytest.mark.parametrize('fn', [int8.int8_matmul, int8.int8_matmul_plain, int8.int8_matmul_auto],
                         ids=['kernel', 'plain', 'auto'])
def test_matmul_wrappers_refuse(fn):
    a, b = torch.zeros((6, 4), dtype=torch.int8), torch.zeros((4, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match='must be int8'):
        fn(a.to(torch.int32), b)
    with pytest.raises(ValueError, match='input on cpu, weight on meta'):
        fn(a, b.to('meta'))
    with pytest.raises(ValueError, match='contiguous'):
        fn(a, torch.zeros((3, 4), dtype=torch.int8).t())
    # a grouped one-tap weight (Cin/g rows) does not fit the product
    with pytest.raises(ValueError, match=r'\(M, K\)'):
        fn(a, b[:2].contiguous())


def test_kernel_wrappers_take_only_cuda_tensors():
    x, w = cpu_pair()
    before = (int8.CONV_LAUNCHES, int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_K_TILED_LAUNCHES)
    with pytest.raises(ValueError, match='takes CUDA tensors'):
        int8.int8_conv1d(x, w)
    with pytest.raises(ValueError, match='takes CUDA tensors'):
        int8.int8_matmul(x[0], w[0])
    # the dispatch sends CPU tensors to the plain versions, counting no launch
    int8.int8_conv1d_auto(x, w)
    int8.int8_matmul_auto(x[0], w[0])
    assert (int8.CONV_LAUNCHES, int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_K_TILED_LAUNCHES) == before
