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


@pytest.mark.parametrize('case', CONV_CASES)
def test_plain_conv_on_packed_weights(case):
    """pack_conv_weight gives (K, Cout, Cin), and the plain version reads it
    as the same weight: bit-equal to the JAX-layout call and to JAX."""
    c = CONV_CASES[case]
    rng = np.random.RandomState(20 + sorted(CONV_CASES).index(case))
    x = torch.from_numpy(random_int8(rng, c['B'], c['T'], c['Cin']))
    w = torch.from_numpy(random_int8(rng, c['K'], c['Cin'], c['Cout']))
    packs = int8.CONV_WEIGHT_PACKS
    packed = int8.pack_conv_weight(w)
    assert int8.CONV_WEIGHT_PACKS == packs + 1
    assert packed.shape == (c['K'], c['Cout'], c['Cin']) and packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy(), w.numpy().transpose(0, 2, 1))
    want = int8.int8_conv1d_plain(x, w, c['stride'], c['dilation'])
    for got in (int8.int8_conv1d_plain(x, None, c['stride'], c['dilation'], w_packed=packed),
                int8.int8_conv1d_auto(x, w, c['stride'], c['dilation'], w_packed=packed)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = jax_quantized._conv1d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), c['stride'],
                                c['dilation'], out_dtype=jnp.int32)
    np.testing.assert_array_equal(want.numpy(), np.asarray(ref))


def test_packed_weight_refusals():
    x, w = cpu_pair()
    with pytest.raises(ValueError, match='give w'):
        int8.int8_conv1d_plain(x, None)
    with pytest.raises(ValueError, match='not one weight'):
        int8.int8_conv1d_plain(x, w, w_packed=torch.zeros((3, 4, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match='must be int8'):
        int8.int8_conv1d_plain(x, None, w_packed=torch.zeros((3, 2, 4)))
    with pytest.raises(ValueError, match=r'\(B, T, Cin\)'):
        int8.int8_conv1d_plain(x, None, w_packed=torch.zeros((3, 2, 5), dtype=torch.int8))
    with pytest.raises(ValueError, match='pack_conv_weight'):
        int8.pack_conv_weight(w[0])
    with pytest.raises(ValueError, match='takes CUDA tensors'):
        int8.int8_conv1d(x, None, w_packed=int8.pack_conv_weight(w))


# (T, Cin, K, stride, dilation) -> whether the wgmma kernel takes the shape
RULE_CASES = [
    ((301, 640, 25, 1, 1), True),          # block 10
    ((601, 64, 11, 2, 1), True),           # the prologue at stride 2
    ((301, 768, 29, 1, 1), True),          # the epilogue
    ((9, 16, 29, 1, 1), True),             # T shorter than K: TMA fills the halo with zeros
    ((257, 640, 1, 1, 1), True),           # one tap
    ((37, 13, 11, 1, 1), False),           # Cin % 16: TMA needs 16-byte strides
    ((50, 8, 5, 1, 1), False),             # Cin below one 16-byte piece
    ((50, 32, 5, 3, 1), False),            # stride 3: one tensor map per parity, at most 2
    ((1, 64, 11, 2, 1), False),            # a parity with no input time
    ((200, 128, 29, 1, 4), True),          # halo 128 + 112 rows: one TMA box
    ((200, 128, 29, 1, 5), False),         # halo 128 + 140 rows: past one box
    ((300, 128, 29, 2, 8), True),          # stride 2 halves the halo
]


@pytest.mark.parametrize('shape,fits', RULE_CASES, ids=[str(c[0]) for c in RULE_CASES])
def test_wgmma_shape_rule(shape, fits):
    T, Cin, K, stride, dilation = shape
    assert int8.wgmma_conv_fits(T, Cin, K, stride, dilation) == fits
    if fits:
        lo, R = int8._halo(K, stride, dilation)
        assert R % 8 == 0 and R <= int8.WGMMA_MAX_HALO
        # every tap's rows lie inside the halo
        pad = dilation * K // 2
        for k in range(K):
            off = k * dilation - pad
            j0 = (off - off % stride) // stride - lo
            assert 0 <= j0 and j0 + int8.WGMMA_BM <= R


def test_every_path_conv_takes_the_wgmma_kernel():
    """The 32 convs with taps of JasperNetBig at full width (batch of 6 s
    segments: 601 frames into the stride-2 prologue, 301 after it)."""
    from convasr_tpu_torch.models.zoo import create_model
    model = create_model('JasperNetBig', 64, (38,))
    shapes = []
    cin = 64
    for block in model._block_plan()[:-1]:
        kw = block['kwargs']
        for _ in range(kw.get('repeat', 1)):
            if kw['kernel_size'] > 1:
                shapes.append((601 if kw.get('stride', 1) == 2 else 301, cin,
                               kw['kernel_size'], kw.get('stride', 1), kw.get('dilation', 1)))
            cin = kw['out_channels']
    assert len(shapes) == 32
    assert all(int8.wgmma_conv_fits(*s) for s in shapes)
