"""int8 products into int32 on the CUDA kernels and their plain versions
(counterpart of the int8 convs of convasr_tpu/models/quantized.py, which the
JAX package left to XLA, and of the probe kernels scripts/int8_conv_probe.py
and scripts/int8_probe.py).

- `int8_conv1d(x, w, stride, dilation, w_packed=None)`: x int8 (B, T, Cin)
  channels-last, w int8 (K, Cin, Cout), zero padding of dilation * K // 2 on
  both ends -> int32 (B, T_out, Cout); csrc/int8_conv.cu. Shapes that
  `wgmma_conv_fits` takes run the wgmma kernel, which reads the weights
  packed as (K, Cout, Cin) (`pack_conv_weight`); all others the mma.sync
  loop, which reads the JAX layout. `w_packed` is the packed
  weight, given explicitly: the int8 path packs each tree once when it puts
  it on the card (models/quantized.to_device), and a call without it packs
  (counted in CONV_WEIGHT_PACKS). Either of w and w_packed may be None.
- `int8_matmul(a, b)`: a int8 (M, K), b int8 (K, N) -> int32 (M, N);
  csrc/int8_gemm.cu, whole-K for K <= WHOLE_K_MAX and K-tiled above.

The public functions take the JAX package's layouts, so a quantized tree's
weights go to the kernels as they are. `*_auto` picks the plain version
(`*_plain`) for tensors on the CPU and the kernel for tensors on the card,
never the other way: on the card the kernel runs or the call raises.

The plain versions are the kernels' oracle. On the CPU they compute in
int32 (torch's CPU matmul takes integer tensors). CUDA has no
integer convolution or matmul, so on the card they compute in float64 and
cast to int32, which is exact: every product and partial sum is an integer
below 2^53. float32 is not exact here (2^24 ~ 1.7e7 lies below the path's
largest sum, 127^2 * 29 * 768 ~ 3.6e8), and neither are bf16 or TF32 (cuDNN's
default for float32 convolutions), so none of them may serve as the oracle.
"""
import ctypes
import re

import torch
import torch.nn.functional as F

from . import build

# the deepest contraction the whole-K GEMM takes: two 64-row panels of
# K (rounded up to 64) + 16 bytes fit the 227 KB of shared memory a block has
WHOLE_K_MAX = 1792
# launches of each kernel variant, counted where it is launched
CONV_LAUNCHES = 0            # the wgmma conv
CONV_MMA_SYNC_LAUNCHES = 0   # the mma.sync conv loop
CONV_WEIGHT_PACKS = 0        # pack_conv_weight calls
GEMM_WHOLE_K_LAUNCHES = 0
GEMM_K_TILED_LAUNCHES = 0


def _source_constants(name: str, names) -> tuple:
    """The values of `constexpr int NAME = value;` lines of csrc/<name>.cu:
    the shape rule reads the kernel's tile from its source, which needs no
    build (the rule also serves the CPU's tests)."""
    found = dict(re.findall(r'constexpr int (\w+) = (-?\d+);',
                            (build.CSRC / f'{name}.cu').read_text()))
    return tuple(int(found[n]) for n in names)


# the wgmma conv's output rows per block, the largest stride (one x tensor map
# per input-time parity) and the most halo rows (one TMA box)
WGMMA_BM, WGMMA_MAX_STRIDE, WGMMA_MAX_HALO = _source_constants(
    'int8_conv', ('BM', 'MAX_STRIDE', 'MAX_HALO'))


def _conv_library():
    lib = build.load('int8_conv')
    if lib.int8_conv1d.argtypes is None:
        lib.int8_conv1d.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.int8_conv1d_wgmma.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                                          + [ctypes.c_void_p])
        lib.int8_conv1d_wgmma_fits.argtypes = [ctypes.c_int] * 5
        lib.int8_conv1d_wgmma_bn.argtypes = [ctypes.c_int] * 3
        for fn in (lib.int8_conv1d, lib.int8_conv1d_wgmma, lib.int8_conv1d_wgmma_fits,
                   lib.int8_conv1d_wgmma_bn):
            fn.restype = ctypes.c_int
    return lib


def _gemm_library():
    lib = build.load('int8_gemm')
    whole_k, k_tiled = lib.int8_gemm_whole_k, lib.int8_gemm_k_tiled
    if whole_k.argtypes is None:
        for fn in (whole_k, k_tiled):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.int8_gemm_whole_k_max.restype = ctypes.c_int
        if lib.int8_gemm_whole_k_max() != WHOLE_K_MAX:
            raise RuntimeError('csrc/int8_gemm.cu and ops/int8.py disagree on WHOLE_K_MAX')
    return whole_k, k_tiled


def conv_output_length(T: int, K: int, stride: int = 1, dilation: int = 1) -> int:
    """Output frames of the int8 conv: pad = dilation * K // 2 on both ends."""
    pad = dilation * K // 2
    return (T + 2 * pad - dilation * (K - 1) - 1) // stride + 1


def _halo(K: int, stride: int, dilation: int):
    """(lo, R) of the wgmma conv: a row tile's x halo holds rows lo .. lo + R - 1
    (in rows of one input-time parity) past its first output time; R is
    rounded up to 8 rows."""
    pad = dilation * K // 2
    lo = (-pad - (stride - 1)) // stride
    hi = ((K - 1) * dilation - pad) // stride
    return lo, -(-(WGMMA_BM + hi - lo) // 8) * 8


def wgmma_conv_fits(T: int, Cin: int, K: int, stride: int = 1, dilation: int = 1) -> bool:
    """The shape rule of the wgmma conv kernel (int8_conv1d_wgmma_fits in
    csrc/int8_conv.cu is the same rule, and refuses a launch outside it):
    TMA's 16-byte strides (Cin % 16 == 0), one x tensor map per input-time
    parity (stride <= 2, T >= stride) and a halo of at most one TMA box (256
    rows; the source asserts that such a halo fits shared memory). Other
    shapes go to the mma.sync loop."""
    if Cin < 16 or Cin % 16 or K < 1 or dilation < 1 or not 1 <= stride <= WGMMA_MAX_STRIDE \
            or T < stride:
        return False
    return _halo(K, stride, dilation)[1] <= WGMMA_MAX_HALO


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) int8 -> (K, Cout, Cin) contiguous, the wgmma conv's
    layout: every output channel a contiguous Cin strip (wgmma takes 8-bit
    operands K-major only). The int8 path calls it once per quantized tree."""
    global CONV_WEIGHT_PACKS
    if w.dtype != torch.int8 or w.ndim != 3:
        raise ValueError(f'pack_conv_weight: w must be int8 (K, Cin, Cout), got {w.dtype} '
                         f'{tuple(w.shape)}')
    CONV_WEIGHT_PACKS += 1
    return w.transpose(1, 2).contiguous()


def _check(op: str, a, b, groups: int = 1):
    """The wrappers' common checks: int8, one device, contiguous, groups 1."""
    for name, t in (('input', a), ('weight', b)):
        if t.dtype != torch.int8:
            raise ValueError(f'{op}: {name} must be int8, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{op}: {name} must be contiguous')
    if a.device != b.device:
        raise ValueError(f'{op}: input on {a.device}, weight on {b.device}')
    if groups != 1:
        raise ValueError(f'{op}: grouped int8 convolutions (groups={groups}) are not supported')


def _check_conv(x, w, stride, dilation, groups, w_packed=None):
    """Checks as the kernels need them, of w (K, Cin, Cout) and of w_packed,
    the same weight as (K, Cout, Cin); either may be None. -> (K, Cin, Cout)."""
    if w is None and w_packed is None:
        raise ValueError('int8_conv1d: give w (K, Cin, Cout) or w_packed (K, Cout, Cin)')
    shapes = set()
    if w is not None:
        _check('int8_conv1d', x, w, groups)
        shapes.add(tuple(w.shape))
    if w_packed is not None:
        _check('int8_conv1d', x, w_packed, groups)
        if w_packed.ndim != 3:
            raise ValueError(f'int8_conv1d: w_packed must be (K, Cout, Cin), got '
                             f'{tuple(w_packed.shape)}')
        K, Cout, Cin = w_packed.shape
        shapes.add((K, Cin, Cout))
    if len(shapes) > 1:
        raise ValueError(f'int8_conv1d: w {tuple(w.shape)} and w_packed '
                         f'{tuple(w_packed.shape)} are not one weight')
    (shape,) = shapes
    if x.ndim != 3 or len(shape) != 3 or x.shape[2] != shape[1]:
        raise ValueError(f'int8_conv1d: x must be (B, T, Cin) and w (K, Cin, Cout), got '
                         f'{tuple(x.shape)} and {shape}')
    if stride < 1 or dilation < 1:
        raise ValueError('int8_conv1d: stride and dilation must be >= 1')
    return shape


def _check_matmul(a, b):
    _check('int8_matmul', a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f'int8_matmul: a must be (M, K) and b (K, N), got '
                         f'{tuple(a.shape)} and {tuple(b.shape)}')


def int8_conv1d_plain(x: torch.Tensor, w, stride: int = 1, dilation: int = 1,
                      groups: int = 1, w_packed=None) -> torch.Tensor:
    """The conv kernels in plain PyTorch, as a sum over taps of (strided,
    shifted x) @ w[k]: int32 on the CPU, float64 on the card. (torch's CPU
    convolution takes int32 only without dilation.) w_packed, if w is None,
    is read as its transpose."""
    K, _, Cout = _check_conv(x, w, stride, dilation, groups, w_packed)
    if w is None:
        w = w_packed.transpose(1, 2)
    dtype = torch.float64 if x.is_cuda else torch.int32
    B, T, _ = x.shape
    pad = dilation * K // 2
    T_out = max(conv_output_length(T, K, stride, dilation), 0)
    xp = F.pad(x.to(dtype), (0, 0, pad, pad))
    wd = w.to(dtype)
    out = torch.zeros((B, T_out, Cout), dtype=dtype, device=x.device)
    for k in range(K):
        start = k * dilation
        out += xp[:, start:start + (T_out - 1) * stride + 1:stride] @ wd[k]
    return out.to(torch.int32)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The GEMM kernels in plain PyTorch: int32 on the CPU, float64 on the card."""
    _check_matmul(a, b)
    dtype = torch.float64 if a.is_cuda else torch.int32
    return (a.to(dtype) @ b.to(dtype)).to(torch.int32)


def _cuda_only(op: str, t: torch.Tensor):
    if not t.is_cuda:
        raise ValueError(f'{op} takes CUDA tensors; use its plain version on the CPU')


def _launch_conv(x, w, w_packed, K, Cout, stride, dilation, route):
    """One launch of a conv kernel of csrc/int8_conv.cu: route 'wgmma' (on
    w_packed) or 'mma_sync' (the mma.sync loop, on w)."""
    B, T, Cin = x.shape
    T_out = conv_output_length(T, K, stride, dilation)
    out = torch.empty((B, max(T_out, 0), Cout), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _conv_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    pad = dilation * K // 2
    with torch.cuda.device(x.device):
        if route == 'mma_sync':
            rc = lib.int8_conv1d(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, T_out, Cin,
                                 Cout, K, stride, dilation, pad, stream)
        else:
            rc = lib.int8_conv1d_wgmma(x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), B, T,
                                       T_out, Cin, Cout, K, stride, dilation, pad, stream)
    if rc != 0:
        what = {-1: 'cuTensorMapEncodeTiled not found', -2: 'a tensor map was not encoded',
                -3: 'shape or alignment outside the kernel\'s rule'}.get(rc, f'CUDA error {rc}')
        raise RuntimeError(f'int8_conv1d ({route}): {what} at launch')
    return out


def int8_conv1d(x: torch.Tensor, w, stride: int = 1, dilation: int = 1, groups: int = 1,
                w_packed=None) -> torch.Tensor:
    """csrc/int8_conv.cu on the card -> int32 (B, T_out, Cout): the wgmma
    kernel where `wgmma_conv_fits` takes the shape (on w_packed, packed here
    if not given), the mma.sync loop elsewhere (on w). Raises on anything
    the kernels do not take; a failed encode or launch raises, never falls
    back."""
    global CONV_LAUNCHES, CONV_MMA_SYNC_LAUNCHES
    K, Cin, Cout = _check_conv(x, w, stride, dilation, groups, w_packed)
    _cuda_only('int8_conv1d', x)
    if wgmma_conv_fits(x.shape[1], Cin, K, stride, dilation):
        if w_packed is None:
            w_packed = pack_conv_weight(w)
        out = _launch_conv(x, None, w_packed, K, Cout, stride, dilation, 'wgmma')
        CONV_LAUNCHES += out.numel() > 0
    else:
        if w is None:
            w = w_packed.transpose(1, 2).contiguous()
        out = _launch_conv(x, w, None, K, Cout, stride, dilation, 'mma_sync')
        CONV_MMA_SYNC_LAUNCHES += out.numel() > 0
    return out


def _int8_conv1d_mma_sync(x, w, stride=1, dilation=1, w_packed=None):
    """The mma.sync loop whatever the rule says, for measurements against
    the wgmma kernel. Counts no launch."""
    K, _, Cout = _check_conv(x, w, stride, dilation, 1, w_packed)
    _cuda_only('int8_conv1d', x)
    if w is None:
        w = w_packed.transpose(1, 2).contiguous()
    return _launch_conv(x, w, None, K, Cout, stride, dilation, 'mma_sync')


def wgmma_conv_bn(B: int, T_out: int, Cout: int) -> int:
    """The output-channel tile (128 or 192) the wgmma conv picks on this card."""
    return _conv_library().int8_conv1d_wgmma_bn(B, T_out, Cout)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """csrc/int8_gemm.cu on the card -> int32 (M, N): the whole-K variant for
    K <= WHOLE_K_MAX, the K-tiled one above. Raises on anything the kernels do
    not take."""
    global GEMM_WHOLE_K_LAUNCHES, GEMM_K_TILED_LAUNCHES
    _check_matmul(a, b)
    _cuda_only('int8_matmul', a)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    whole_k, k_tiled = _gemm_library()
    fn = whole_k if K <= WHOLE_K_MAX else k_tiled
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'int8_matmul: CUDA error {rc} at launch')
    if fn is whole_k:
        GEMM_WHOLE_K_LAUNCHES += 1
    else:
        GEMM_K_TILED_LAUNCHES += 1
    return out


def int8_conv1d_auto(x, w, stride=1, dilation=1, groups=1, w_packed=None):
    """The kernels for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return int8_conv1d(x, w, stride, dilation, groups, w_packed=w_packed)
    return int8_conv1d_plain(x, w, stride, dilation, groups, w_packed=w_packed)


def int8_matmul_auto(a, b):
    """The kernels for CUDA tensors, the plain version for CPU tensors."""
    if a.is_cuda:
        return int8_matmul(a, b)
    return int8_matmul_plain(a, b)
