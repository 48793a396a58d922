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
- `int8_matmul(a, b, b_packed=None)`: a int8 (M, K), b int8 (K, N) -> int32
  (M, N); csrc/int8_gemm.cu. Shapes that `gemm_wgmma_fits` takes (K % 16 ==
  0, at any depth) run the wgmma GEMM, which reads b packed as (N, K) with
  its tensor maps (`pack_gemm_weight`, a `GemmWeight`); a call without
  b_packed packs (counted in GEMM_WEIGHT_PACKS). Other K up to WHOLE_K_MAX
  run the mma.sync whole-K kernel, deeper ones the K-tiled one, both on b.
  Either of b and b_packed may be None.

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
import typing

import torch
import torch.nn.functional as F

from . import build

# launches of each kernel variant, counted where it is launched
CONV_LAUNCHES = 0            # the wgmma conv
CONV_MMA_SYNC_LAUNCHES = 0   # the mma.sync conv loop
CONV_WEIGHT_PACKS = 0        # pack_conv_weight calls
GEMM_WGMMA_LAUNCHES = 0      # the wgmma GEMM
GEMM_WHOLE_K_LAUNCHES = 0    # the mma.sync whole-K GEMM
GEMM_K_TILED_LAUNCHES = 0
GEMM_WEIGHT_PACKS = 0        # pack_gemm_weight calls


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


# the deepest contraction of the whole-K GEMM (two 64-row panels of K, rounded
# up to 64, + 16 bytes fit the 227 KB of shared memory a block has); the wgmma
# GEMM's K is a multiple of GEMM_K_MULTIPLE (TMA's 16-byte row strides);
# GEMM_NUM_BN tensor maps of GEMM_MAP_BYTES a packed b
WHOLE_K_MAX, GEMM_K_MULTIPLE, GEMM_NUM_BN, GEMM_MAP_BYTES = _source_constants(
    'int8_gemm', ('WHOLE_K_MAX', 'K_MULTIPLE', 'NUM_BN', 'MAP_BYTES'))
_GEMM_ERRORS = {-1: 'cuTensorMapEncodeTiled not found', -2: 'a tensor map was not encoded',
                -3: 'shape or alignment outside the kernel\'s rule'}


def _gemm_library():
    lib = build.load('int8_gemm')
    if lib.int8_gemm_whole_k.argtypes is None:
        for fn in (lib.int8_gemm_whole_k, lib.int8_gemm_k_tiled, lib.int8_gemm_wgmma):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.int8_gemm_wgmma_encode_b.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p]
        lib.int8_gemm_wgmma_bn.argtypes = [ctypes.c_int] * 2
        for fn in (lib.int8_gemm_whole_k, lib.int8_gemm_k_tiled, lib.int8_gemm_wgmma,
                   lib.int8_gemm_wgmma_encode_b, lib.int8_gemm_wgmma_bn):
            fn.restype = ctypes.c_int
    return lib


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


def gemm_wgmma_fits(K: int) -> bool:
    """The shape rule of the wgmma GEMM (int8_gemm_wgmma_fits in
    csrc/int8_gemm.cu is the same rule, and refuses a launch outside it, or
    with an a not on 16 bytes, which int8_matmul copies first): TMA's 16-byte
    row strides (K % 16 == 0), at any depth. Other K go to the mma.sync
    kernels."""
    return K >= GEMM_K_MULTIPLE and K % GEMM_K_MULTIPLE == 0


class GemmWeight(typing.NamedTuple):
    """b (K, N) packed for the wgmma GEMM: `packed` (N, K) contiguous (every
    output column a contiguous K strip: wgmma takes 8-bit operands K-major
    only) and, for a weight on the card, `maps`, the kernel's tensor maps of
    it, one per tile width, encoded once (None on the CPU)."""
    packed: torch.Tensor
    maps: typing.Optional[bytes]


def pack_gemm_weight(b: torch.Tensor) -> GemmWeight:
    """(K, N) int8 -> GemmWeight, for K % 16 == 0. The int8 path calls it once
    per quantized tree, for the weights whose K `gemm_wgmma_fits` takes; on
    the card it encodes the tensor maps then (a failed encode raises)."""
    global GEMM_WEIGHT_PACKS
    if b.dtype != torch.int8 or b.ndim != 2 or b.shape[0] < GEMM_K_MULTIPLE \
            or b.shape[0] % GEMM_K_MULTIPLE:
        raise ValueError(f'pack_gemm_weight: b must be int8 (K, N) with K % {GEMM_K_MULTIPLE} '
                         f'== 0, got {b.dtype} {tuple(b.shape)}')
    GEMM_WEIGHT_PACKS += 1
    packed = b.t().contiguous()
    if not packed.is_cuda:
        return GemmWeight(packed, None)
    maps = ctypes.create_string_buffer(GEMM_NUM_BN * GEMM_MAP_BYTES)
    with torch.cuda.device(packed.device):
        rc = _gemm_library().int8_gemm_wgmma_encode_b(packed.data_ptr(), packed.shape[0],
                                                      packed.shape[1], maps)
    if rc != 0:
        raise RuntimeError(f'pack_gemm_weight: {_GEMM_ERRORS.get(rc, f"error {rc}")}')
    return GemmWeight(packed, maps.raw)


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


def _check_matmul(a, b, b_packed=None):
    """Checks as the kernels need them, of b (K, N) and of b_packed, the same
    weight packed; either may be None. -> (M, K, N)."""
    if b is None and b_packed is None:
        raise ValueError('int8_matmul: give b (K, N) or b_packed (a GemmWeight)')
    shapes = set()
    if b is not None:
        _check('int8_matmul', a, b)
        shapes.add(tuple(b.shape))
    if b_packed is not None:
        _check('int8_matmul', a, b_packed.packed)
        if b_packed.packed.ndim != 2:
            raise ValueError(f'int8_matmul: b_packed must be (N, K), got '
                             f'{tuple(b_packed.packed.shape)}')
        shapes.add(tuple(b_packed.packed.shape[::-1]))
    if len(shapes) > 1:
        raise ValueError(f'int8_matmul: b {tuple(b.shape)} and b_packed '
                         f'{tuple(b_packed.packed.shape)} are not one weight')
    (shape,) = shapes
    if a.ndim != 2 or len(shape) != 2 or a.shape[1] != shape[0]:
        raise ValueError(f'int8_matmul: a must be (M, K) and b (K, N), got '
                         f'{tuple(a.shape)} and {shape}')
    return a.shape[0], a.shape[1], shape[1]


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


def int8_matmul_plain(a: torch.Tensor, b, b_packed=None) -> torch.Tensor:
    """The GEMM kernels in plain PyTorch: int32 on the CPU, float64 on the
    card. b_packed, if b is None, is read as its transpose."""
    _check_matmul(a, b, b_packed)
    if b is None:
        b = b_packed.packed.t()
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


def gemm_route(K: int) -> str:
    """The GEMM kernel for a contraction of K: 'wgmma' where gemm_wgmma_fits
    takes K, else 'whole_k' (the mma.sync kernel) up to WHOLE_K_MAX and
    'k_tiled' past it."""
    if gemm_wgmma_fits(K):
        return 'wgmma'
    return 'whole_k' if K <= WHOLE_K_MAX else 'k_tiled'


def _launch_gemm(a, b, b_packed, N, route):
    """One launch of a GEMM kernel of csrc/int8_gemm.cu: route 'wgmma' (on
    b_packed), 'whole_k' or 'k_tiled' (the mma.sync kernels, on b)."""
    M, K = a.shape
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _gemm_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        if route == 'wgmma':
            if b_packed.maps is None:
                raise ValueError('int8_matmul: b_packed was packed on the CPU')
            # TMA reads a from a 16-byte boundary (the allocator's tensors
            # start on one; a view may not)
            a = a if a.data_ptr() % 16 == 0 else a.clone()
            rc = lib.int8_gemm_wgmma(a.data_ptr(), b_packed.maps, out.data_ptr(), M, N, K, stream)
        else:
            fn = lib.int8_gemm_whole_k if route == 'whole_k' else lib.int8_gemm_k_tiled
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, stream)
    if rc != 0:
        raise RuntimeError(f'int8_matmul ({route}): '
                           f'{_GEMM_ERRORS.get(rc, f"CUDA error {rc}")} at launch')
    return out


def int8_matmul(a: torch.Tensor, b, b_packed=None) -> torch.Tensor:
    """csrc/int8_gemm.cu on the card -> int32 (M, N): the wgmma GEMM where
    `gemm_wgmma_fits` takes K (on b_packed, packed here if not given), else
    the mma.sync whole-K kernel for K <= WHOLE_K_MAX and the K-tiled one
    above (on b). Raises on anything the kernels do not take;
    a failed encode or launch raises, never falls back."""
    global GEMM_WGMMA_LAUNCHES, GEMM_WHOLE_K_LAUNCHES, GEMM_K_TILED_LAUNCHES
    M, K, N = _check_matmul(a, b, b_packed)
    _cuda_only('int8_matmul', a)
    route = gemm_route(K)
    if route == 'wgmma':
        if b_packed is None:
            b_packed = pack_gemm_weight(b)
    elif b is None:
        b = b_packed.packed.t().contiguous()
    out = _launch_gemm(a, b, b_packed, N, route)
    if out.numel() > 0:
        if route == 'wgmma':
            GEMM_WGMMA_LAUNCHES += 1
        elif route == 'whole_k':
            GEMM_WHOLE_K_LAUNCHES += 1
        else:
            GEMM_K_TILED_LAUNCHES += 1
    return out


def _int8_matmul_wgmma(a, b_packed):
    """The wgmma GEMM, for measurements. Counts no launch."""
    _, _, N = _check_matmul(a, None, b_packed)
    _cuda_only('int8_matmul', a)
    return _launch_gemm(a, None, b_packed, N, 'wgmma')


def wgmma_gemm_bn(M: int, N: int) -> int:
    """The tile width (64, 128 or 192) the wgmma GEMM picks on this card."""
    return _gemm_library().int8_gemm_wgmma_bn(M, N)


def int8_conv1d_auto(x, w, stride=1, dilation=1, groups=1, w_packed=None):
    """The kernels for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return int8_conv1d(x, w, stride, dilation, groups, w_packed=w_packed)
    return int8_conv1d_plain(x, w, stride, dilation, groups, w_packed=w_packed)


def int8_matmul_auto(a, b, b_packed=None):
    """The kernels for CUDA tensors, the plain version for CPU tensors."""
    if a.is_cuda:
        return int8_matmul(a, b, b_packed=b_packed)
    return int8_matmul_plain(a, b, b_packed=b_packed)
