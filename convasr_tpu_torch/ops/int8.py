"""int8 products into int32 on the CUDA kernels and their plain versions
(counterpart of the int8 convs of convasr_tpu/models/quantized.py, which the
JAX package left to XLA, and of the probe kernels scripts/int8_conv_probe.py
and scripts/int8_probe.py).

- `int8_conv1d(x, w, stride, dilation)`: x int8 (B, T, Cin) channels-last, w
  int8 (K, Cin, Cout), zero padding of dilation * K // 2 on both ends ->
  int32 (B, T_out, Cout); csrc/int8_conv.cu.
- `int8_matmul(a, b)`: a int8 (M, K), b int8 (K, N) -> int32 (M, N);
  csrc/int8_gemm.cu, whole-K for K <= WHOLE_K_MAX and K-tiled above.

Both take the JAX package's layouts, so a quantized tree's weights go to the
kernels as they are. `*_auto` picks the plain version (`*_plain`) for
tensors on the CPU and the kernel for tensors on the card, never the other
way: on the card the kernel runs or the call raises.

The plain versions are the kernels' oracle. On the CPU they compute in
int32 (torch's CPU matmul takes integer tensors). CUDA has no
integer convolution or matmul, so on the card they compute in float64 and
cast to int32, which is exact: every product and partial sum is an integer
below 2^53. float32 is not exact here (2^24 ~ 1.7e7 lies below the path's
largest sum, 127^2 * 29 * 768 ~ 3.6e8), and neither are bf16 or TF32 (cuDNN's
default for float32 convolutions), so none of them may serve as the oracle.
"""
import ctypes

import torch
import torch.nn.functional as F

from . import build

# the deepest contraction the whole-K GEMM takes: two 64-row panels of
# K (rounded up to 64) + 16 bytes fit the 227 KB of shared memory a block has
WHOLE_K_MAX = 1792
# launches of each kernel variant, counted where it is launched
CONV_LAUNCHES = 0
GEMM_WHOLE_K_LAUNCHES = 0
GEMM_K_TILED_LAUNCHES = 0


def _conv_library():
    fn = build.load('int8_conv').int8_conv1d
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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


def _check_conv(x, w, stride, dilation, groups):
    _check('int8_conv1d', x, w, groups)
    if x.ndim != 3 or w.ndim != 3 or x.shape[2] != w.shape[1]:
        raise ValueError(f'int8_conv1d: x must be (B, T, Cin) and w (K, Cin, Cout), got '
                         f'{tuple(x.shape)} and {tuple(w.shape)}')
    if stride < 1 or dilation < 1:
        raise ValueError('int8_conv1d: stride and dilation must be >= 1')


def _check_matmul(a, b):
    _check('int8_matmul', a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f'int8_matmul: a must be (M, K) and b (K, N), got '
                         f'{tuple(a.shape)} and {tuple(b.shape)}')


def int8_conv1d_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, dilation: int = 1,
                      groups: int = 1) -> torch.Tensor:
    """The conv kernel in plain PyTorch, as a sum over taps of (strided,
    shifted x) @ w[k]: int32 on the CPU, float64 on the card. (torch's CPU
    convolution takes int32 only without dilation.)"""
    _check_conv(x, w, stride, dilation, groups)
    dtype = torch.float64 if x.is_cuda else torch.int32
    B, T, _ = x.shape
    K, _, Cout = w.shape
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


def int8_conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, dilation: int = 1,
                groups: int = 1) -> torch.Tensor:
    """csrc/int8_conv.cu on the card -> int32 (B, T_out, Cout). Raises on
    anything the kernel does not take."""
    global CONV_LAUNCHES
    _check_conv(x, w, stride, dilation, groups)
    _cuda_only('int8_conv1d', x)
    B, T, Cin = x.shape
    K, _, Cout = w.shape
    T_out = conv_output_length(T, K, stride, dilation)
    out = torch.empty((B, max(T_out, 0), Cout), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    fn = _conv_library()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, T_out, Cin, Cout, K, stride,
                dilation, dilation * K // 2, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'int8_conv1d: CUDA error {rc} at launch')
    CONV_LAUNCHES += 1
    return out


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


def int8_conv1d_auto(x, w, stride=1, dilation=1, groups=1):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return int8_conv1d(x, w, stride, dilation, groups)
    return int8_conv1d_plain(x, w, stride, dilation, groups)


def int8_matmul_auto(a, b):
    """The kernels for CUDA tensors, the plain version for CPU tensors."""
    if a.is_cuda:
        return int8_matmul(a, b)
    return int8_matmul_plain(a, b)
