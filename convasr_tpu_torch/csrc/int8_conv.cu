// int8 1-D convolution into int32 for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/int8_conv_probe.py:47 (conv_pallas_int8):
// the int8 x int8 -> int32 conv with K taps of the int8 PTQ path
// (convasr_tpu/models/quantized.py, _conv1d at :43-52, called at :193), which
// the JAX package left to XLA. Plain-PyTorch counterpart, and the kernel's
// oracle: convasr_tpu_torch/ops/int8.py (int8_conv1d_plain).
//
// What it computes: x int8 (B, T_in, Cin) channels-last, w int8 (K, Cin, Cout)
// (the JAX package's layout, so quantized weights need no relayout), stride,
// dilation, zero padding of pad = dilation * K // 2 on both ends:
//   out[b, t, co] = sum_{k, ci} x[b, t*stride - pad + k*dilation, ci] * w[k, ci, co]
// as int32 (B, T_out, Cout), T_out = (T_in + 2*pad - dilation*(K-1) - 1) / stride + 1.
// Integer products and sums: the result is bit-equal to the oracle. The
// largest sum on the int8 path, 127^2 * 29 * 768 ~ 3.6e8, is far below 2^31.
//
// What bounds it on this card: operations. A JasperNetBig conv at batch 8
// does 2 * 2408 * 768 * 25 * 640 ~ 59 G int8 operations on ~21 MB of operands
// and output: ~30 us at the 1,979 TOPS int8 peak against ~6 us at 3.35 TB/s.
// The TPU kernel kept the weights of one channel tile in VMEM and walked a sequential
// grid over (batch, time) tiles with double-buffered DMA of padded x. Here it
// is an implicit GEMM (csrc/int8_mma.cuh): output positions (b, t) are the
// GEMM's rows, the contraction walks (tap, channel), each block owns a 64 x 64
// output tile, and the taps' shifted x rows are read straight from device
// memory (through L2) with padding handled by masked loads, so no padded or
// unfolded copy of x is ever written. The products run on the tensor cores
// through mma.sync m16n8k32; wgmma, TMA and a reuse of x rows across taps are
// for a later change.
#include "int8_mma.cuh"

struct int8_conv_kernel {};  // names the kernel: int8mma::tiled_kernel<int8_conv_kernel, ...>

// Launches the conv on `stream`; returns the CUDA error code (0 = launched).
// All tensors contiguous; w is (K, Cin, Cout).
extern "C" int int8_conv1d(const int8_t* x, const int8_t* w, int32_t* out, int B, int T_in,
                           int T_out, int Cin, int Cout, int K, int stride, int dilation,
                           int pad, void* stream_ptr) {
  int8mma::Conv p{x, w, out, B, T_in, T_out, Cin, Cout, K, stride, dilation, pad};
  return (int)int8mma::launch_tiled<int8_conv_kernel>(p, (cudaStream_t)stream_ptr);
}
