// int8 matrix product into int32 for Hopper (sm_90a), in two variants.
//
// Replaces the TPU kernels scripts/int8_probe.py:55 (gemm_pallas_int8_full,
// whole K per cell) and scripts/int8_probe.py:75 (gemm_pallas_int8_ktiled,
// K-tiled with an int32 accumulator). On the int8 PTQ path
// (convasr_tpu/models/quantized.py) this is every conv with one tap: the 1x1
// residual convs (:262), the fused concat-GEMM of a block's residuals (:251),
// the one-tap epilogue block and the char head. Plain-PyTorch counterpart, and
// the kernels' oracle: convasr_tpu_torch/ops/int8.py (int8_matmul_plain).
//
// What it computes: a int8 (M, K) row-major, b int8 (K, N) row-major ->
// c = a @ b as int32 (M, N), exact (the deepest GEMM on the path sums
// 127^2 * 4096 ~ 6.6e7 at most).
//
// What bounds it on this card: at the path's shapes (M = 2408 rows for a batch
// of 8 six-second segments, K 256-4096, N 38-1024) operations, at the 1,979
// TOPS int8 peak: block 10's fused GEMM, 2 * 2408 * 4096 * 768 ~ 15 G
// operations, ~8 us, against ~20 MB of operands and output (~6 us). Both
// variants are the implicit GEMM of csrc/int8_mma.cuh with one tap (64 x 64
// output tiles, 4 warps of mma.sync m16n8k32, b transposed to [n][k] while
// staged):
// - whole-K (P1): a block stages its whole 64-row panel of a and 64-column
//   panel of b in shared memory, then runs the whole contraction from there.
//   Both panels take 2 * 64 * (K rounded up to 64 + 16) bytes, which fits the
//   227 KB a block may use up to K = 1792 (WHOLE_K_MAX). On JasperNetBig that
//   is block1.res0 (K 256), the fused residual GEMMs of blocks 2-6 (512-1792),
//   the one-tap epilogue block (896) and the head (1024).
// - K-tiled (P2): 64-deep panels of K stream through one shared-memory tile,
//   the next panel's loads in flight while the current one is computed, with
//   the int32 accumulators in registers across panels: the fused residual
//   GEMMs of blocks 7-10 (K 2304-4096), and any K.
#include "int8_mma.cuh"

struct int8_gemm_k_tiled_kernel {};  // names the kernel in a profile

namespace {

constexpr int WHOLE_K_MAX = 1792;

size_t whole_k_smem(int K) {
  const int padded = (K + int8mma::BK - 1) / int8mma::BK * int8mma::BK;
  return (size_t)(int8mma::BM + int8mma::BN) * (padded + int8mma::ROW_PAD);
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(int8mma::THREADS) int8_gemm_whole_k_kernel(int8mma::Conv p) {
  using namespace int8mma;
  extern __shared__ __align__(16) int8_t smem[];
  const int steps = p.steps();
  const int ld = steps * BK + ROW_PAD;
  int8_t* As = smem;
  int8_t* Bs = smem + BM * ld;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  Stager<VA, VB> st(p, m0, n0);
  for (int s = 0; s < steps; ++s) {
    st.load(p, s);
    st.store(As, Bs, ld, ld, s * BK);
  }
  __syncthreads();
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;
  compute(As, Bs, ld, ld, 0, steps * BK / 32, acc);
  store_out(p.out, p.rows(), p.Cout, m0, n0, acc);
}

template <bool VA, bool VB>
cudaError_t launch_whole_k(const int8mma::Conv& p, cudaStream_t stream) {
  const size_t smem = whole_k_smem(p.Cin);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(int8_gemm_whole_k_kernel<VA, VB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int8_gemm_whole_k_kernel<VA, VB><<<int8mma::grid_of(p), int8mma::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int8mma::Conv as_conv(const int8_t* a, const int8_t* b, int32_t* c, int M, int N, int K) {
  return int8mma::Conv{a, b, c, 1, M, M, K, N, 1, 1, 1, 0};
}

}  // namespace

// The largest K the whole-K variant takes.
extern "C" int int8_gemm_whole_k_max() { return WHOLE_K_MAX; }

// Launches the whole-K variant on `stream`; returns the CUDA error code
// (0 = launched). K must be at most int8_gemm_whole_k_max().
extern "C" int int8_gemm_whole_k(const int8_t* a, const int8_t* b, int32_t* c, int M, int N,
                                 int K, void* stream_ptr) {
  if (K > WHOLE_K_MAX) return (int)cudaErrorInvalidValue;
  const int8mma::Conv p = as_conv(a, b, c, M, N, K);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool va = int8mma::vector_x(p), vb = int8mma::vector_w(p);
  cudaError_t err;
  if (va && vb) err = launch_whole_k<true, true>(p, stream);
  else if (va) err = launch_whole_k<true, false>(p, stream);
  else if (vb) err = launch_whole_k<false, true>(p, stream);
  else err = launch_whole_k<false, false>(p, stream);
  return (int)err;
}

// Launches the K-tiled variant on `stream`; returns the CUDA error code.
extern "C" int int8_gemm_k_tiled(const int8_t* a, const int8_t* b, int32_t* c, int M, int N,
                                 int K, void* stream_ptr) {
  const int8mma::Conv p = as_conv(a, b, c, M, N, K);
  return (int)int8mma::launch_tiled<int8_gemm_k_tiled_kernel>(p, (cudaStream_t)stream_ptr);
}
