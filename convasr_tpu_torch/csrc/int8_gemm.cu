// int8 matrix product into int32 for Hopper (sm_90a), in three variants.
//
// Replaces the TPU kernels scripts/int8_probe.py:55 (gemm_pallas_int8_full,
// whole K per cell) and scripts/int8_probe.py:75 (gemm_pallas_int8_ktiled,
// K-tiled with an int32 accumulator). On the int8 PTQ path
// (convasr_tpu/models/quantized.py) this is every conv with one tap: the 1x1
// residual convs (:262), the fused concat-GEMM of a block's residuals (:251),
// the one-tap epilogue block and the char head. Plain-PyTorch counterpart, and
// the kernels' oracle: convasr_tpu_torch/ops/int8.py (int8_matmul_plain).
//
// What it computes: a int8 (M, K) row-major, b int8 (K, N) -> c = a @ b as
// int32 (M, N), exact (the deepest GEMM on the path sums 127^2 * 4096 ~ 6.6e7
// at most).
//
// What bounds it on this card: at the path's shapes (M = 2408 rows for a batch
// of 8 six-second segments, K 256-4096, N 38-1024) bytes and operations about
// equally: block 6's fused GEMM, 2 * 2408 * 1792 * 512 ~ 4.4 G operations,
// ~2.2 us at the 1,979 TOPS int8 peak, against ~10 MB of operands and output,
// ~3 us at 3.35 TB/s; M 4096 K 1792 N 4096 (the TPU probe) is bound by its
// operations, ~30 us.
//
// int8_gemm_wgmma (the route of every K % 16 == 0, of any depth: P1's whole-K
// products and P2's deep ones; 16-byte aligned operands; the rule is
// ops/int8.py gemm_wgmma_fits):
// - Products on wgmma.mma_async m64nNk32 s8 x s8 -> s32. A block owns BM = 128
//   rows x BN columns (64, 128 or 192, picked per shape so that the grid fills
//   the SMs in the fewest rounds); two consumer warpgroups each own a 64-row
//   slab and keep its int32 sums in registers over all of K, exact while
//   |sum| < 2^31: up to K ~ 133,000 at +-127.
// - One producer thread keeps TMA loads in flight through a ring of STAGES
//   stages over the K / 128 chunks (any number of them: a stage's phase bit
//   flips at each pass of the ring), each one 128-deep K chunk of a (128 x 128
//   bytes) and of b (BN x 128 bytes), both with the 128-byte swizzle, with a
//   "full" and an "empty" mbarrier each. There is no __syncthreads in the main
//   loop. TMA zero-fills rows past M and N and the K past the last chunk, so
//   no product is masked.
// - wgmma takes 8-bit operands K-major only, so b comes packed once per
//   quantized tree as (N, K) (ops/int8.py pack_gemm_weight), with its tensor
//   maps, one per BN, encoded then (int8_gemm_wgmma_encode_b): a call encodes
//   only a's map.
// - Rows at or past M and columns at or past N are masked in the epilogue.
// The mma.sync variants, the implicit GEMM of csrc/int8_mma.cuh with one tap (64 x
// 64 output tiles, 4 warps of mma.sync m16n8k32, b transposed to [n][k] while
// staged):
// - whole-K (P1 for K not a multiple of 16): a block stages its whole 64-row
//   panel of a and 64-column panel of b in shared memory, then runs the whole
//   contraction from there. Both panels take 2 * 64 * (K rounded up to 64 +
//   16) bytes, which fits the 227 KB a block may use up to K = 1792
//   (WHOLE_K_MAX).
// - K-tiled (P2 for K past WHOLE_K_MAX that is not a multiple of 16): 64-deep
//   panels of K stream through one shared-memory tile, the next panel's loads
//   in flight while the current one is computed, with the int32 accumulators
//   in registers across panels.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int8_mma.cuh"
#include "wgmma_tma.cuh"

struct int8_gemm_k_tiled_kernel {};  // names the kernel in a profile

namespace {

// the largest K of the whole-K variant (ops/int8.py reads it from this line)
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

namespace int8_gemm_wgmma_tma {

using namespace wgmma_tma;

// ops/int8.py reads K_MULTIPLE from these lines for its copy of the shape rule
// (int8_gemm_wgmma_fits below)
constexpr int BM = 128;            // rows of a per block
constexpr int BK = 128;            // K bytes per stage: one 128-byte swizzle row
constexpr int STAGES = 5;          // stages in flight
constexpr int THREADS = 384;       // warpgroup 0 produces, warpgroups 1-2 consume
constexpr int CONSUMERS = 256;     // arrivals that release a stage
constexpr int K_MULTIPLE = 16;     // TMA's row strides are multiples of 16 bytes
constexpr int NUM_BN = 3;          // tile widths, one tensor map of b each
constexpr int MAP_BYTES = 128;     // one CUtensorMap
constexpr int SMEM_LIMIT = 232448; // dynamic shared memory a block may have
constexpr int BNS[NUM_BN] = {64, 128, 192};

// error codes besides CUDA's (which are positive)
constexpr int ERR_ENTRY_POINT = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;       // a tensor map could not be encoded
constexpr int ERR_SHAPE = -3;        // a shape or pointer outside the kernel's rule

static_assert(sizeof(CUtensorMap) == MAP_BYTES, "CUtensorMap is not 128 bytes");

// 1024 bytes of alignment slack, the stages of a and b, and the mbarriers
__host__ __device__ constexpr int smem_bytes(int BN) {
  return 1024 + STAGES * (BM + BN) * BK + 2 * STAGES * 8;
}
static_assert(smem_bytes(192) <= SMEM_LIMIT, "stages past shared memory");

// grid: (row tiles of M, column tiles of N). amap: a (M, K), 128 x 128-byte
// boxes; bmap: packed b (N, K), BN x 128-byte boxes; both 128-byte swizzled.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
           int32_t* __restrict__ out, int M, int N, int chunks) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int A_STAGE = BM * BK, B_STAGE = BN * BK;
  uint8_t* as = smem;                       // STAGES x [BM rows][128 bytes]
  uint8_t* bs = as + STAGES * A_STAGE;      // STAGES x [BN rows][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + STAGES * B_STAGE);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // warp-uniform, so that the compiler sees each warpgroup take one path
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread starts every TMA load ----
    if (threadIdx.x != 0) return;
    int st = 0;
    uint32_t ph = 0;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&empty[st], ph ^ 1);
      mbar_expect_tx(&full[st], A_STAGE + B_STAGE);
      tma_load_3d(as + st * A_STAGE, &amap, &full[st], c * BK, m0, 0);
      tma_load_3d(bs + st * B_STAGE, &bmap, &full[st], c * BK, n0, 0);
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  } else {
    // ---- consumers: warpgroups 1 and 2, rows (wg - 1) * 64 .. + 63 of the tile ----
    const int wrow = (wg - 1) * 64;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const uint32_t as_base = smem_u32(as), bs_base = smem_u32(bs);
    int st = 0, prev_st = -1;
    uint32_t ph = 0;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[st], ph);
      const uint64_t da = make_desc(as_base + st * A_STAGE + wrow * BK, 16, 1024, 1);
      const uint64_t db = make_desc(bs_base + st * B_STAGE, 16, 1024, 1);
      wgmma_fence();
      // the chunk's 4 k32 steps, +32 bytes each in a swizzled row; K past the
      // last chunk meets zeros TMA filled in
#pragma unroll
      for (int j = 0; j < BK / 32; ++j)
        mma<BN>(acc, da + (uint64_t)(2 * j), db + (uint64_t)(2 * j));
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: release its stage
      if (prev_st >= 0) mbar_arrive(&empty[prev_st]);
      prev_st = st;
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");

    // epilogue: rows past M and columns past N are masked
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tq = lane & 3;
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wrow + 16 * warp + g + 8 * h;
        if (m >= M || n >= N) continue;
        int32_t* dst = out + (size_t)m * N + n;
        const int v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        } else {
          dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

// The index into BNS with the fewest rounds of one block per SM, times BN
// (the work a round gives each SM); ties go to the wider tile, which reads
// each row of a fewer times.
static int pick_bn(int M, int N) {
  const long long rows = (M + BM - 1) / BM, sms = num_sms();
  int best = 0;
  long long best_cost = -1;
  for (int i = 0; i < NUM_BN; ++i) {
    const long long blocks = rows * ((N + BNS[i] - 1) / BNS[i]);
    const long long cost = (blocks + sms - 1) / sms * BNS[i];
    if (best_cost < 0 || cost <= best_cost) best = i, best_cost = cost;
  }
  return best;
}

template <int BN>
static int launch(const CUtensorMap& amap, const CUtensorMap& bmap, int32_t* out, int M, int N,
                  int chunks, cudaStream_t stream) {
  // the attribute once per instantiation and device
  static unsigned long long sized = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 63) & 1ull)) {
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&kernel<BN>),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes(BN));
    if (err != cudaSuccess) return (int)err;
    sized |= 1ull << (dev & 63);
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  kernel<BN><<<grid, THREADS, smem_bytes(BN), stream>>>(amap, bmap, out, M, N, chunks);
  return (int)cudaGetLastError();
}

// TMA's 16-byte row strides: the kernel itself takes any such K
inline bool k_fits(int K) { return K >= K_MULTIPLE && K % K_MULTIPLE == 0; }

}  // namespace int8_gemm_wgmma_tma

// 1 if the route gives int8_gemm_wgmma a contraction of K: k_fits, at any
// depth (ops/int8.py gemm_wgmma_fits is the same rule, with the operand's
// 16-byte alignment). Other K go to the mma.sync kernels.
extern "C" int int8_gemm_wgmma_fits(int K) { return int8_gemm_wgmma_tma::k_fits(K); }

// The tile width the launcher picks for the shape (for logs).
extern "C" int int8_gemm_wgmma_bn(int M, int N) {
  using namespace int8_gemm_wgmma_tma;
  return BNS[pick_bn(M, N)];
}

// Encodes the NUM_BN tensor maps of a packed b (N, K), one per tile width,
// into `maps` (NUM_BN * MAP_BYTES bytes of host memory); the int8 path does
// this once per weight, when it packs it. Returns 0 or a negative error code.
extern "C" int int8_gemm_wgmma_encode_b(const int8_t* b_packed, int N, int K, void* maps) {
  using namespace int8_gemm_wgmma_tma;
  if (!k_fits(K) || N < 1 || reinterpret_cast<uintptr_t>(b_packed) % 16) return ERR_SHAPE;
  EncodeTiled enc = encoder();
  if (!enc) return ERR_ENTRY_POINT;
  for (int i = 0; i < NUM_BN; ++i) {
    CUtensorMap map;
    if (!encode(enc, &map, b_packed, K, N, 1, (cuuint64_t)K, (cuuint64_t)N * K, BK, BNS[i],
                CU_TENSOR_MAP_SWIZZLE_128B))
      return ERR_ENCODE;
    memcpy(static_cast<char*>(maps) + i * MAP_BYTES, &map, MAP_BYTES);
  }
  return 0;
}

// Launches the wgmma GEMM on `stream`: a (M, K) row-major and 16-byte
// aligned, b_maps the tensor maps of its packed b from
// int8_gemm_wgmma_encode_b, c (M, N) int32. Returns 0 when launched, a CUDA
// error code, or a negative error code.
extern "C" int int8_gemm_wgmma(const int8_t* a, const void* b_maps, int32_t* c, int M, int N,
                               int K, void* stream_ptr) {
  using namespace int8_gemm_wgmma_tma;
  if (!k_fits(K) || M < 1 || N < 1 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 8)
    return ERR_SHAPE;
  EncodeTiled enc = encoder();
  if (!enc) return ERR_ENTRY_POINT;
  CUtensorMap amap, bmap;
  if (!encode(enc, &amap, a, K, M, 1, (cuuint64_t)K, (cuuint64_t)M * K, BK, BM,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return ERR_ENCODE;
  const int i = pick_bn(M, N);
  memcpy(&bmap, static_cast<const char*>(b_maps) + i * MAP_BYTES, MAP_BYTES);
  const int chunks = (K + BK - 1) / BK;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (BNS[i] == 64) return launch<64>(amap, bmap, c, M, N, chunks, stream);
  if (BNS[i] == 128) return launch<128>(amap, bmap, c, M, N, chunks, stream);
  return launch<192>(amap, bmap, c, M, N, chunks, stream);
}
