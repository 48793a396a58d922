// int8 1-D convolution into int32 for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/int8_conv_probe.py:47 (conv_pallas_int8):
// the int8 x int8 -> int32 conv with K taps of the int8 PTQ path
// (convasr_tpu/models/quantized.py, _conv1d at :43-52, called at :193), which
// the JAX package left to XLA. Plain-PyTorch counterpart, and the kernels'
// oracle: convasr_tpu_torch/ops/int8.py (int8_conv1d_plain).
//
// What it computes: x int8 (B, T_in, Cin) channels-last, stride, dilation,
// zero padding of pad = dilation * K // 2 on both ends:
//   out[b, t, co] = sum_{k, ci} x[b, t*stride - pad + k*dilation, ci] * w[k, ci, co]
// as int32 (B, T_out, Cout), T_out = (T_in + 2*pad - dilation*(K-1) - 1) / stride + 1.
// Integer products and sums: the result is bit-equal to the oracle. The
// largest sum on the int8 path, 127^2 * 29 * 768 ~ 3.6e8, is far below 2^31.
//
// What bounds it on this card: operations. Block 10 of JasperNetBig at batch 8
// does 2 * 2408 * 768 * 25 * 640 ~ 59 G int8 operations on ~21 MB of operands
// and output: ~30 us at the 1,979 TOPS int8 peak against ~6 us at 3.35 TB/s.
//
// Two kernels live here.
//
// int8_conv1d_wgmma (the path's kernel, for Cin % 16 == 0 and stride <= 2;
// the rule is ops/int8.py wgmma_conv_fits): an implicit GEMM whose rows are
// output times t of one utterance, whose columns are output channels and
// whose contraction walks (128-channel chunk, tap).
// - Products on wgmma.mma_async m64nNk32 s8 x s8 -> s32. A block owns
//   BM = 128 time rows x BN output channels (128 or 192, picked per shape so
//   that the grid fills the SMs in the fewest rounds); two consumer
//   warpgroups each own a 64-row slab and keep its int32 sums in registers
//   over the whole contraction. 128 x 192 keeps the operand bytes per
//   product low enough for shared memory (A 2 KB + B 12 KB per 64x192x32
//   product) and the weight traffic from L2 at one read per 128 rows.
// - One producer thread keeps TMA loads in flight through a ring of STAGES
//   weight stages (one tap, 128 channels, BN output channels) with a "full"
//   and an "empty" mbarrier each; the consumers wait on "full", run the
//   tap's wgmmas, and release the stage after wgmma.wait_group. There is no
//   __syncthreads in the main loop.
// - The weights come packed once per quantized tree as (K, Cout, Cin)
//   (ops/int8.py pack_conv_weight): wgmma takes 8-bit operands K-major only,
//   so every output channel is one contiguous Cin strip, and a stage arrives
//   by one TMA box with the 128-byte swizzle that the B descriptor names. No
//   thread touches weight bytes.
// - x is staged once per (row tile, channel chunk) as a halo of
//   BM + (K-1)*dilation rows (per stride phase) and reused by all K taps, as
//   the TPU kernel did with its VMEM halo. A tap's A operand is the halo
//   shifted by k*dilation rows, which a swizzled layout cannot express for a
//   shift that is not a multiple of 8 rows. So the halo is kept unswizzled
//   as [16-byte channel piece][row][16 bytes]: 8 x 16-byte core matrices
//   with rows 16 bytes apart (SBO 128) and pieces R*16 bytes apart (LBO), in
//   which a shift by any number of rows is a 16-byte move of the descriptor.
//   TMA's out-of-bounds zero fill stands in for the padding: rows before 0
//   and at or after T_in read as zeros, and no padded copy of x is written.
//   Stride s reads s tensor maps, one per input-time parity: map q views
//   times q, q+s, q+2s, ... with a row stride of s*Cin bytes.
//
// int8_conv1d (the mma.sync loop, csrc/int8_mma.cuh): mma.sync m16n8k32 with
// masked loads and the weights in the JAX layout (K, Cin, Cout); it takes
// the shapes outside the rule above (Cin not a multiple of 16, stride > 2).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

struct int8_conv_kernel {};  // names the kernel: int8mma::tiled_kernel<int8_conv_kernel, ...>

// Launches the mma.sync loop on `stream`; returns the CUDA error code (0 = launched).
// All tensors contiguous; w is (K, Cin, Cout).
extern "C" int int8_conv1d(const int8_t* x, const int8_t* w, int32_t* out, int B, int T_in,
                           int T_out, int Cin, int Cout, int K, int stride, int dilation,
                           int pad, void* stream_ptr) {
  int8mma::Conv p{x, w, out, B, T_in, T_out, Cin, Cout, K, stride, dilation, pad};
  return (int)int8mma::launch_tiled<int8_conv_kernel>(p, (cudaStream_t)stream_ptr);
}

namespace int8_conv_wgmma {

// ops/int8.py reads BM, MAX_STRIDE and MAX_HALO from these lines for its copy
// of the shape rule (int8_conv1d_wgmma_fits below)
constexpr int BM = 128;            // output rows (times of one utterance) per block
constexpr int BK = 128;            // channels per chunk: one 128-byte swizzle row of w
constexpr int STAGES = 4;          // weight stages in flight
constexpr int THREADS = 384;       // warpgroup 0 produces, warpgroups 1-2 consume
constexpr int CONSUMERS = 256;     // arrivals that release a stage
constexpr int MAX_STRIDE = 2;      // one x tensor map per input-time parity
constexpr int MAX_HALO = 256;      // rows of one TMA box
constexpr int SMEM_LIMIT = 232448; // dynamic shared memory a block may have

// error codes besides CUDA's (which are positive)
constexpr int ERR_ENTRY_POINT = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;       // a tensor map could not be encoded
constexpr int ERR_SHAPE = -3;        // a shape or pointer outside the kernel's rule

struct Params {
  int32_t* out;
  int T_out, Cin, Cout, K, stride, dilation, pad;
  int lo;      // first halo row, in parity-map rows, relative to the tile's first output time
  int R;       // halo rows per parity (a multiple of 8)
  int chunks;  // ceil(Cin / BK)
};

__host__ __device__ inline int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The halo of a tile: parity-map rows lo .. lo + R - 1 past its first output time.
__host__ __device__ inline void halo_of(int K, int stride, int dilation, int pad, int* lo,
                                        int* R) {
  *lo = floor_div(-pad - (stride - 1), stride);
  const int hi = floor_div((K - 1) * dilation - pad, stride);
  *R = (BM + hi - *lo + 7) / 8 * 8;
}

// 1024 bytes of alignment slack, the weight ring, two halo buffers (one per
// channel chunk in flight) of `stride` parities x 8 pieces x R rows x 16
// bytes, and the mbarriers
__host__ __device__ constexpr int smem_bytes(int BN, int stride, int R) {
  return 1024 + STAGES * BN * BK + 2 * stride * 8 * R * 16 + (2 * STAGES + 4) * 8;
}
// so the shape rule needs no shared-memory term: every halo it takes fits
static_assert(smem_bytes(192, MAX_STRIDE, MAX_HALO) <= SMEM_LIMIT, "halo past shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits for the barrier's phase `parity` to complete. A pipeline that never
// completes it traps (a launch failure the wrapper reports) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading (K-direction)
// and stride (8-row group) byte offsets, layout 0 = unswizzled, 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// m64nNk32 s8 x s8 -> s32, A and B from shared memory (both K-major), d += A B.
__device__ __forceinline__ void mma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n192(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void mma<128>(int (&d)[64], uint64_t da, uint64_t db) {
  mma_n128(d, da, db);
}
template <>
__device__ __forceinline__ void mma<192>(int (&d)[96], uint64_t da, uint64_t db) {
  mma_n192(d, da, db);
}

// grid: (row tiles of T_out, column tiles of Cout, B). xmap0/xmap1: x by
// input-time parity, 16-byte x R-row boxes, unswizzled. wmap: packed w
// (K, Cout, Cin), 128 x BN boxes, 128-byte swizzle.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap0,
           const __grid_constant__ CUtensorMap xmap1, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int W_STAGE = BN * BK;
  uint8_t* ws = smem;                                // STAGES x [BN rows][128 bytes], swizzled
  uint8_t* xs = ws + STAGES * W_STAGE;               // 2 x [parity][piece][R rows][16 bytes]
  const int x_bytes = 2 * p.stride * 8 * p.R * 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + x_bytes);
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;
  uint64_t* xempty = xfull + 2;

  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  // warp-uniform, so that the compiler sees each warpgroup take one path
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread starts every TMA load ----
    if (threadIdx.x != 0) return;
    const int R = p.R, s = p.stride;
    auto load_halo = [&](int c) {
      const int buf = c & 1;
      mbar_wait(&xempty[buf], ((c >> 1) & 1) ^ 1);
      // 16-byte channel pieces that hold channels < Cin; the rest stay stale
      // and meet weights that TMA filled with zeros
      const int pieces = min(8, (p.Cin - c * BK + 15) / 16);
      mbar_expect_tx(&xfull[buf], (uint32_t)(s * pieces * R * 16));
      for (int q = 0; q < s; ++q)
        for (int cc = 0; cc < pieces; ++cc)
          tma_load_3d(xs + ((size_t)(buf * s + q) * 8 + cc) * R * 16, q ? &xmap1 : &xmap0,
                      &xfull[buf], c * BK + cc * 16, t0 + p.lo, b);
    };
    load_halo(0);
    const int k_next_halo = min(p.K - 1, STAGES - 1);
    int st = 0;
    uint32_t ph = 0;
    for (int c = 0; c < p.chunks; ++c) {
      for (int k = 0; k < p.K; ++k) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], W_STAGE);
        tma_load_3d(ws + st * W_STAGE, &wmap, &full[st], c * BK, n0, k);
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
        // the next chunk's halo, once the consumers are past this chunk's
        // first tap (so its buffer's last reader, chunk c - 1, is done)
        if (k == k_next_halo && c + 1 < p.chunks) load_halo(c + 1);
      }
    }
  } else {
    // ---- consumers: warpgroups 1 and 2, rows (wg - 1) * 64 .. + 63 of the tile ----
    const int wrow = (wg - 1) * 64;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const uint32_t ws_base = smem_u32(ws), xs_base = smem_u32(xs);
    const int R = p.R, s = p.stride;
    int st = 0, prev_st = -1, prev_x = -1;
    uint32_t ph = 0;
    for (int c = 0; c < p.chunks; ++c) {
      const int buf = c & 1;
      mbar_wait(&xfull[buf], (c >> 1) & 1);
      for (int k = 0; k < p.K; ++k) {
        mbar_wait(&full[st], ph);
        const int off = k * p.dilation - p.pad;
        const int q = ((off % s) + s) % s;
        const int j0 = (off - q) / s - p.lo;  // the tap's shift into the halo
        const uint64_t da =
            make_desc(xs_base + ((buf * s + q) * 8 * R + j0 + wrow) * 16, R * 16, 128, 0);
        const uint64_t db = make_desc(ws_base + st * W_STAGE, 16, 1024, 1);
        wgmma_fence();
        // all 4 k32 steps of the chunk, with no branch around a wgmma: channels
        // past Cin meet weights that TMA filled with zeros. Step j: +32 bytes in
        // a swizzled row, +2 pieces (2*R*16 bytes) in the halo.
#pragma unroll
        for (int j = 0; j < BK / 32; ++j)
          mma<BN>(acc, da + (uint64_t)(2 * j * R), db + (uint64_t)(2 * j));
        wgmma_commit();
        wgmma_wait<1>();  // the previous tap's products are done: release its stage
        if (prev_st >= 0) mbar_arrive(&empty[prev_st]);
        if (prev_x >= 0) {
          mbar_arrive(&xempty[prev_x]);
          prev_x = -1;
        }
        prev_st = st;
        if (k == p.K - 1) prev_x = buf;
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");

    // epilogue: rows past T_out and columns past Cout are masked
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tq = lane & 3;
    int32_t* outb = p.out + (size_t)b * p.T_out * p.Cout;
    const bool pairs = (p.Cout & 1) == 0;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wrow + 16 * warp + g + 8 * h;
        if (t >= p.T_out || n >= p.Cout) continue;
        int32_t* dst = outb + (size_t)t * p.Cout + n;
        const int v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        } else {
          dst[0] = v0;
          if (n + 1 < p.Cout) dst[1] = v1;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the CUDA runtime hands out
// its entry point, so this source links no -lcuda.
static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D int8 tensor map (dims innermost first) with the given box and swizzle.
static bool encode(EncodeTiled enc, CUtensorMap* map, const void* base, cuuint64_t d0,
                   cuuint64_t d1, cuuint64_t d2, cuuint64_t stride1, cuuint64_t stride2,
                   cuuint32_t box0, cuuint32_t box1, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// BN with the fewest rounds of one block per SM, times BN (the work a round
// gives each SM); ties go to 128, which wastes fewer columns.
static int pick_bn(int B, int T_out, int Cout) {
  const long long rows = (long long)B * ((T_out + BM - 1) / BM), sms = num_sms();
  const int candidates[2] = {128, 192};
  int best = 128;
  long long best_cost = -1;
  for (int bn : candidates) {
    const long long blocks = rows * ((Cout + bn - 1) / bn);
    const long long cost = (blocks + sms - 1) / sms * bn;
    if (best_cost < 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

template <int BN>
static int launch(const CUtensorMap& wmap, const CUtensorMap& x0, const CUtensorMap& x1,
                  const Params& p, int B, int smem, cudaStream_t stream) {
  // the attribute once per instantiation and device, to the most any shape needs
  static unsigned long long sized = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 63) & 1ull)) {
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&kernel<BN>),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    sized |= 1ull << (dev & 63);
  }
  const dim3 grid((unsigned)((p.T_out + BM - 1) / BM), (unsigned)((p.Cout + BN - 1) / BN),
                  (unsigned)B);
  kernel<BN><<<grid, THREADS, smem, stream>>>(wmap, x0, x1, p);
  return (int)cudaGetLastError();
}

}  // namespace int8_conv_wgmma

// 1 if int8_conv1d_wgmma takes the shape (ops/int8.py wgmma_conv_fits is the same rule).
extern "C" int int8_conv1d_wgmma_fits(int T_in, int Cin, int K, int stride, int dilation) {
  using namespace int8_conv_wgmma;
  if (Cin < 16 || Cin % 16 != 0 || K < 1 || stride < 1 || stride > MAX_STRIDE ||
      dilation < 1 || T_in < stride)
    return 0;
  int lo, R;
  halo_of(K, stride, dilation, dilation * K / 2, &lo, &R);
  return R <= MAX_HALO;
}

// The BN the launcher picks for the shape (for logs).
extern "C" int int8_conv1d_wgmma_bn(int B, int T_out, int Cout) {
  return int8_conv_wgmma::pick_bn(B, T_out, Cout);
}

// Launches the wgmma conv on `stream`; w_packed is (K, Cout, Cin), x and w
// 16-byte aligned and contiguous. Returns 0 when launched, a CUDA error code,
// or a negative code of int8_conv_wgmma (entry point missing, tensor map not
// encoded, shape outside the rule).
extern "C" int int8_conv1d_wgmma(const int8_t* x, const int8_t* w_packed, int32_t* out, int B,
                                 int T_in, int T_out, int Cin, int Cout, int K, int stride,
                                 int dilation, int pad, void* stream_ptr) {
  using namespace int8_conv_wgmma;
  if (!int8_conv1d_wgmma_fits(T_in, Cin, K, stride, dilation) || pad != dilation * K / 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w_packed) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return ERR_SHAPE;
  EncodeTiled enc = encoder();
  if (!enc) return ERR_ENTRY_POINT;
  Params p{out, T_out, Cin, Cout, K, stride, dilation, pad, 0, 0, (Cin + BK - 1) / BK};
  halo_of(K, stride, dilation, pad, &p.lo, &p.R);
  const int BN = pick_bn(B, T_out, Cout);
  CUtensorMap wmap, xmap[MAX_STRIDE];
  bool ok = encode(enc, &wmap, w_packed, Cin, Cout, K, (cuuint64_t)Cin, (cuuint64_t)Cout * Cin,
                   BK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  for (int q = 0; q < stride; ++q) {
    const cuuint64_t rows = (cuuint64_t)((T_in - q + stride - 1) / stride);
    ok = ok && encode(enc, &xmap[q], x + (size_t)q * Cin, Cin, rows, B, (cuuint64_t)stride * Cin,
                      (cuuint64_t)T_in * Cin, 16, p.R, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return ERR_ENCODE;
  if (stride == 1) xmap[1] = xmap[0];  // unused: the kernel takes two maps
  const int smem = smem_bytes(BN, stride, p.R);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (BN == 128) return launch<128>(wmap, xmap[0], xmap[1], p, B, smem, stream);
  return launch<192>(wmap, xmap[0], xmap[1], p, B, smem, stream);
}
