// The int8 tensor-core tile loop shared by csrc/int8_conv.cu and
// csrc/int8_gemm.cu (sm_80 and later; built here for sm_90a).
//
// Both kernels compute one implicit GEMM: a channels-last 1-D convolution
//   out[b, t, co] = sum_{k, ci} x[b, t*stride - pad + k*dilation, ci] * w[k, ci, co]
// with int8 operands and exact int32 sums; a plain GEMM is the same thing with
// one tap, stride 1 and no padding (B = 1, T = M rows, Cin = K, Cout = N).
// Rows of the GEMM are output positions (b, t), columns output channels, and
// the contraction walks (tap, input channel) in stages of BK channels of one
// tap. Time positions outside [0, T_in) and channels past Cin load as zeros,
// so the padding is never materialised and ragged edges are exact.
//
// A block owns a BM x BN output tile and runs 4 warps, each on a 32 x 32 part
// of it, as 2 x 4 tiles of mma.sync.m16n8k32 (s8 x s8 -> s32). A stage of
// x rows is staged in shared memory as [row][channel] and a stage of w as
// [out channel][channel] (transposed while staging, 4 x 4 bytes at a time with
// byte permutes), so every fragment is one 32-bit shared load. Rows carry 16
// bytes of padding, which makes the fragment loads free of bank conflicts.
// Vector paths (16-byte x loads, 4-byte w loads) need Cin % 16 == 0 and
// Cout % 4 == 0 with aligned pointers; other shapes take byte loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int8mma {

constexpr int BM = 64;        // output rows (b, t) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 64;        // contraction bytes per stage
constexpr int THREADS = 128;  // 4 warps as 2 x 2, each a 32 x 32 part of the tile
constexpr int ROW_PAD = 16;   // bytes of padding per shared-memory row

struct Conv {
  const int8_t* x;  // (B, T_in, Cin), contiguous
  const int8_t* w;  // (taps, Cin, Cout) = (taps * Cin, Cout) row-major, contiguous
  int32_t* out;     // (B, T_out, Cout), contiguous
  int B, T_in, T_out, Cin, Cout, taps, stride, dilation, pad;

  __host__ __device__ int chunks() const { return (Cin + BK - 1) / BK; }
  __host__ __device__ int steps() const { return taps * chunks(); }
  __host__ __device__ int rows() const { return B * T_out; }
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t byte_at(const int8_t* p) {
  return (uint32_t)(uint8_t)(*p);
}

// Transposes a 4 x 4 block of bytes: in w[j] byte i is (row j, column i); out
// o[i] byte j is the same element.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&o)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// One thread's share of a stage: 8 words of x rows and 8 words of w, loaded
// from device memory into registers (so the next stage's loads can be in
// flight while the current one is computed) and then stored to shared memory.
// VA: 16-byte x loads (2 rows x 16 bytes a thread); else 8 rows x 4 bytes.
// VB: 4-byte w loads of 4 x 4 blocks (2 blocks a thread); else bytes.
template <bool VA, bool VB>
struct Stager {
  static constexpr int NROWS = VA ? 2 : 8;
  const int8_t* row_base[NROWS];  // x + b * T_in * Cin; nullptr past the last row
  int row_t0[NROWS];              // t * stride - pad
  uint32_t a[8], b[8];
  int n0;

  __device__ Stager(const Conv& p, int m0, int n0_) : n0(n0_) {
    const int tid = threadIdx.x;
    const int M = p.rows();
#pragma unroll
    for (int i = 0; i < NROWS; ++i) {
      const int row = VA ? tid / 4 + 32 * i : tid / 16 + 8 * i;
      const int m = m0 + row;
      if (m < M) {
        const int bb = m / p.T_out, t = m - bb * p.T_out;
        row_base[i] = p.x + (size_t)bb * p.T_in * p.Cin;
        row_t0[i] = t * p.stride - p.pad;
      } else {
        row_base[i] = nullptr;
        row_t0[i] = 0;
      }
    }
  }

  __device__ void load(const Conv& p, int step) {
    const int tid = threadIdx.x;
    const int chunks = p.chunks();
    const int tap = step / chunks;
    const int ci0 = (step - tap * chunks) * BK;
    const int shift = tap * p.dilation;
    // x rows
#pragma unroll
    for (int i = 0; i < NROWS; ++i) {
      const int tin = row_t0[i] + shift;
      const bool row_ok = row_base[i] != nullptr && tin >= 0 && tin < p.T_in;
      if constexpr (VA) {
        const int ci = ci0 + (tid % 4) * 16;
        int4 v = make_int4(0, 0, 0, 0);
        if (row_ok && ci < p.Cin)
          v = __ldg(reinterpret_cast<const int4*>(row_base[i] + (size_t)tin * p.Cin + ci));
        a[4 * i + 0] = (uint32_t)v.x;
        a[4 * i + 1] = (uint32_t)v.y;
        a[4 * i + 2] = (uint32_t)v.z;
        a[4 * i + 3] = (uint32_t)v.w;
      } else {
        const int ci = ci0 + (tid % 16) * 4;
        uint32_t word = 0;
        if (row_ok) {
          const int8_t* src = row_base[i] + (size_t)tin * p.Cin;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ci + j < p.Cin) word |= byte_at(src + ci + j) << (8 * j);
        }
        a[i] = word;
      }
    }
    // w: contraction rows tap * Cin + ci0 + k, columns n0 + n
    const int8_t* wk = p.w + ((size_t)tap * p.Cin + ci0) * p.Cout;
    if constexpr (VB) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + THREADS * i;
        const int kb = (q / 16) * 4, n = n0 + (q % 16) * 4;
        uint32_t w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* src = wk + (size_t)(kb + j) * p.Cout + n;
          w4[j] = (ci0 + kb + j < p.Cin && n < p.Cout)
                      ? __ldg(reinterpret_cast<const unsigned int*>(src)) : 0u;
        }
        uint32_t o[4];
        transpose4x4(w4, o);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[4 * i + j] = o[j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = tid + THREADS * i;
        const int n = n0 + q / 16, k4 = (q % 16) * 4;
        uint32_t word = 0;
        if (n < p.Cout) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ci0 + k4 + j < p.Cin)
              word |= byte_at(wk + (size_t)(k4 + j) * p.Cout + n) << (8 * j);
        }
        b[i] = word;
      }
    }
  }

  // Stores the stage at byte column `col` of the [row][lda] x tile and the
  // [out channel][ldb] w tile.
  __device__ void store(int8_t* As, int8_t* Bs, int lda, int ldb, int col) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < NROWS; ++i) {
      if constexpr (VA) {
        const int row = tid / 4 + 32 * i;
        *reinterpret_cast<uint4*>(As + row * lda + col + (tid % 4) * 16) =
            make_uint4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
      } else {
        const int row = tid / 16 + 8 * i;
        *reinterpret_cast<uint32_t*>(As + row * lda + col + (tid % 16) * 4) = a[i];
      }
    }
    if constexpr (VB) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + THREADS * i;
        const int kb = (q / 16) * 4, nb = (q % 16) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(Bs + (nb + j) * ldb + col + kb) = b[4 * i + j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = tid + THREADS * i;
        *reinterpret_cast<uint32_t*>(Bs + (q / 16) * ldb + col + (q % 16) * 4) = b[i];
      }
    }
  }
};

// acc += the (BM x BN) product of nk32 32-byte slices of the staged tiles,
// starting at byte column col0.
__device__ __forceinline__ void compute(const int8_t* As, const int8_t* Bs, int lda, int ldb,
                                        int col0, int nk32, int (&acc)[2][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  for (int kk = 0; kk < nk32; ++kk) {
    const int off = col0 + kk * 32 + t * 4;
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* r0 = As + (wm + mi * 16 + g) * lda + off;
      const int8_t* r1 = r0 + 8 * lda;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(r1);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* c = Bs + (wn + ni * 8 + g) * ldb + off;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(c);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(c + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
  }
}

// Writes the block's accumulators to out (rows x N int32), masking the edges.
__device__ __forceinline__ void store_out(int32_t* out, int rows, int N, int m0, int n0,
                                          const int (&acc)[2][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + 8 * h;
        const int n = n0 + wn + ni * 8 + 2 * t;
        if (m >= rows) continue;
        int32_t* dst = out + (size_t)m * N + n;
        if (n < N) dst[0] = acc[mi][ni][2 * h];
        if (n + 1 < N) dst[1] = acc[mi][ni][2 * h + 1];
      }
}

// The K-tiled loop: stages stream through one shared-memory tile; the next
// stage's device loads are issued before the current stage is computed, and
// the int32 accumulators stay in registers across stages. Name is an empty
// struct of the including source that names the kernel in a profile.
template <typename Name, bool VA, bool VB>
__global__ void __launch_bounds__(THREADS) tiled_kernel(Conv p) {
  constexpr int LD = BK + ROW_PAD;
  __shared__ __align__(16) int8_t As[BM * LD];
  __shared__ __align__(16) int8_t Bs[BN * LD];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  Stager<VA, VB> st(p, m0, n0);
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;
  const int steps = p.steps();
  if (steps > 0) st.load(p, 0);
  for (int s = 0; s < steps; ++s) {
    st.store(As, Bs, LD, LD, 0);
    __syncthreads();
    if (s + 1 < steps) st.load(p, s + 1);
    compute(As, Bs, LD, LD, 0, BK / 32, acc);
    __syncthreads();
  }
  store_out(p.out, p.rows(), p.Cout, m0, n0, acc);
}

inline bool vector_x(const Conv& p) {
  return p.Cin % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
}

inline bool vector_w(const Conv& p) {
  return p.Cout % 4 == 0 && reinterpret_cast<uintptr_t>(p.w) % 4 == 0;
}

inline dim3 grid_of(const Conv& p) {
  return dim3((unsigned)((p.rows() + BM - 1) / BM), (unsigned)((p.Cout + BN - 1) / BN));
}

template <typename Name>
cudaError_t launch_tiled(const Conv& p, cudaStream_t stream) {
  const dim3 grid = grid_of(p);
  const bool va = vector_x(p), vb = vector_w(p);
  if (va && vb) tiled_kernel<Name, true, true><<<grid, THREADS, 0, stream>>>(p);
  else if (va) tiled_kernel<Name, true, false><<<grid, THREADS, 0, stream>>>(p);
  else if (vb) tiled_kernel<Name, false, true><<<grid, THREADS, 0, stream>>>(p);
  else tiled_kernel<Name, false, false><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace int8mma
