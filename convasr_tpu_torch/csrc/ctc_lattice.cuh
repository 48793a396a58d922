// Device helpers shared by the kernels over the blank-interleaved CTC
// lattice: csrc/ctc_loss.cu (K1, time-chunked counterpart),
// csrc/ctc_loss_whole_t.cu (K2, whole-T counterpart) and csrc/ctc_viterbi.cu
// (K3). In the block kernels one thread block owns one utterance row; each
// thread owns the states tid, tid + nt, ... of its row (K of them, K a power
// of two).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define NEG_INF (-1e30f)

namespace {

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (m <= NEG_INF / 2) return NEG_INF;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

// Per-thread lattice description: the class of each owned state, whether it
// lies inside the row's own lattice (s < 2*ylen+1), and its skip flag; in the
// backward pass the skip flag of state s+2 instead.
template <int K>
struct Lattice {
  int ext[K];
  unsigned row_bits = 0, skip_bits = 0;

  __device__ void load(const int* tg, int S, int C, int blank, int yl, int tid, int nt,
                       bool skip_of_next2) {
    const int s_row = 2 * yl + 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      ext[k] = blank;
      if (s < S && (s & 1)) ext[k] = min(max(tg[s >> 1], 0), C - 1);
      if (s < s_row) row_bits |= 1u << k;
      // skip of state q (q odd, q >= 3): its label differs from that of q-2
      const int q = skip_of_next2 ? s + 2 : s;
      if (q < S && (q & 1) && q >= 3) {
        const int lab = min(max(tg[q >> 1], 0), C - 1);
        if (lab != min(max(tg[(q >> 1) - 1], 0), C - 1)) skip_bits |= 1u << k;
      }
    }
  }
};

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// threads a block and states a thread for a lattice of S states
int block_threads(int S) { return min((S + 31) / 32 * 32, 1024); }
int states_per_thread(int S) {
  const int per = (S + block_threads(S) - 1) / block_threads(S);
  for (int k = 1; k <= 32; k *= 2)
    if (per <= k) return k;
  return 0;
}

// launch(std::integral_constant<int, K>()) with K = states_per_thread(S);
// cudaErrorInvalidValue for a lattice of more than 32 * 1024 states
template <typename Launch>
cudaError_t with_states_per_thread(int S, Launch launch) {
  switch (states_per_thread(S)) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    default: return cudaErrorInvalidValue;
  }
}

// Copies ahead, shared by the kernels that walk a row's frames in chunks
// (csrc/ctc_loss.cu's forward and warp backward, csrc/ctc_viterbi.cu's warp
// kernel): 16-byte cp.async pieces from the chunk's start rounded down to 16
// bytes, the last piece cut by its source size, so no layout is padded.
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The 4-byte word (0-3) of a 16-byte piece at which p lies.
__device__ __forceinline__ int lead(const float* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) >> 2 & 3);
}

// Threads i, i + stride, ... copy the n floats at src into dst (16-byte
// aligned) by cp.async of 16-byte pieces, the first from src rounded down to
// 16 bytes (the caller's tensor starts on 16 bytes), the last reading no
// further than src + n; src's first float lands at dst + lead(src).
__device__ __forceinline__ void copy_ahead(float* dst, const float* src, int n, int i,
                                           int stride) {
  const int off = lead(src);
  const char* base = reinterpret_cast<const char*>(src - off);
  const int bytes = 4 * (off + n);
  for (int q = i; 16 * q < bytes; q += stride)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst + 4 * q)),
                 "l"(base + 16 * q), "r"(min(16, bytes - 16 * q))
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until this thread's copies, all but the newest N groups, have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// p ? a : b as one select instruction (a ternary that picks between
// registers by lane may be compiled into a branch)
__device__ __forceinline__ float pick(bool p, float a, float b) {
  float y;
  asm("{\n .reg .pred q;\n setp.ne.s32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(y)
      : "f"(a), "f"(b), "r"((int)p));
  return y;
}

// floats of a chunk buffer of n floats copied from any 4-byte boundary
__host__ __device__ inline int area(int n) { return (n + 6) / 4 * 4; }

}  // namespace
