// Device helpers shared by the CTC loss kernels over the blank-interleaved
// lattice: csrc/ctc_loss.cu (K1, time-chunked counterpart) and
// csrc/ctc_loss_whole_t.cu (K2, whole-T counterpart). One thread block owns
// one utterance row; each thread owns the states tid, tid + nt, ... of its
// row (K of them, K a power of two).
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

}  // namespace
