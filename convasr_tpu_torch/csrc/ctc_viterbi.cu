// CTC Viterbi forced alignment for Hopper (sm_90a).
//
// Replaces the TPU kernel convasr_tpu/ops/align_pallas.py:28 (_viterbi_kernel)
// together with the backtrace and char-frame pick that the JAX package runs
// outside it (align_pallas.py:92-125). Plain-PyTorch counterpart, and the
// kernel's oracle: convasr_tpu_torch/ops/ctc.py (ctc_alignment).
//
// What it computes, per utterance row b, over the blank-interleaved lattice of
// S = 2L+1 states:
//   alpha_0[s] = E_0[s] for s <= 1, else -1e30
//   alpha_t[s] = max(max(alpha[s], alpha[s-1], skip[s] ? alpha[s-2] : -1e30)
//                    + E_t[s], -1e30)                         for 0 < t < xlen
//   bp[t][s]   = 0 stay, 1 from s-1, 2 from s-2; strict '>' in that order, so
//                ties keep the lower move (the JAX argmax's first maximum)
// with E_t[s] = log_probs[b, t, ext[s]] for s < 2*ylen+1 and -1e30 beyond.
// Rows freeze past xlen, backpointers there are 0, and alpha at frame xlen-1
// is written out as final_alpha. Then the backtrace starts from state 2*ylen-1
// when its final alpha >= that of 2*ylen (2*ylen for empty targets) and
// records, for every char l, the last frame in state 2l+1.
// Only maxima and float32 additions: the result is bit-equal to the oracle.
//
// What bounds it on this card: not bytes and not operations, but the chain of
// T dependent steps. The TPU kernel walked a sequential grid over time chunks
// with the carry in VMEM scratch; here one thread block owns one row and loops
// over time inside the block, with alpha double-buffered in shared memory and
// one __syncthreads() per frame. The emissions are never materialised as a
// (B, T, S) tensor: frame t+1's C-wide log-prob row is staged in shared
// memory while frame t is computed, and each state gathers from it. Each
// thread keeps its states' labels and skip flags in registers. Backpointers
// go to device memory as int8 (a quarter of the JAX int32), one coalesced
// S-byte row per frame. The backtrace is a second kernel, one thread per row,
// so no per-frame launches are made from the host. With one block per row a
// batch of B rows busies B of the 132 SMs; more parallelism over time is work
// for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

// K = states owned by each thread (S <= K * blockDim.x). The launch bound
// caps registers at 64 a thread so that 1024 threads fit an SM's 65,536; the
// labels of K >= 16 states then spill to (L1-cached) local memory.
template <int K>
__global__ void __launch_bounds__(1024)
viterbi_forward(const float* __restrict__ log_probs, const int* __restrict__ targets,
                const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
                int T, int C, int L, int blank, int8_t* __restrict__ bp,
                float* __restrict__ final_alpha) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  float* alpha_buf[2] = {smem, smem + S};
  float* row_buf[2] = {smem + 2 * S, smem + 2 * S + C};

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int xl = min(max(input_lengths[b], 0), T);
  const int yl = min(max(target_lengths[b], 0), L);
  const int s_row = 2 * yl + 1;
  const float* lp = log_probs + (size_t)b * T * C;
  const int* tg = targets + (size_t)b * L;
  int8_t* bp_b = bp + (size_t)b * T * S;

  int ext[K];
  unsigned skip_bits = 0, row_bits = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * nt;
    ext[k] = blank;
    if (s < S && (s & 1)) {
      const int lab = min(max(tg[s >> 1], 0), C - 1);
      ext[k] = lab;
      if (s >= 3 && lab != min(max(tg[(s >> 1) - 1], 0), C - 1)) skip_bits |= 1u << k;
    }
    if (s < s_row) row_bits |= 1u << k;
  }

  if (xl > 0) {
    for (int c = tid; c < C; c += nt) row_buf[0][c] = lp[c];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      if (s < S) {
        const float e = (row_bits >> k & 1) ? row_buf[0][ext[k]] : NEG_INF;
        alpha_buf[0][s] = s <= 1 ? e : NEG_INF;
        bp_b[s] = 0;
      }
    }
    if (xl > 1)
      for (int c = tid; c < C; c += nt) row_buf[1][c] = lp[(size_t)C + c];
    __syncthreads();

    for (int t = 1; t < xl; ++t) {
      const float* a_prev = alpha_buf[(t - 1) & 1];
      float* a_next = alpha_buf[t & 1];
      const float* row = row_buf[t & 1];
      int8_t* bp_t = bp_b + (size_t)t * S;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = tid + k * nt;
        if (s < S) {
          const float stay = a_prev[s];
          const float prev1 = s >= 1 ? a_prev[s - 1] : NEG_INF;
          const float prev2 = (skip_bits >> k & 1) ? a_prev[s - 2] : NEG_INF;
          int best = prev1 > stay ? 1 : 0;
          float val = fmaxf(stay, prev1);
          if (prev2 > val) best = 2;
          val = fmaxf(val, prev2);
          const float e = (row_bits >> k & 1) ? row[ext[k]] : NEG_INF;
          a_next[s] = fmaxf(val + e, NEG_INF);
          bp_t[s] = (int8_t)best;
        }
      }
      if (t + 1 < xl) {
        float* stage = row_buf[(t + 1) & 1];
        const float* src = lp + (size_t)(t + 1) * C;
        for (int c = tid; c < C; c += nt) stage[c] = src[c];
      }
      __syncthreads();
    }
    const float* last = alpha_buf[(xl - 1) & 1];
    for (int s = tid; s < S; s += nt) final_alpha[(size_t)b * S + s] = last[s];
  } else {
    for (int s = tid; s < S; s += nt) final_alpha[(size_t)b * S + s] = NEG_INF;
  }
  // frozen frames: backpointers 0
  const size_t tail = (size_t)(T - xl) * S;
  int8_t* bp_tail = bp_b + (size_t)xl * S;
  for (size_t i = tid; i < tail; i += nt) bp_tail[i] = 0;
}

__global__ void viterbi_backtrace(const int8_t* __restrict__ bp,
                                  const float* __restrict__ final_alpha,
                                  const int* __restrict__ input_lengths,
                                  const int* __restrict__ target_lengths,
                                  int B, int T, int L, int* __restrict__ char_frames) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int S = 2 * L + 1;
  const int xl = min(max(input_lengths[b], 0), T);
  const int yl = min(max(target_lengths[b], 0), L);
  int* frames = char_frames + (size_t)b * L;
  for (int l = 0; l < L; ++l) frames[l] = 0;
  const float* fa = final_alpha + (size_t)b * S;
  const int end1 = 2 * yl - 1, end2 = 2 * yl;
  int state = (yl == 0) ? end2 : (fa[end1] >= fa[end2] ? end1 : end2);
  const int8_t* bp_b = bp + (size_t)b * T * S;
  // walking back, the state never increases: the first frame met in state
  // 2l+1 is the last frame of char l
  int last = -1;
  for (int t = xl - 1; t >= 0; --t) {
    if ((state & 1) && state != last) {
      frames[state >> 1] = t;
      last = state;
    }
    if (t > 0) state -= bp_b[(size_t)t * S + state];
  }
}

template <int K>
cudaError_t launch_forward(const float* log_probs, const int* targets, const int* input_lengths,
                           const int* target_lengths, int B, int T, int C, int L, int blank,
                           int8_t* bp, float* final_alpha, int threads, size_t smem,
                           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(viterbi_forward<K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  viterbi_forward<K><<<B, threads, smem, stream>>>(log_probs, targets, input_lengths,
                                                   target_lengths, T, C, L, blank, bp,
                                                   final_alpha);
  return cudaGetLastError();
}

}  // namespace

// Launches the forward pass and the backtrace on `stream`; returns the CUDA
// error code (0 = launched). Shapes: log_probs (B, T, C) float32, targets
// (B, L) int32, input/target lengths (B,) int32; outputs bp (B, T, 2L+1) int8,
// final_alpha (B, 2L+1) float32, char_frames (B, L) int32. All contiguous.
extern "C" int ctc_viterbi_align(const float* log_probs, const int* targets,
                                 const int* input_lengths, const int* target_lengths,
                                 int B, int T, int C, int L, int blank, int8_t* bp,
                                 float* final_alpha, int* char_frames, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  const int threads = min((S + 31) / 32 * 32, 1024);
  const int per_thread = (S + threads - 1) / threads;
  const size_t smem = (size_t)(2 * S + 2 * C) * sizeof(float);
  cudaError_t err;
  if (per_thread <= 1)
    err = launch_forward<1>(log_probs, targets, input_lengths, target_lengths, B, T, C, L, blank,
                            bp, final_alpha, threads, smem, stream);
  else if (per_thread <= 2)
    err = launch_forward<2>(log_probs, targets, input_lengths, target_lengths, B, T, C, L, blank,
                            bp, final_alpha, threads, smem, stream);
  else if (per_thread <= 4)
    err = launch_forward<4>(log_probs, targets, input_lengths, target_lengths, B, T, C, L, blank,
                            bp, final_alpha, threads, smem, stream);
  else if (per_thread <= 8)
    err = launch_forward<8>(log_probs, targets, input_lengths, target_lengths, B, T, C, L, blank,
                            bp, final_alpha, threads, smem, stream);
  else if (per_thread <= 16)
    err = launch_forward<16>(log_probs, targets, input_lengths, target_lengths, B, T, C, L, blank,
                             bp, final_alpha, threads, smem, stream);
  else if (per_thread <= 32)
    err = launch_forward<32>(log_probs, targets, input_lengths, target_lengths, B, T, C, L, blank,
                             bp, final_alpha, threads, smem, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  if (L > 0) {
    viterbi_backtrace<<<(B + 127) / 128, 128, 0, stream>>>(bp, final_alpha, input_lengths,
                                                           target_lengths, B, T, L, char_frames);
    err = cudaGetLastError();
  }
  return (int)err;
}
