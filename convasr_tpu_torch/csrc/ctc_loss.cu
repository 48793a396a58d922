// CTC loss forward (alpha) and backward (beta + gradient) for Hopper (sm_90a).
//
// Replaces the TPU kernels convasr_tpu/ops/ctc_pallas_v2.py:36 (_alpha_kernel)
// and :63 (_beta_grad_kernel), together with what the JAX package runs around
// them: the emission gather of ops/ctc_pallas.py:118-137 (_prepare), the final
// log-likelihood of :196-203 (_final_ll) and the one-hot scatter back to the
// classes of ctc_pallas_v2.py:181-189 (_bwd). Plain-PyTorch counterparts, and
// the kernels' oracles: convasr_tpu_torch/ops/ctc_loss.py (alpha_plain,
// beta_grad_plain).
//
// What they compute, per utterance row b, over the blank-interleaved lattice
// of S = 2L+1 states (ext[s] = blank for even s, targets[b, s/2] for odd s):
//   E_t[s]     = log_probs[b, t, ext[s]] for s < 2*ylen+1, else -1e30
//   skip[s]    = s >= 2 and ext[s] != ext[s-2]   (never true for a blank state)
//   alpha_0[s] = E_0[s] for s <= 1, else -1e30
//   alpha_t[s] = max(lse(alpha[s], alpha[s-1], skip[s] ? alpha[s-2] : -1e30)
//                    + E_t[s], -1e30)                          for 0 < t < xlen
//   ll         = lse(alpha_{xlen-1}[2*ylen-1], alpha_{xlen-1}[2*ylen])
// where lse(...) is -1e30 when its largest argument is <= -5e29. Frames past
// xlen repeat the last alpha; a row with xlen = 0 keeps -1e30 everywhere
// (then ll = -1e30 and the wrapper reports +inf, as the TPU kernel does).
// Backward, walking t from xlen-1 down to 0 with beta re-initialised at
// t = xlen-1 (0 on the two end states, -1e30 elsewhere):
//   gamma_t[s] = exp(clip(alpha_t[s] + beta_t[s] - ll, -80, 80))
//   grad[b, t, c] = scale_b * sum_{s : ext[s] = c} gamma_t[s]
//   beta_{t-1}[s] = max(lse(beta[s] + E_t[s], beta[s+1] + E_t[s+1],
//                           skip[s+2] ? beta[s+2] + E_t[s+2] : -1e30), -1e30)
// with scale_b = -g[b] for a feasible row (ll > -5e29) and 0 otherwise, and
// grad = 0 on frames past xlen. The clip is kept: an unreachable state still
// adds exp(-80) to its class, as in the JAX package.
//
// What bounds them on this card. Bytes (the least traffic the work needs):
// the valid log-prob frames read once by each kernel, the gradient written
// once; alpha is an intermediate between the two, as the Viterbi
// kernel's backpointers were. Operations: about 4 transcendentals and 8 other
// float32 operations per state and valid frame in each direction. Both are far
// below what the card moves or computes in the time the kernels take: what
// bounds them is the chain of T dependent steps, each a round trip through
// shared memory, with one block per row busying B of the 132 SMs (the Viterbi
// kernel measured 0.63 us a frame at B=8).
//
// What the design does about it. One thread block owns one row and loops over
// time inside the block, in place of the TPU's sequential grid of time chunks
// and its VMEM carry. Alpha (or beta) lives in shared memory; each thread
// keeps its states' labels and skip flags in registers. No (B, T, S)
// emission tensor exists: each state gathers from the frame's C-wide log-prob
// row, staged in shared memory. The backward pass forms gamma and scatters it
// straight into a C-wide gradient row in shared memory, so neither the
// (B, T, S) dE tensor nor the one-hot product of the JAX path exists. Several
// states share a class (the blank; repeated labels): the blank's L+1 states
// are summed by a warp shuffle and one shared-memory atomicAdd per warp, label
// states add with a shared-memory atomicAdd each. The order of those float
// additions varies from run to run, so the gradient agrees with the plain
// version to float32 rounding of a sum of at most L+1 terms in [0, 1], not bit
// for bit (ops/ctc_loss.py states the tolerance). More rows per block, a warp
// per row and TMA staging are later work.
#include "ctc_lattice.cuh"

namespace {

// K = states owned by each thread (S <= K * blockDim.x). The launch bound caps
// registers at 64 a thread so that 1024 threads fit an SM's 65,536.
template <int K>
__global__ void __launch_bounds__(1024)
ctc_alpha(const float* __restrict__ log_probs, const int* __restrict__ targets,
          const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
          int T, int C, int L, int blank, float* __restrict__ alpha, float* __restrict__ ll) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  float* alpha_buf[2] = {smem, smem + S};
  float* row_buf[2] = {smem + 2 * S, smem + 2 * S + C};

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int xl = min(max(input_lengths[b], 0), T);
  const int yl = min(max(target_lengths[b], 0), L);
  const float* lp = log_probs + (size_t)b * T * C;
  float* alpha_b = alpha + (size_t)b * T * S;

  Lattice<K> lat;
  lat.load(targets + (size_t)b * L, S, C, blank, yl, tid, nt, false);

  if (xl == 0) {
    for (size_t i = tid; i < (size_t)T * S; i += nt) alpha_b[i] = NEG_INF;
    if (tid == 0) ll[b] = NEG_INF;
    return;
  }

  for (int c = tid; c < C; c += nt) row_buf[0][c] = lp[c];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * nt;
    if (s < S) {
      const float e = (lat.row_bits >> k & 1) ? row_buf[0][lat.ext[k]] : NEG_INF;
      const float a = s <= 1 ? e : NEG_INF;
      alpha_buf[0][s] = a;
      alpha_b[s] = a;
    }
  }
  if (xl > 1)
    for (int c = tid; c < C; c += nt) row_buf[1][c] = lp[(size_t)C + c];
  __syncthreads();

  for (int t = 1; t < xl; ++t) {
    const float* a_prev = alpha_buf[(t - 1) & 1];
    float* a_next = alpha_buf[t & 1];
    const float* row = row_buf[t & 1];
    float* out = alpha_b + (size_t)t * S;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      if (s < S) {
        const float stay = a_prev[s];
        const float prev1 = s >= 1 ? a_prev[s - 1] : NEG_INF;
        const float prev2 = (lat.skip_bits >> k & 1) ? a_prev[s - 2] : NEG_INF;
        const float e = (lat.row_bits >> k & 1) ? row[lat.ext[k]] : NEG_INF;
        const float a = fmaxf(lse3(stay, prev1, prev2) + e, NEG_INF);
        a_next[s] = a;
        out[s] = a;
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
  // frozen frames repeat the last alpha
  for (size_t i = tid; i < (size_t)(T - xl) * S; i += nt)
    alpha_b[(size_t)xl * S + i] = last[i % S];
  if (tid == 0) {
    const float a1 = yl > 0 ? last[2 * yl - 1] : NEG_INF;
    const float a2 = last[2 * yl];
    const float m = fmaxf(a1, a2);
    ll[b] = m <= NEG_INF / 2 ? NEG_INF : m + logf(expf(a1 - m) + expf(a2 - m));
  }
}

template <int K>
__global__ void __launch_bounds__(1024)
ctc_beta_grad(const float* __restrict__ log_probs, const int* __restrict__ targets,
              const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
              const float* __restrict__ alpha, const float* __restrict__ ll,
              const float* __restrict__ g, int T, int C, int L, int blank,
              float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  float* beta = smem;
  float* bterm = smem + S;
  float* row = smem + 2 * S;
  float* grow = smem + 2 * S + C;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int xl = min(max(input_lengths[b], 0), T);
  const int yl = min(max(target_lengths[b], 0), L);
  const float ll_b = ll[b];
  const bool feasible = ll_b > NEG_INF / 2;
  const float scale = -g[b];
  const float* lp = log_probs + (size_t)b * T * C;
  const float* alpha_b = alpha + (size_t)b * T * S;
  float* out = grad + (size_t)b * T * C;

  // frames past xlen, and every frame of an infeasible row, get 0
  const int live = feasible ? xl : 0;
  for (size_t i = tid; i < (size_t)(T - live) * C; i += nt) out[(size_t)live * C + i] = 0.0f;
  if (live == 0) return;

  Lattice<K> lat;
  lat.load(targets + (size_t)b * L, S, C, blank, yl, tid, nt, true);
  // a thread's states share the parity of its index (blockDim.x is a multiple
  // of 32): even threads hold only blank states, odd threads only labels
  const bool blank_thread = (tid & 1) == 0;

  // each thread holds its states' alpha of the current frame in registers,
  // loaded one frame ahead so the load overlaps the frame's second barrier
  float a_reg[K];
  const int end1 = 2 * yl - 1, end2 = 2 * yl;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * nt;
    a_reg[k] = s < S ? alpha_b[(size_t)(xl - 1) * S + s] : 0.0f;
    if (s < S) beta[s] = (s == end1 || s == end2) ? 0.0f : NEG_INF;
  }
  for (int c = tid; c < C; c += nt) {
    row[c] = lp[(size_t)(xl - 1) * C + c];
    grow[c] = 0.0f;
  }
  __syncthreads();

  for (int t = xl - 1; t >= 0; --t) {
    float blank_sum = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      if (s < S) {
        const float bs = beta[s];
        const float gam = expf(fminf(fmaxf(a_reg[k] + bs - ll_b, -80.0f), 80.0f));
        if (blank_thread)
          blank_sum += gam;
        else
          atomicAdd(&grow[lat.ext[k]], gam);
        const float e = (lat.row_bits >> k & 1) ? row[lat.ext[k]] : NEG_INF;
        bterm[s] = bs + e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) blank_sum += __shfl_xor_sync(0xffffffffu, blank_sum, off);
    if (lane == 0) atomicAdd(&grow[blank], blank_sum);
    __syncthreads();

#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      if (s < S) {
        const float next1 = s + 1 < S ? bterm[s + 1] : NEG_INF;
        const float next2 = (lat.skip_bits >> k & 1) ? bterm[s + 2] : NEG_INF;
        beta[s] = fmaxf(lse3(bterm[s], next1, next2), NEG_INF);
        if (t > 0) a_reg[k] = alpha_b[(size_t)(t - 1) * S + s];
      }
    }
    float* out_t = out + (size_t)t * C;
    for (int c = tid; c < C; c += nt) {
      out_t[c] = scale * grow[c];
      grow[c] = 0.0f;
      if (t > 0) row[c] = lp[(size_t)(t - 1) * C + c];
    }
    __syncthreads();
  }
}

size_t shared_bytes(int S, int C) { return (size_t)(2 * S + 2 * C) * sizeof(float); }

template <int K>
cudaError_t launch_alpha(const float* log_probs, const int* targets, const int* input_lengths,
                         const int* target_lengths, int B, int T, int C, int L, int blank,
                         float* alpha, float* ll, int threads, cudaStream_t stream) {
  const size_t smem = shared_bytes(2 * L + 1, C);
  cudaError_t err = allow_shared(ctc_alpha<K>, smem);
  if (err != cudaSuccess) return err;
  ctc_alpha<K><<<B, threads, smem, stream>>>(log_probs, targets, input_lengths, target_lengths,
                                             T, C, L, blank, alpha, ll);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_beta_grad(const float* log_probs, const int* targets,
                             const int* input_lengths, const int* target_lengths,
                             const float* alpha, const float* ll, const float* g, int B, int T,
                             int C, int L, int blank, float* grad, int threads,
                             cudaStream_t stream) {
  const size_t smem = shared_bytes(2 * L + 1, C);
  cudaError_t err = allow_shared(ctc_beta_grad<K>, smem);
  if (err != cudaSuccess) return err;
  ctc_beta_grad<K><<<B, threads, smem, stream>>>(log_probs, targets, input_lengths,
                                                 target_lengths, alpha, ll, g, T, C, L, blank,
                                                 grad);
  return cudaGetLastError();
}

}  // namespace

// Launches the forward pass on `stream`; returns the CUDA error code
// (0 = launched). Shapes: log_probs (B, T, C) float32, targets (B, L) int32,
// input/target lengths (B,) int32; outputs alpha (B, T, 2L+1) float32 and
// ll (B,) float32 (-1e30 for a row with no alignment). All contiguous.
extern "C" int ctc_loss_alpha(const float* log_probs, const int* targets,
                              const int* input_lengths, const int* target_lengths, int B, int T,
                              int C, int L, int blank, float* alpha, float* ll,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  const int threads = block_threads(S);
  return (int)with_states_per_thread(S, [&](auto k) {
    return launch_alpha<decltype(k)::value>(log_probs, targets, input_lengths, target_lengths,
                                            B, T, C, L, blank, alpha, ll, threads, stream);
  });
}

// Launches the backward pass on `stream`; returns the CUDA error code.
// Inputs as ctc_loss_alpha, plus its alpha and ll and the incoming cotangent
// g (B,) float32; output grad (B, T, C) float32, d loss[b] / d log_probs
// times g[b]. All contiguous.
extern "C" int ctc_loss_beta_grad(const float* log_probs, const int* targets,
                                  const int* input_lengths, const int* target_lengths,
                                  const float* alpha, const float* ll, const float* g, int B,
                                  int T, int C, int L, int blank, float* grad,
                                  void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  const int threads = block_threads(S);
  return (int)with_states_per_thread(S, [&](auto k) {
    return launch_beta_grad<decltype(k)::value>(log_probs, targets, input_lengths,
                                                target_lengths, alpha, ll, g, B, T, C, L,
                                                blank, grad, threads, stream);
  });
}
