// Whole-T CTC loss forward (alpha) and backward (beta + gradient) for Hopper
// (sm_90a): K2f and K2b.
//
// Replaces the TPU kernels convasr_tpu/ops/ctc_pallas.py:60 (_alpha_kernel)
// and :83 (_beta_grad_kernel), which keep the whole T of an 8-row tile in
// VMEM, together with what ctc_loss_pallas runs around them: the emission
// gather of :118-137 (_prepare), the final log-likelihood of :196-203
// (_final_ll) and the one-hot scatter back to the classes of :239-243
// (_bwd). Plain-PyTorch counterparts, and the kernels' oracles:
// convasr_tpu_torch/ops/ctc_loss.py (alpha_plain with take_frame0=True,
// beta_grad_plain), wrapped by ops/ctc_loss_whole_t.py.
//
// What they compute is K1's recursion (csrc/ctc_loss.cu states it) with the
// TPU v1 kernel's one difference: frame 0 starts every row, even a row with
// xlen = 0 (ctc_pallas.py:67-68). Such a row keeps alpha_0 on every frame
// and its ll comes from frame 0, so it gets a finite loss where ylen <= 1;
// its beta is never initialised (the last frame xlen-1 = -1 is never
// visited), so its gradient is 0. An infeasible row gets ll = -1e30 (the
// wrapper reports +inf) and a zero gradient; gamma is clipped to exp(+-80).
//
// What bounds them on this card. Bytes: the valid log-prob frames read once
// by each kernel, the gradient written once; alpha is an intermediate
// between the two. Operations: about 4 transcendentals and 8 other float32
// operations per state and valid frame in each direction. Both are far below
// what the card moves or computes in the time the kernels take: what bounds
// them is the chain of xlen dependent steps, each a round trip through shared
// memory and a barrier, with one block per row busying B of the 132 SMs.
// K1 also reads a C-wide log-prob row from device memory on every frame and
// waits for it at the frame's barrier (PERF.md: 0.5-1.8 us a frame).
//
// What the design does about it. The TPU kernel keeps the row's whole T in
// VMEM; here one block owns one row and stages all of its valid log-prob
// frames (xlen x C float32, 68 KB at the train CLI's T 446, C 38) into
// shared memory once, with cp.async copies (16 bytes where source and
// destination are aligned, 4 at the edges) started before the T-step chain
// and waited for once. The recursion then reads its emissions from shared
// memory only: no device-memory load sits inside the chain. Alpha (or beta)
// lives in shared memory, each thread keeps its states' labels and skip flags
// in registers (csrc/ctc_lattice.cuh, shared with K1). The backward pass
// forms gamma and scatters it into a C-wide gradient row in shared memory
// (warp shuffle plus one atomicAdd a warp for the blank, one atomicAdd per
// label state) and writes that row once, so neither the (B, T, S) dE tensor
// nor the one-hot product exists; it reads alpha of the next frame from
// device memory one frame ahead, into registers. The whole T must fit a
// block's 227 KB: (T*C + 4 + 2S + C) float32 (ops/ctc_loss_whole_t.smem_fits),
// which the wrapper checks; the atomics make the gradient agree with the
// plain version to float32 rounding of a sum of at most L+1 terms in [0, 1],
// not bit for bit. Several rows per block and TMA bulk copies are later work.
//
// Which kernel takes which lattice. K2b computes K1b's function with K1b's
// arguments, and writes 0 on every frame of a row with xlen = 0 as K1b's
// warp kernel does, so ops/ctc_loss_whole_t.py sends it K1b's route: a
// lattice that ops/ctc_loss.beta_grad_warp_fits takes (S <= WARP_S_MAX of
// csrc/ctc_loss.cu, 513) goes to K1b's warp kernel (ctc_beta_grad_warp of
// csrc/ctc_loss.cu, frames copied a chunk ahead), which was faster on the
// same batches; longer lattices, and wider classes, to ctc_beta_grad_whole_t
// below. K2f (ctc_alpha_whole_t) takes every lattice. Both routes reach
// exactly what smem_fits allows.
#include "ctc_lattice.cuh"

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Where the staged frames of a row start in shared memory: base (16-byte
// aligned) plus the row's own misalignment, so that source and destination
// share their address modulo 16 and the body moves in 16-byte copies.
__device__ __forceinline__ float* stage_dst(float* base, const float* src) {
  return base + (((uintptr_t)src & 15) >> 2);
}

// Starts the copy of n floats src -> dst (stage_dst) by all threads of the
// block and commits it; stage_wait() waits for it and syncs the block.
__device__ __forceinline__ void stage_begin(float* dst, const float* src, int n, int tid,
                                            int nt) {
  const int head = min(n, (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2));
  const int body = (n - head) >> 2;
  for (int i = tid; i < head; i += nt) cp_async4(dst + i, src + i);
  for (int i = tid; i < body; i += nt) cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + tid; i < n; i += nt) cp_async4(dst + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// floats of the staged region: T*C frames and up to 3 of alignment offset,
// rounded so that what follows stays 16-byte aligned
__host__ __device__ __forceinline__ size_t stage_floats(int T, int C) {
  return ((size_t)T * C + 3 + 3) / 4 * 4;
}

// K = states owned by each thread (S <= K * blockDim.x). The launch bound caps
// registers at 64 a thread so that 1024 threads fit an SM's 65,536.
template <int K>
__global__ void __launch_bounds__(1024)
ctc_alpha_whole_t(const float* __restrict__ log_probs, const int* __restrict__ targets,
                  const int* __restrict__ input_lengths,
                  const int* __restrict__ target_lengths, int T, int C, int L, int blank,
                  float* __restrict__ alpha, float* __restrict__ ll) {
  extern __shared__ __align__(16) float smem[];
  const int S = 2 * L + 1;
  float* alpha_buf[2] = {smem + stage_floats(T, C), smem + stage_floats(T, C) + S};

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int xl = min(max(input_lengths[b], 0), T);
  const int yl = min(max(target_lengths[b], 0), L);
  // frame 0 starts every row, a row with xlen = 0 too: it reads one frame
  const int steps = max(xl, 1);
  const float* lp = log_probs + (size_t)b * T * C;
  float* alpha_b = alpha + (size_t)b * T * S;

  float* frames = stage_dst(smem, lp);
  stage_begin(frames, lp, steps * C, tid, nt);
  Lattice<K> lat;  // overlaps the copies
  lat.load(targets + (size_t)b * L, S, C, blank, yl, tid, nt, false);
  stage_wait();

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * nt;
    if (s < S) {
      const float e = (lat.row_bits >> k & 1) ? frames[lat.ext[k]] : NEG_INF;
      const float a = s <= 1 ? e : NEG_INF;
      alpha_buf[0][s] = a;
      alpha_b[s] = a;
    }
  }
  __syncthreads();

  for (int t = 1; t < steps; ++t) {
    const float* a_prev = alpha_buf[(t - 1) & 1];
    float* a_next = alpha_buf[t & 1];
    const float* row = frames + (size_t)t * C;
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
    __syncthreads();
  }

  const float* last = alpha_buf[(steps - 1) & 1];
  // frozen frames repeat the last alpha
  for (size_t i = tid; i < (size_t)(T - steps) * S; i += nt)
    alpha_b[(size_t)steps * S + i] = last[i % S];
  if (tid == 0) {
    const float a1 = yl > 0 ? last[2 * yl - 1] : NEG_INF;
    const float a2 = last[2 * yl];
    const float m = fmaxf(a1, a2);
    ll[b] = m <= NEG_INF / 2 ? NEG_INF : m + logf(expf(a1 - m) + expf(a2 - m));
  }
}

template <int K>
__global__ void __launch_bounds__(1024)
ctc_beta_grad_whole_t(const float* __restrict__ log_probs, const int* __restrict__ targets,
                      const int* __restrict__ input_lengths,
                      const int* __restrict__ target_lengths, const float* __restrict__ alpha,
                      const float* __restrict__ ll, const float* __restrict__ g, int T, int C,
                      int L, int blank, float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem[];
  const int S = 2 * L + 1;
  float* beta = smem + stage_floats(T, C);
  float* bterm = beta + S;
  float* grow = bterm + S;

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

  // frames past xlen, every frame of an infeasible row and of a row with
  // xlen = 0 (its beta is never initialised) get 0
  const int live = feasible ? xl : 0;
  for (size_t i = tid; i < (size_t)(T - live) * C; i += nt) out[(size_t)live * C + i] = 0.0f;
  if (live == 0) return;

  float* frames = stage_dst(smem, lp);
  stage_begin(frames, lp, live * C, tid, nt);
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
  for (int c = tid; c < C; c += nt) grow[c] = 0.0f;
  stage_wait();

  for (int t = xl - 1; t >= 0; --t) {
    const float* row = frames + (size_t)t * C;
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
    }
    __syncthreads();
  }
}

size_t alpha_shared_bytes(int T, int S, int C) {
  return (stage_floats(T, C) + 2 * S) * sizeof(float);
}
size_t beta_grad_shared_bytes(int T, int S, int C) {
  return (stage_floats(T, C) + 2 * S + C) * sizeof(float);
}

template <int K>
cudaError_t launch_alpha(const float* log_probs, const int* targets, const int* input_lengths,
                         const int* target_lengths, int B, int T, int C, int L, int blank,
                         float* alpha, float* ll, int threads, cudaStream_t stream) {
  const size_t smem = alpha_shared_bytes(T, 2 * L + 1, C);
  cudaError_t err = allow_shared(ctc_alpha_whole_t<K>, smem);
  if (err != cudaSuccess) return err;
  ctc_alpha_whole_t<K><<<B, threads, smem, stream>>>(log_probs, targets, input_lengths,
                                                     target_lengths, T, C, L, blank, alpha, ll);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_beta_grad(const float* log_probs, const int* targets,
                             const int* input_lengths, const int* target_lengths,
                             const float* alpha, const float* ll, const float* g, int B, int T,
                             int C, int L, int blank, float* grad, int threads,
                             cudaStream_t stream) {
  const size_t smem = beta_grad_shared_bytes(T, 2 * L + 1, C);
  cudaError_t err = allow_shared(ctc_beta_grad_whole_t<K>, smem);
  if (err != cudaSuccess) return err;
  ctc_beta_grad_whole_t<K><<<B, threads, smem, stream>>>(log_probs, targets, input_lengths,
                                                         target_lengths, alpha, ll, g, T, C, L,
                                                         blank, grad);
  return cudaGetLastError();
}

}  // namespace

// Launches K2f on `stream`; returns the CUDA error code (0 = launched).
// Shapes: log_probs (B, T, C) float32, targets (B, L) int32, input/target
// lengths (B,) int32; outputs alpha (B, T, 2L+1) float32 and ll (B,) float32
// (-1e30 for a row with no alignment). All contiguous, T >= 1.
extern "C" int ctc_loss_whole_t_alpha(const float* log_probs, const int* targets,
                                      const int* input_lengths, const int* target_lengths,
                                      int B, int T, int C, int L, int blank, float* alpha,
                                      float* ll, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  const int threads = block_threads(S);
  return (int)with_states_per_thread(S, [&](auto k) {
    return launch_alpha<decltype(k)::value>(log_probs, targets, input_lengths, target_lengths,
                                            B, T, C, L, blank, alpha, ll, threads, stream);
  });
}

// Launches K2b on `stream`; returns the CUDA error code. Inputs as
// ctc_loss_whole_t_alpha, plus its alpha and ll and the incoming cotangent
// g (B,) float32; output grad (B, T, C) float32, d loss[b] / d log_probs
// times g[b]. All contiguous.
extern "C" int ctc_loss_whole_t_beta_grad(const float* log_probs, const int* targets,
                                          const int* input_lengths,
                                          const int* target_lengths, const float* alpha,
                                          const float* ll, const float* g, int B, int T, int C,
                                          int L, int blank, float* grad, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  const int threads = block_threads(S);
  return (int)with_states_per_thread(S, [&](auto k) {
    return launch_beta_grad<decltype(k)::value>(log_probs, targets, input_lengths,
                                                target_lengths, alpha, ll, g, B, T, C, L,
                                                blank, grad, threads, stream);
  });
}
