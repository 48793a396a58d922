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
// row, staged in shared memory.
//
// The forward kernel (ctc_alpha) keeps one thread per state (K per thread
// past 992 states) and one barrier a frame, with alpha in shared memory. Each
// step reads shared memory only and writes nothing else: a ring of D frames in
// shared memory, two chunks of D / 2 frames, holds both the row's log-probs
// and its alpha frames. One more warp of the block (the memory warp) copies
// each chunk's log-prob frames in by cp.async of 16-byte pieces a chunk ahead,
// waited on with cp.async.wait_group, and stores each finished chunk's alpha
// frames to device memory, so that neither a copy nor a device-memory store
// stands before a step's barrier; the compute threads and the memory warp
// meet at two named barriers at each chunk's end. (A row loaded inside the
// step makes each of the xlen dependent steps wait a device-memory round trip
// before its barrier.) The step is straight-line code over a thread's states
// with the plain version's operations in its order and accurate expf/logf
// (lse3_select).
//
// The backward pass forms gamma and scatters it straight into C-wide gradient
// rows, so neither the (B, T, S) dE tensor nor the one-hot product of the JAX
// path exists. Several states share a class (the blank; repeated labels).
// The block kernel sums the blank's L+1 states by a warp shuffle and one
// shared-memory atomicAdd per warp, label states with a shared-memory
// atomicAdd each. The order of those float additions varies from run to run,
// so the gradient agrees with the plain version to float32 rounding of a sum
// of at most L+1 terms in [0, 1], not bit for bit (ops/ctc_loss.py states the
// tolerance).
//
// The backward pass has two kernels. The block kernel (ctc_beta_grad, one
// block a row) spends two block barriers a frame and waits, on every step of
// the xlen-step chain, for the next frame's log-prob row and alpha to come
// from device memory. The warp kernel (ctc_beta_grad_warp, the path's, for
// S <= WARP_S_MAX; the rule is ops/ctc_loss.py beta_grad_warp_fits) takes
// both out of the chain, and takes the gradient off the warp that runs it:
// - one warp (the chain warp) owns a row's beta: lane l keeps the beta of
//   states l, l + 32, ... (K = ceil(S / 32) of them) in registers and reaches
//   beta at s+1 and s+2 with __shfl_sync (the next k for the last lanes). A
//   step is straight-line code over the K states, so that their dependent
//   chains interleave, with no barrier and no branch. Its logsumexp, and
//   gamma, take expf and logf in the plain version's order of operations, as
//   the block kernel does: the hardware's approximations (ex2, lg2) were
//   faster, but the error they add to beta at each frame grows with xlen
//   (PERF.md).
// - a second warp of the same row (the gradient warp) forms gamma from alpha
//   and the chain warp's beta frames, sums it per class and stores the
//   gradient rows: one warp alone spent more of each step on gamma, the class
//   sums and its copies than on the recursion (PERF.md).
// - the walk goes in chunks of CHUNK frames. The chain warp writes a chunk's
//   beta frames to shared memory; at the chunk's end the two warps meet at a
//   named barrier of their own (bar.sync over 64 threads), which hands the
//   chunk to the gradient warp and frees the one before it. Each warp copies
//   what it reads (the log-prob rows, the alpha frames) one to two chunks
//   ahead with cp.async, waited on with cp.async.wait_group. A chunk's frames
//   are contiguous in memory, so they go as 16-byte pieces from the chunk's
//   start rounded down to 16 bytes, the last piece cut at the chunk's end
//   (cp.async's source size); no layout is padded.
// - the gradient warp sums a chunk's gamma with no atomics, in the same order
//   every run: the blank states by a warp reduction, each class by the lane
//   that owns it over its labels, grouped by class once per row in label
//   order. The rows go out with coalesced stores that the chain does not wait
//   on. (Shared-memory float atomics, which Hopper runs as a compare-and-swap
//   loop, were slower.)
// - several rows go in a block (two warps each), so that B rows take B / rows
//   SMs.
#include "ctc_lattice.cuh"

namespace {

// lse3 (ctc_lattice.cuh) as a select rather than an early return: the same
// rule for out-of-reach arguments, and the plain version's operations in its
// order, so that the float32 roundings of the large sums (|beta| grows by a
// few units a frame) stay the same.
__device__ __forceinline__ float lse3_select(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float r = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return m <= NEG_INF / 2 ? NEG_INF : r;
}

// frames in the forward's ring on the path, chosen by the sweep of
// chip_smoke.py (PERF.md); ops/ctc_loss.py reads it from this line
constexpr int ALPHA_DEPTH = 16;
// the forward's threads a state at most: one more warp (the memory warp)
// copies the log-probs in and alpha out
constexpr int ALPHA_MAX_THREADS = 992;
// the forward's named barriers (0 is __syncthreads)
constexpr int BAR_STEP = 1;   // the compute threads, after each frame
constexpr int BAR_FULL = 2;   // compute -> memory warp: a chunk's frames are done
constexpr int BAR_READY = 3;  // memory warp -> compute: the next chunk's log-probs are in

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// compute threads of the forward for a lattice of S states
int alpha_threads(int S) { return min((S + 31) / 32 * 32, ALPHA_MAX_THREADS); }

// 4-byte words of the forward's shared memory for a ring of `depth` frames:
// two chunks of depth / 2 frames, each of the log-probs (copied from any
// 4-byte boundary) and of alpha
inline int alpha_words(int S, int C, int depth) {
  return 2 * area(depth / 2 * C) + depth * S;
}

// The deepest ring of at most `depth` frames (a power of two) whose buffers
// fit a block's shared memory; 0 where not even two frames fit.
int alpha_depth(int S, int C, int depth) {
  for (int d = depth; d >= 2; d /= 2)
    if (4L * alpha_words(S, C, d) <= SMEM_LIMIT) return d;
  return 0;
}

// K = states owned by each compute thread (S <= K * (blockDim.x - 32)), D =
// frames in the ring (a power of two, at least 2): two chunks of CH = D / 2
// frames. The compute threads walk the frames, one barrier of their own a
// frame; the last warp of the block (the memory warp) copies chunk j + 2's
// log-probs in and chunk j's alpha frames out while chunk j + 1 runs, and the
// two sides meet at each chunk's end. The launch bound caps registers at 64 a
// thread so that 1024 threads fit an SM's 65,536.
template <int K, int D>
__global__ void __launch_bounds__(1024)
ctc_alpha(const float* __restrict__ log_probs, const int* __restrict__ targets,
          const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
          int T, int C, int L, int blank, float* __restrict__ alpha, float* __restrict__ ll) {
  constexpr int CH = D / 2;
  extern __shared__ __align__(16) float smem16[];
  const int S = 2 * L + 1;
  const int cw = area(CH * C);
  float* ring = smem16;           // the log-probs of chunk j in ring + (j & 1) * cw
  float* alphas = ring + 2 * cw;  // alpha_t in alphas + (t % D) * S: chunk j in (j & 1)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x - 32;  // compute threads
  const bool mem = tid >= nt;
  const int xl = min(max(input_lengths[b], 0), T);
  const int yl = min(max(target_lengths[b], 0), L);
  const float* lp = log_probs + (size_t)b * T * C;
  float* alpha_b = alpha + (size_t)b * T * S;

  if (xl == 0) {
    for (size_t i = tid; i < (size_t)T * S; i += blockDim.x) alpha_b[i] = NEG_INF;
    if (tid == 0) ll[b] = NEG_INF;
    return;
  }

  // chunk j holds frames j * CH .. below xlen; its log-probs go to their
  // buffer in 16-byte pieces, one commit group a chunk (an empty one past
  // xlen). (Copies issued, and alpha stored, by the compute threads in each
  // step stood before the step's barrier and took much of its time: PERF.md.)
  const int chunks = (xl + CH - 1) / CH;
  auto frames = [&](int j) { return min(xl, (j + 1) * CH) - j * CH; };
  auto issue = [&](int j) {
    if (j < chunks)
      copy_ahead(ring + (j & 1) * cw, lp + (size_t)j * CH * C, frames(j) * C, tid - nt, 32);
    cp_async_commit();
  };
  if (mem) {
    issue(0);
    issue(1);
    cp_async_wait<1>();  // chunk 0
  }
  __syncthreads();

  if (mem) {
    for (int j = 0; j < chunks; ++j) {
      bar_sync(BAR_FULL, nt + 32);  // the compute threads are done with chunk j
      if (j + 1 < chunks) {
        cp_async_wait<0>();  // chunk j + 1's log-probs have landed
        __syncwarp();
        bar_arrive(BAR_READY, nt + 32);
      }
      issue(j + 2);  // into chunk j's buffer
      // chunk j's alpha frames to device memory; chunk j + 2 reuses their
      // buffer only after this warp's next arrival at BAR_READY
      const float* src = alphas + (j & 1) * CH * S;
      float* dst = alpha_b + (size_t)j * CH * S;
      for (int i = tid - nt; i < frames(j) * S; i += 32) dst[i] = src[i];
    }
  } else {
    Lattice<K> lat;
    lat.load(targets + (size_t)b * L, S, C, blank, yl, tid, nt, false);
    // after frame t: the step barrier, or at a chunk's end the hand-over
    auto end_of_frame = [&](int t) {
      if ((t & (CH - 1)) == CH - 1 || t == xl - 1) {
        bar_arrive(BAR_FULL, nt + 32);
        if (t < xl - 1) bar_sync(BAR_READY, nt + 32);
      } else {
        bar_sync(BAR_STEP, nt);
      }
    };
    {
      const float* row = ring + lead(lp);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = tid + k * nt;
        const float e = pick(lat.row_bits >> k & 1, row[lat.ext[k]], NEG_INF);
        if (s < S) alphas[s] = pick(s <= 1, e, NEG_INF);
      }
    }
    end_of_frame(0);
    for (int t = 1; t < xl; ++t) {
      const int j = t / CH;
      const float* row = ring + (j & 1) * cw + lead(lp + (size_t)j * CH * C) + (t - j * CH) * C;
      const float* a_prev = alphas + ((t - 1) & (D - 1)) * S;
      float* a_next = alphas + (t & (D - 1)) * S;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // a state past S computes the terms of state S-1 and stores nothing:
        // the step has no branch, and the guarded store is predicated
        const int s = tid + k * nt;
        const int q = min(s, S - 1);
        const float stay = a_prev[q];
        const float prev1 = pick(q >= 1, a_prev[max(q - 1, 0)], NEG_INF);
        const float prev2 = pick(lat.skip_bits >> k & 1, a_prev[max(q - 2, 0)], NEG_INF);
        const float e = pick(lat.row_bits >> k & 1, row[lat.ext[k]], NEG_INF);
        const float a = fmaxf(lse3_select(stay, prev1, prev2) + e, NEG_INF);
        if (s < S) a_next[s] = a;
      }
      end_of_frame(t);
    }
  }
  __syncthreads();

  const float* last = alphas + ((xl - 1) & (D - 1)) * S;
  // frozen frames repeat the last alpha
  for (size_t i = tid; i < (size_t)(T - xl) * S; i += blockDim.x)
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

constexpr int P_MAX = 32;           // states a lane owns at most: S <= 32 * P_MAX
// ops/ctc_loss.py reads WARP_S_MAX from this line for the states part of the
// route (ctc_loss_beta_grad_warp_fits below): the most states at which the
// warp kernel beat the block kernel in every run of chip_smoke.py (PERF.md:
// it won at S 321 and 513 and lost at 769 and 1023, B32 T500)
constexpr int WARP_S_MAX = 513;
constexpr int CHUNK = 8;            // frames copied and handed over together
constexpr int ROWS = 2;             // rows a block at most, two warps each
static_assert(32 % CHUNK == 0, "a chunk's blank partial sums are reduced by 32 / CHUNK lanes");


// 4-byte words of one row's shared memory, a multiple of 4: the chain warp's
// two chunks of log-prob rows, the gradient warp's two chunks of alpha frames,
// two chunks of beta frames handed from the one to the other; for one chunk
// the label states' gamma (L each), the lanes' partial sums of the blank
// states' gamma (32 each) and their totals; the labels grouped by class (C
// list ends, L label indices)
__host__ __device__ inline int row_words(int S, int C) {
  const int L = (S - 1) / 2;
  return (2 * area(CHUNK * C) + 2 * area(CHUNK * S) + 2 * CHUNK * S + CHUNK * (L + 33) + C + L +
          3) / 4 * 4;
}

// rows a block of the warp kernel for a batch of B: ROWS, fewer for a small
// batch or where that many rows' buffers pass a block's shared memory (0
// where not even one row's fit)
int warp_rows(int B, int S, int C) {
  const long fit = SMEM_LIMIT / (4L * row_words(S, C));
  const int rows = B < ROWS ? (B > 1 ? B : 1) : ROWS;
  return rows < fit ? rows : (int)fit;
}

// In place, the exclusive prefix sums of n ints, by one warp.
__device__ inline void warp_exclusive_scan(int* v, int n, int lane) {
  const int per = (n + 31) / 32, lo = min(lane * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += v[i];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  int run = incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = v[i];
    v[i] = run;
    run += c;
  }
}

// K = states owned by each lane, ceil(S / 32). blockDim.x = 64 * rows: warps
// 2r and 2r + 1 of block x own row x * rows + r, the first (the chain warp)
// its beta recursion, the second (the gradient warp) its gradient. The walk
// from frame xlen-1 down goes in chunks of CHUNK frames; after chunk j the
// two warps meet at a named barrier, which hands chunk j's beta frames to
// the gradient warp and tells the chain warp that chunk j-1's buffer is free.
template <int K>
__global__ void __launch_bounds__(64 * ROWS)
ctc_beta_grad_warp(const float* __restrict__ log_probs, const int* __restrict__ targets,
                   const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
                   const float* __restrict__ alpha, const float* __restrict__ ll,
                   const float* __restrict__ g, int B, int T, int C, int L, int blank,
                   float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem16[];
  const int S = 2 * L + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r = warp >> 1;
  const bool chain = (warp & 1) == 0;
  const int b = blockIdx.x * (blockDim.x >> 6) + r;
  if (b >= B) return;
  float* lp_buf = smem16 + (size_t)r * row_words(S, C);          // 2 x area(CHUNK * C)
  float* a_buf = lp_buf + 2 * area(CHUNK * C);                    // 2 x area(CHUNK * S)
  float* b_buf = a_buf + 2 * area(CHUNK * S);                     // 2 x CHUNK * S
  float* gam_labels = b_buf + 2 * CHUNK * S;                      // CHUNK x L
  float* blank_part = gam_labels + CHUNK * L;                     // CHUNK x 32
  float* blank_tot = blank_part + CHUNK * 32;                     // CHUNK
  int* ends = reinterpret_cast<int*>(blank_tot + CHUNK);          // C
  int* order = ends + C;                                          // L

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
  if (!chain)
    for (size_t i = lane; i < (size_t)(T - live) * C; i += 32) out[(size_t)live * C + i] = 0.0f;
  if (live == 0) return;

  // chunk j holds frames lo(j) .. lo(j) + count(j) - 1; its frame f (walking
  // down) is t = lo(j) + count(j) - 1 - f
  const int chunks = (live + CHUNK - 1) / CHUNK;
  auto lo = [&](int j) { return max(live - CHUNK * (j + 1), 0); };
  auto count = [&](int j) { return live - CHUNK * j - lo(j); };

  const int* tg = targets + (size_t)b * L;
  Lattice<K> lat;
  lat.load(tg, S, C, blank, yl, lane, 32, true);

  if (chain) {
    // the log-prob rows of chunk j + 2 are copied while chunk j + 1 runs
    auto issue = [&](int j) {
      if (j < chunks)
        copy_ahead(lp_buf + (j & 1) * area(CHUNK * C), lp + (size_t)lo(j) * C, count(j) * C,
                   lane, 32);
      cp_async_commit();
    };
    issue(0);
    issue(1);
    float beta[K];
    const int end1 = 2 * yl - 1, end2 = 2 * yl;
    unsigned next1_bits = 0;  // state s+1 exists (s+1 < S)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = lane + 32 * k;
      beta[k] = (s == end1 || s == end2) ? 0.0f : NEG_INF;
      if (s + 1 < S) next1_bits |= 1u << k;
    }
#pragma unroll 1
    for (int j = 0; j < chunks; ++j) {
      const int l0 = lo(j), n = count(j);
      cp_async_wait<1>();  // this lane's copies of chunk j have landed
      __syncwarp();           // and every lane's
      const float* rows = lp_buf + (j & 1) * area(CHUNK * C) + lead(lp + (size_t)l0 * C);
      float* b_out = b_buf + (j & 1) * CHUNK * S;
#pragma unroll 1
      for (int f = 0; f < n; ++f) {
        const int t = l0 + n - 1 - f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = lane + 32 * k;
          if (s < S) b_out[f * S + s] = beta[k];
        }
        if (t > 0) {
          // The step is straight-line code: selects that picked between
          // shuffled values by lane were compiled into a branch around each
          // state, which kept the states' chains from interleaving (PERF.md).
          // A term that does not exist gets NEG_INF added instead: far below
          // every real term, it is neither the maximum nor a part of the
          // sum, as the plain version's NEG_INF, so the result is the same; a
          // state past S keeps NEG_INF.
          const float* row = rows + (t - l0) * C;
          float bterm[K + 1];
          bterm[K] = NEG_INF;
#pragma unroll
          for (int k = 0; k < K; ++k)
            bterm[k] = beta[k] + row[lat.ext[k]] + pick(lat.row_bits >> k & 1, 0.0f, NEG_INF);
          // bterm of states s+1 and s+2 are lane+1's and lane+2's at the same
          // k; the last lanes' come from lanes 0 and 1 at k+1, which send that
          float next1[K], next2[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            next1[k] = __shfl_sync(0xffffffffu, pick(lane == 0, bterm[k + 1], bterm[k]),
                                   (lane + 1) & 31) +
                       pick(next1_bits >> k & 1, 0.0f, NEG_INF);
            next2[k] = __shfl_sync(0xffffffffu, pick(lane < 2, bterm[k + 1], bterm[k]),
                                   (lane + 2) & 31) +
                       pick(lat.skip_bits >> k & 1, 0.0f, NEG_INF);
          }
#pragma unroll
          for (int k = 0; k < K; ++k)
            beta[k] = fmaxf(lse3_select(bterm[k], next1[k], next2[k]), NEG_INF);
        }
      }
      __syncwarp();  // every lane is done with this chunk's log-prob rows
      issue(j + 2);
      bar_sync(1 + r, 64);  // the row's two warps: chunk j's beta frames to the gradient warp
    }
    return;
  }

  // the gradient warp. The labels grouped by class, in label order:
  // order[ends[c-1] .. ends[c]) are the labels of class c, so that a lane sums
  // a class's gamma with no atomics, in the same order every run
  for (int c = lane; c < C; c += 32) ends[c] = 0;
  __syncwarp();
  for (int j = lane; j < L; j += 32) atomicAdd(&ends[min(max(tg[j], 0), C - 1)], 1);
  __syncwarp();
  warp_exclusive_scan(ends, C, lane);
  __syncwarp();
  for (int j0 = 0; j0 < L; j0 += 32) {
    const int j = j0 + lane;
    const int c = j < L ? min(max(tg[j], 0), C - 1) : -1 - lane;  // idle lanes match no one
    const unsigned same = __match_any_sync(0xffffffffu, c);
    const int rank = __popc(same & ((1u << lane) - 1));
    const int pos = j < L ? ends[c] + rank : 0;
    __syncwarp();
    if (j < L) {
      order[pos] = j;
      if (rank == __popc(same) - 1) ends[c] = pos + 1;  // the last of its class this round
    }
    __syncwarp();
  }
  // a lane's states share the parity of its index: even lanes hold only
  // blank states, odd lanes only labels
  const bool blank_lane = (lane & 1) == 0;
  // the alpha frames of chunk j + 1 are copied while chunk j's gradient runs
  auto issue = [&](int j) {
    if (j < chunks)
      copy_ahead(a_buf + (j & 1) * area(CHUNK * S), alpha_b + (size_t)lo(j) * S, count(j) * S,
                 lane, 32);
    cp_async_commit();
  };
  issue(0);
#pragma unroll 1
  for (int j = 0; j < chunks; ++j) {
    const int l0 = lo(j), n = count(j);
    bar_sync(1 + r, 64);  // the chain warp has written chunk j's beta frames
    issue(j + 1);
    cp_async_wait<1>();
    __syncwarp();
    const float* a_rows = a_buf + (j & 1) * area(CHUNK * S) + lead(alpha_b + (size_t)l0 * S);
    const float* b_in = b_buf + (j & 1) * CHUNK * S;
#pragma unroll 1
    for (int f = 0; f < n; ++f) {
      const float* a_t = a_rows + (n - 1 - f) * S;
      const float* b_t = b_in + f * S;
      float* gl = gam_labels + f * L;
      float blank_sum = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = lane + 32 * k;
        const bool in = s < S;
        const int q = in ? s : 0;
        const float gam = expf(fminf(fmaxf(a_t[q] + b_t[q] - ll_b, -80.0f), 80.0f));
        if (in && blank_lane) blank_sum += gam;
        if (in && !blank_lane) gl[s >> 1] = gam;  // label s >> 1 of state s
      }
      blank_part[f * 32 + lane] = blank_sum;
    }
    __syncwarp();
    {
      // frame lane % CHUNK: 32 / CHUNK lanes each sum CHUNK lanes' partials
      const float* part = blank_part + (lane % CHUNK) * 32 + (lane / CHUNK) * CHUNK;
      float v = 0.0f;
#pragma unroll
      for (int m = 0; m < CHUNK; ++m) v += part[m];
#pragma unroll
      for (int off = CHUNK; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < CHUNK) blank_tot[lane] = v;
    }
    __syncwarp();
    // the chunk's gradient rows, each class summed by one lane
    for (int c = lane; c < C; c += 32) {
      float acc[CHUNK];
#pragma unroll
      for (int h = 0; h < CHUNK; ++h) acc[h] = c == blank ? blank_tot[h] : 0.0f;
      for (int q = c ? ends[c - 1] : 0; q < ends[c]; ++q) {
        const float* gj = gam_labels + order[q];
#pragma unroll
        for (int h = 0; h < CHUNK; ++h) acc[h] += gj[h * L];
      }
#pragma unroll
      for (int h = 0; h < CHUNK; ++h)
        if (h < n) out[(size_t)(l0 + n - 1 - h) * C + c] = scale * acc[h];
    }
    __syncwarp();  // before the next chunk's copies, gamma and partial sums
  }
}

size_t shared_bytes(int S, int C) { return (size_t)(2 * S + 2 * C) * sizeof(float); }

template <int K, int D>
cudaError_t launch_alpha(const float* log_probs, const int* targets, const int* input_lengths,
                         const int* target_lengths, int B, int T, int C, int L, int blank,
                         float* alpha, float* ll, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)alpha_words(2 * L + 1, C, D) * sizeof(float);
  cudaError_t err = allow_shared(ctc_alpha<K, D>, smem);
  if (err != cudaSuccess) return err;
  ctc_alpha<K, D><<<B, threads + 32, smem, stream>>>(log_probs, targets, input_lengths,
                                                     target_lengths, T, C, L, blank, alpha, ll);
  return cudaGetLastError();
}

// launch(std::integral_constant<int, K>()) with K = the states a compute
// thread of the forward owns, a power of two up to 32
template <typename Launch>
cudaError_t with_alpha_states(int S, Launch launch) {
  const int nt = alpha_threads(S), per = (S + nt - 1) / nt;
  if (per <= 1) return launch(std::integral_constant<int, 1>());
  if (per <= 2) return launch(std::integral_constant<int, 2>());
  if (per <= 4) return launch(std::integral_constant<int, 4>());
  if (per <= 8) return launch(std::integral_constant<int, 8>());
  if (per <= 16) return launch(std::integral_constant<int, 16>());
  if (per <= 32) return launch(std::integral_constant<int, 32>());
  return cudaErrorInvalidValue;
}

// launch(std::integral_constant<int, D>()) for a ring of D = 2, 4, 8, 16 or
// 32 frames; cudaErrorInvalidValue for any other D
template <typename Launch>
cudaError_t with_depth(int depth, Launch launch) {
  switch (depth) {
    case 2: return launch(std::integral_constant<int, 2>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    default: return cudaErrorInvalidValue;
  }
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

template <int K>
cudaError_t launch_beta_grad_warp(const float* log_probs, const int* targets,
                                  const int* input_lengths, const int* target_lengths,
                                  const float* alpha, const float* ll, const float* g, int B,
                                  int T, int C, int L, int blank, float* grad, int rows,
                                  cudaStream_t stream) {
  const size_t smem = (size_t)rows * row_words(2 * L + 1, C) * sizeof(float);
  cudaError_t err = allow_shared(ctc_beta_grad_warp<K>, smem);
  if (err != cudaSuccess) return err;
  ctc_beta_grad_warp<K><<<(B + rows - 1) / rows, 64 * rows, smem, stream>>>(
      log_probs, targets, input_lengths, target_lengths, alpha, ll, g, B, T, C, L, blank, grad);
  return cudaGetLastError();
}

// launch(std::integral_constant<int, K>()) with K = ceil(S / 32) for K in
// [K0, P_MAX]; cudaErrorInvalidValue past P_MAX
template <int K0, typename Launch>
cudaError_t with_lane_states(int S, Launch launch) {
  if constexpr (K0 > P_MAX) {
    return cudaErrorInvalidValue;
  } else {
    if (S <= 32 * K0) return launch(std::integral_constant<int, K0>());
    return with_lane_states<K0 + 1>(S, launch);
  }
}

}  // namespace

// Launches the forward pass on `stream` with a ring of at most `depth`
// frames (2, 4, 8, 16 or 32; fewer where that many do not fit shared memory;
// the path's is ALPHA_DEPTH); returns the CUDA error code (0 = launched).
// Shapes: log_probs (B, T, C) float32 starting on 16 bytes, targets (B, L)
// int32, input/target lengths (B,) int32; outputs alpha (B, T, 2L+1) float32
// and ll (B,) float32 (-1e30 for a row with no alignment). All contiguous.
// cudaErrorInvalidValue for another depth, log_probs off 16 bytes, or a
// lattice whose buffers do not fit.
extern "C" int ctc_loss_alpha(const float* log_probs, const int* targets,
                              const int* input_lengths, const int* target_lengths, int B, int T,
                              int C, int L, int blank, float* alpha, float* ll, int depth,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  const int threads = alpha_threads(S);
  const int d = alpha_depth(S, C, depth);
  if ((depth & (depth - 1)) || d == 0 || (reinterpret_cast<uintptr_t>(log_probs) & 15))
    return (int)cudaErrorInvalidValue;
  return (int)with_alpha_states(S, [&](auto k) {
    return with_depth(d, [&](auto dd) {
      return launch_alpha<decltype(k)::value, decltype(dd)::value>(
          log_probs, targets, input_lengths, target_lengths, B, T, C, L, blank, alpha, ll,
          threads, stream);
    });
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

// Whether the warp backward kernel can run a lattice of S states over C
// classes: S <= 32 * P_MAX, and one row's buffers fit a block's shared memory.
static bool warp_reaches(int S, int C) {
  return S >= 1 && C > 0 && S <= 32 * P_MAX && warp_rows(1, S, C) >= 1;
}

// 1 where the route gives the warp backward kernel a lattice of L labels over
// C classes: S = 2L+1 <= WARP_S_MAX, and the kernel reaches it; else 0
// (ops/ctc_loss.py sends such a lattice to the block kernel).
extern "C" int ctc_loss_beta_grad_warp_fits(int L, int C) {
  const int S = 2 * L + 1;
  return L >= 0 && S <= WARP_S_MAX && warp_reaches(S, C);
}

// Launches the warp backward pass on `stream`, up to ROWS rows a block;
// arguments and result as ctc_loss_beta_grad. cudaErrorInvalidValue for a
// lattice the kernel does not reach (warp_reaches), or log_probs or alpha not
// on a 16-byte boundary.
extern "C" int ctc_loss_beta_grad_warp(const float* log_probs, const int* targets,
                                       const int* input_lengths, const int* target_lengths,
                                       const float* alpha, const float* ll, const float* g,
                                       int B, int T, int C, int L, int blank, float* grad,
                                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  if (L < 0 || !warp_reaches(S, C) ||
      ((reinterpret_cast<uintptr_t>(log_probs) | reinterpret_cast<uintptr_t>(alpha)) & 15))
    return (int)cudaErrorInvalidValue;
  const int rows = warp_rows(B, S, C);
  return (int)with_lane_states<1>(S, [&](auto k) {
    return launch_beta_grad_warp<decltype(k)::value>(log_probs, targets, input_lengths,
                                                     target_lengths, alpha, ll, g, B, T, C, L,
                                                     blank, grad, rows, stream);
  });
}
