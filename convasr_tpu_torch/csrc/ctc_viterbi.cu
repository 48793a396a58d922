// CTC Viterbi forced alignment for Hopper (sm_90a): K3.
//
// Replaces the TPU kernel convasr_tpu/ops/align_pallas.py:28 (_viterbi_kernel)
// together with the backtrace and char-frame pick that the JAX package runs
// outside it (align_pallas.py:92-125). Plain-PyTorch counterpart, and the
// kernels' oracle: convasr_tpu_torch/ops/ctc.py (ctc_alignment).
//
// What it computes, per utterance row b, over the blank-interleaved lattice of
// S = 2L+1 states:
//   alpha_0[s] = E_0[s] for s <= 1, else -1e30
//   alpha_t[s] = max(max(alpha[s], alpha[s-1], skip[s] ? alpha[s-2] : -1e30)
//                    + E_t[s], -1e30)                         for 0 < t < xlen
//   bp[t][s]   = 0 stay, 1 from s-1, 2 from s-2; strict '>' in that order, so
//                ties keep the lower move (the JAX argmax's first maximum)
// with E_t[s] = log_probs[b, t, ext[s]] for s < 2*ylen+1 and -1e30 beyond.
// Rows freeze past xlen, and alpha at frame xlen-1 is written out as
// final_alpha (-1e30 everywhere for a row with xlen = 0). Then the backtrace
// starts from state 2*ylen-1 when its final alpha >= that of 2*ylen (2*ylen
// for empty targets) and records, for every char l, the last frame in state
// 2l+1 (0 where none). Only maxima and float32 additions: the result is
// bit-equal to the oracle.
//
// What bounds it on this card: not bytes and not operations, but the chain of
// xlen dependent steps, then the backtrace's chain of xlen dependent
// backpointer reads. Two kernels; ops/align.py routes a lattice of S <=
// WARP_S_MAX states to the first, longer ones to the second.
//
// viterbi_warp (the path's). One warp owns a row, and a block holds up to
// ROWS rows; nothing in the chain waits on a block barrier.
// - Lane i keeps alpha of the P contiguous states [i*P, i*P + P) in
//   registers, P = ceil(S / 32) rounded up to even. Then a lane's first state
//   is a blank and its states alternate blank, label: s-1 and s-2 are the
//   lane's own registers, except for its first state's s-1 and its second
//   state's s-2, both the previous lane's last state, one __shfl_up_sync a
//   frame. A blank never skips; its s-2 term of -1e30 can neither win nor
//   change the maximum (every alpha it meets is >= -1e30), so a blank state
//   takes the stay/s-1 half of the step. Labels are registers. Where a label
//   may not skip, its s-2 term gets -1e30 added instead of being replaced by
//   it: the sum is at most -1e30, so it wins no comparison that -1e30 would
//   lose and leaves the same maximum. (Compares, maxima and selects issue at
//   half the rate of additions on this card, so the step keeps them few.)
// - A state past the row's own lattice (s >= 2*ylen+1) takes its emission
//   unmasked: it only feeds states above it, never the row's own, and the
//   plain version holds it at -1e30 for every input whose alphas stay below
//   3.7e22 (log-probs are <= 0), so its final alpha is written as -1e30.
// - Emissions come from a ring of log-prob frames in shared memory, two
//   chunks of LP_CHUNK frames, which the warp copies in by cp.async a chunk
//   ahead (ctc_lattice.cuh copy_ahead); a blank's emission is one load a
//   frame for all of a lane's blank states.
// - Backpointers are 2 bits a state, packed into one 32-bit word a lane a
//   frame (two for P > 16), so a frame's are 128 or 256 coalesced bytes.
//   Where all T frames' words fit beside the ring (T x 128 B = 38.5 KB at
//   the path's T 301, S 257), they stay in shared memory. Where they do not
//   (B64 T1500 S801: 384 KB a row), they go through a ring of two chunks of
//   BP_CHUNK frames, each chunk written out to a device scratch in 16-byte
//   stores when it is full, off the chain; the last two chunks never leave.
// - The backtrace runs in the same warp right after the forward: every lane
//   walks the same states (so their loads are one broadcast, and their
//   stores of each char's frame one store), keeping the state as (lane, k)
//   and extracting 2 bits a frame from shared memory. The next frame's word
//   is read before this frame's move is known, in both columns the state
//   can move to, so the shared-memory latency overlaps the decode. In the
//   spill case the warp copies the chunks back by cp.async, one chunk ahead
//   of the walk. No second launch, and no dependent device-memory load.
//
// viterbi_forward + viterbi_backtrace (the block pair, S > WARP_S_MAX, to S
// 32 * 1024). The forward gives one block to each row and one thread to
// each state (K per thread past 1024 states), alpha double-buffered in shared
// memory and one __syncthreads() a frame; frame t+1's C-wide log-prob row is
// staged in shared memory while frame t is computed, and each state gathers
// from it. Backpointers go to device memory as int8, one coalesced S-byte row
// per frame. The backtrace is a second kernel, one thread per row, walking
// xlen dependent device-memory byte loads.
#include "ctc_lattice.cuh"

namespace {

// ops/align.py reads WARP_S_MAX from this line: the most states the route
// gives the warp kernel, which reaches 32 * P_MAX
constexpr int WARP_S_MAX = 1023;
constexpr int P_MAX = 32;     // states a lane of the warp kernel at most
constexpr int LP_CHUNK = 16;  // log-prob frames copied together
constexpr int BP_CHUNK = 64;  // backpointer frames written out, and read back, together
constexpr int ROWS = 4;       // rows (warps) a block of the warp kernel at most
constexpr unsigned FULL = 0xffffffffu;

// states a lane of the warp kernel for a lattice of S states: ceil(S / 32)
// rounded up to even, at least 2
int lane_states(int S) {
  const int p = (S + 31) / 32;
  return p < 2 ? 2 : p + (p & 1);
}
// 32-bit words of a frame's backpointers a lane keeps: 2 bits a state
__host__ __device__ constexpr int bp_words(int P) { return P > 16 ? 2 : 1; }

// 4-byte words of one row's shared memory in the warp kernel, a multiple of
// 4: the log-prob ring (two chunks of LP_CHUNK frames, copied from any
// 4-byte boundary), then the backpointer words of `frames` frames
__host__ __device__ inline long warp_row_words(int C, int W, int frames) {
  return 2L * area(LP_CHUNK * C) + (long)frames * 32 * W;
}

// frames of backpointers a row keeps in shared memory: all T, or 0 where
// they do not fit and the row goes through the ring of 2 * BP_CHUNK frames
int resident_frames(int T, int C, int W) {
  return 4 * warp_row_words(C, W, T) <= SMEM_LIMIT ? T : 0;
}

// P = states a lane (even, 2..P_MAX). blockDim.x = 32 * rows: warp r of
// block x owns row x * rows + r. spill: null where all T frames'
// backpointers stay in shared memory; else (B, T, 32 * W) words of device
// scratch for the chunks that leave it.
template <int P>
__global__ void __launch_bounds__(32 * ROWS)
viterbi_warp(const float* __restrict__ log_probs, const int* __restrict__ targets,
             const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
             int B, int T, int C, int L, int blank, uint32_t* __restrict__ spill,
             float* __restrict__ final_alpha, int* __restrict__ char_frames) {
  constexpr int W = bp_words(P);
  extern __shared__ __align__(16) float smem16[];
  const int S = 2 * L + 1;
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + r;
  if (b >= B) return;
  // frame t's words at bp + (t & slot_mask) * 32 * W: all T frames, or a ring
  // of two chunks of BP_CHUNK
  const int slot_mask = spill ? 2 * BP_CHUNK - 1 : -1;
  const int cw = area(LP_CHUNK * C);
  float* ring = smem16 + (size_t)r * warp_row_words(C, W, spill ? 2 * BP_CHUNK : T);
  uint32_t* bp = reinterpret_cast<uint32_t*>(ring + 2 * cw);

  const int xl = min(max(input_lengths[b], 0), T);
  const int yl = min(max(target_lengths[b], 0), L);
  const float* lp = log_probs + (size_t)b * T * C;
  const int* tg = targets + (size_t)b * L;
  float* fa = final_alpha + (size_t)b * S;
  int* out = char_frames + (size_t)b * L;
  for (int l = lane; l < L; l += 32) out[l] = 0;
  if (xl == 0) {
    for (int s = lane; s < S; s += 32) fa[s] = NEG_INF;
    return;
  }

  // log-prob chunk j holds frames j * LP_CHUNK .. below xlen; one commit
  // group a chunk (an empty one past xlen)
  const int chunks = (xl + LP_CHUNK - 1) / LP_CHUNK;
  auto issue = [&](int j) {
    if (j < chunks)
      copy_ahead(ring + (j & 1) * cw, lp + (size_t)j * LP_CHUNK * C,
                 (min(xl, (j + 1) * LP_CHUNK) - j * LP_CHUNK) * C, lane, 32);
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // the lane's states s0 + k: even k a blank, odd k the label (s0 + k) >> 1
  const int s0 = lane * P;
  int lab[P / 2];
  // a label state's s-2 term gets NEG_INF added where it may not skip
  float no_skip[P / 2];
  unsigned row_bits = 0;
#pragma unroll
  for (int h = 0; h < P / 2; ++h) {
    const int j = s0 / 2 + h;
    lab[h] = j < L ? min(max(tg[j], 0), C - 1) : blank;
    const bool skip = j >= 1 && j < L && lab[h] != min(max(tg[j - 1], 0), C - 1);
    no_skip[h] = skip ? 0.0f : NEG_INF;
  }
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (s0 + k < 2 * yl + 1) row_bits |= 1u << k;

  float a[P];
  cp_async_wait<1>();  // this lane's copies of chunk 0 have landed
  __syncwarp();        // and every lane's
  {
    const float* row = ring + lead(lp);
    const float eb = row[blank];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float e = pick(row_bits >> k & 1, (k & 1) ? row[lab[k >> 1]] : eb, NEG_INF);
      a[k] = pick(s0 + k <= 1, e, NEG_INF);
    }
  }

  // spill: the full chunk of backpointer frames that ends at frame t, out to
  // the scratch; the last two chunks of the row stay for the backtrace
  const int last_chunk = (xl - 1) / BP_CHUNK;
  auto write_out = [&](int t) {
    const int c0 = t + 1 - BP_CHUNK;
    __syncwarp();  // every lane's words of the chunk are in shared memory
    const uint4* src = reinterpret_cast<const uint4*>(bp + (c0 & slot_mask) * 32 * W);
    uint4* dst = reinterpret_cast<uint4*>(spill + ((size_t)b * T + c0) * 32 * W);
    for (int q = lane; q < BP_CHUNK * 8 * W; q += 32) dst[q] = src[q];
  };

  int t = 1;
#pragma unroll 1
  for (int j = 0; j < chunks; ++j) {
    if (j > 0) {
      cp_async_wait<1>();  // chunk j's log-probs have landed
      __syncwarp();
    }
    const float* rows = ring + (j & 1) * cw + lead(lp + (size_t)j * LP_CHUNK * C);
    const int t_end = min(xl, (j + 1) * LP_CHUNK);
#pragma unroll 1
    for (; t < t_end; ++t) {
      const float* row = rows + (t - j * LP_CHUNK) * C;
      const float eb = row[blank];
      // s-1 of the lane's first state and s-2 of its second: the previous
      // lane's last state
      const float up = pick(lane == 0, NEG_INF, __shfl_up_sync(FULL, a[P - 1], 1));
      uint32_t word[W];
#pragma unroll
      for (int w = 0; w < W; ++w) word[w] = 0;
      float next[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        // the plain version's operations in its order
        const float stay = a[k];
        const float prev1 = k ? a[k - 1] : up;
        uint32_t best = prev1 > stay ? 1u : 0u;
        float val = fmaxf(stay, prev1);
        float e = eb;
        if (k & 1) {
          const float prev2 = (k >= 2 ? a[k - 2] : up) + no_skip[k >> 1];
          if (prev2 > val) best = 2u;
          val = fmaxf(val, prev2);
          e = row[lab[k >> 1]];
        }
        next[k] = fmaxf(val + e, NEG_INF);
        word[k >> 4] |= best << (2 * (k & 15));
      }
#pragma unroll
      for (int k = 0; k < P; ++k) a[k] = next[k];
      uint32_t* bp_t = bp + (t & slot_mask) * 32 * W;
#pragma unroll
      for (int w = 0; w < W; ++w) bp_t[w * 32 + lane] = word[w];
      if (spill && (t + 1) % BP_CHUNK == 0 && t / BP_CHUNK + 2 <= last_chunk) write_out(t);
    }
    __syncwarp();  // every lane is done with chunk j's log-probs
    issue(j + 2);
  }

  // a state past the row's own lattice stays at -1e30 in the plain version
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (s0 + k < S) fa[s0 + k] = pick(row_bits >> k & 1, a[k], NEG_INF);

  // the start: 2*ylen-1 where its final alpha >= that of 2*ylen
  const int end1 = 2 * yl - 1, end2 = 2 * yl;
  float a1 = NEG_INF, a2 = NEG_INF;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    a1 = pick(s0 + k == end1, a[k], a1);
    a2 = pick(s0 + k == end2, a[k], a2);
  }
  a1 = __shfl_sync(FULL, a1, max(end1, 0) / P);
  a2 = __shfl_sync(FULL, a2, end2 / P);
  const int state = (yl > 0 && a1 >= a2) ? end1 : end2;

  // The backtrace, by every lane in step, each storing the same char frames:
  // the state as (lane ln, k), its backpointers in word column
  // (k >> 4) * 32 + ln of a frame. Walking back the state never increases,
  // so the first frame met in state 2l+1 is the last frame of char l; it
  // moves down by at most two, so at frame t-1 it lies in its own column or
  // in that of the state two below, and both words are read while frame t's
  // move is decoded.
  __syncwarp();  // every lane's backpointer words are in shared memory
  int ln = state / P, k = state - ln * P;
  auto bp_word = [&](int tt, int ln_, int k_) {
    return bp[(tt & slot_mask) * 32 * W + (k_ >> 4) * 32 + ln_];
  };
  t = xl - 1;
  uint32_t wd = bp_word(t, ln, k);
  int last = -1;
#pragma unroll 1
  for (; t > 0; --t) {
    if (spill && (t & (BP_CHUNK - 1)) == 0) {
      // frame t-1 lies in chunk q-1: the last two chunks never left shared
      // memory, the others come back one chunk ahead of the walk, each into
      // the slot that the chunk above it left
      const int q = t / BP_CHUNK;
      if (q + 1 <= last_chunk) cp_async_wait<0>();
      __syncwarp();
      if (q >= 2) {
        copy_ahead(reinterpret_cast<float*>(bp + ((q - 2) * BP_CHUNK & slot_mask) * 32 * W),
                   reinterpret_cast<const float*>(
                       spill + ((size_t)b * T + (q - 2) * BP_CHUNK) * 32 * W),
                   BP_CHUNK * 32 * W, lane, 32);
        cp_async_commit();
      }
    }
    const int k2 = k >= 2 ? k - 2 : k - 2 + P;
    const uint32_t w_same = bp_word(t - 1, ln, k);
    const uint32_t w_below = bp_word(t - 1, k >= 2 ? ln : max(ln - 1, 0), k2);
    const int s = ln * P + k;
    if ((k & 1) && s != last) {
      out[s >> 1] = t;
      last = s;
    }
    const int m = (int)(wd >> (2 * (k & 15)) & 3);
    wd = (k & 15) >= m ? w_same : w_below;
    k -= m;
    if (k < 0) {
      k += P;
      --ln;
    }
  }
  // (frame 0 would record 0, which every char already holds)
}

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
  cudaError_t err = allow_shared(viterbi_forward<K>, smem);
  if (err != cudaSuccess) return err;
  viterbi_forward<K><<<B, threads, smem, stream>>>(log_probs, targets, input_lengths,
                                                   target_lengths, T, C, L, blank, bp,
                                                   final_alpha);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_warp(const float* log_probs, const int* targets, const int* input_lengths,
                        const int* target_lengths, int B, int T, int C, int L, int blank,
                        uint32_t* spill, float* final_alpha, int* char_frames,
                        cudaStream_t stream) {
  const long words = warp_row_words(C, bp_words(P), spill ? 2 * BP_CHUNK : T);
  const long fit = SMEM_LIMIT / (4 * words);
  int rows = fit < ROWS ? (int)fit : ROWS;
  if (B < rows) rows = B;
  if (rows < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * words * sizeof(float);
  cudaError_t err = allow_shared(viterbi_warp<P>, smem);
  if (err != cudaSuccess) return err;
  viterbi_warp<P><<<(B + rows - 1) / rows, 32 * rows, smem, stream>>>(
      log_probs, targets, input_lengths, target_lengths, B, T, C, L, blank, spill, final_alpha,
      char_frames);
  return cudaGetLastError();
}

// launch(std::integral_constant<int, P>()) for P = P0, P0 + 2, ..., P_MAX;
// cudaErrorInvalidValue for any other P
template <int P0, typename Launch>
cudaError_t with_lane_states(int P, Launch launch) {
  if constexpr (P0 > P_MAX) {
    return cudaErrorInvalidValue;
  } else {
    if (P == P0) return launch(std::integral_constant<int, P0>());
    return with_lane_states<P0 + 2>(P, launch);
  }
}

// Whether the warp kernel reaches a lattice of S states over C classes:
// S <= 32 * P_MAX, and one row's buffers (the spill route's, the smallest)
// fit a block's shared memory.
bool warp_reaches(int S, int C) {
  return S >= 1 && C > 0 && S <= 32 * P_MAX &&
         4 * warp_row_words(C, bp_words(lane_states(S)), 2 * BP_CHUNK) <= SMEM_LIMIT;
}

}  // namespace

// 1 where the route gives the warp kernel a lattice of L labels over C
// classes: S = 2L+1 <= WARP_S_MAX, and the kernel reaches it; else 0
// (ops/align.py sends such a lattice to the block pair).
extern "C" int ctc_viterbi_warp_fits(int L, int C) {
  const int S = 2 * L + 1;
  return L >= 0 && S <= WARP_S_MAX && warp_reaches(S, C);
}

// 4-byte words of device scratch a row of the warp kernel needs for T frames
// of L labels over C classes: 0 where all T frames' backpointers stay in
// shared memory, else T * 32 * (1 or 2).
extern "C" int ctc_viterbi_warp_spill_words(int T, int L, int C) {
  const int W = bp_words(lane_states(2 * L + 1));
  return resident_frames(T, C, W) ? 0 : T * 32 * W;
}

// Launches the warp kernel (forward and backtrace in one) on `stream`;
// returns the CUDA error code (0 = launched). Shapes as ctc_viterbi_align;
// log_probs starts on 16 bytes; spill: B * ctc_viterbi_warp_spill_words
// 4-byte words on 16 bytes, or null where that is 0. No int8 backpointer
// tensor. cudaErrorInvalidValue for a lattice the kernel does not reach, a
// misaligned log_probs or spill, or a missing spill.
extern "C" int ctc_viterbi_align_warp(const float* log_probs, const int* targets,
                                      const int* input_lengths, const int* target_lengths,
                                      int B, int T, int C, int L, int blank, uint32_t* spill,
                                      float* final_alpha, int* char_frames, void* stream_ptr) {
  const int S = 2 * L + 1;
  const int P = lane_states(S);
  if (L < 0 || !warp_reaches(S, C) ||
      ((reinterpret_cast<uintptr_t>(log_probs) | reinterpret_cast<uintptr_t>(spill)) & 15) ||
      (spill == nullptr) != (resident_frames(T, C, bp_words(P)) > 0))
    return (int)cudaErrorInvalidValue;
  return (int)with_lane_states<2>(P, [&](auto p) {
    return launch_warp<decltype(p)::value>(log_probs, targets, input_lengths, target_lengths, B,
                                           T, C, L, blank, spill, final_alpha, char_frames,
                                           (cudaStream_t)stream_ptr);
  });
}

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
  const size_t smem = (size_t)(2 * S + 2 * C) * sizeof(float);
  cudaError_t err = with_states_per_thread(S, [&](auto k) {
    return launch_forward<decltype(k)::value>(log_probs, targets, input_lengths, target_lengths,
                                              B, T, C, L, blank, bp, final_alpha,
                                              block_threads(S), smem, stream);
  });
  if (err != cudaSuccess) return (int)err;
  if (L > 0) {
    viterbi_backtrace<<<(B + 127) / 128, 128, 0, stream>>>(bp, final_alpha, input_lengths,
                                                           target_lengths, B, T, L, char_frames);
    err = cudaGetLastError();
  }
  return (int)err;
}
