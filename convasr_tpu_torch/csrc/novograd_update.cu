// NovoGrad's whole update over every leaf of a model, with the global-norm
// clip in front and the train step's non-finite skip around it, and the batch
// norms' running statistics stashed before the forward and put back after a
// non-finite loss, for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package XLA fuses optax's update
// (convasr_tpu/train/optim.py novograd under train/loop.py's step). The
// port's chain is the plain version: train/optim.py clip_by_global_norm,
// scale_by_novograd and scale_by_schedule, and train/loop.py chain_update's
// skip and apply. The CPU takes it, and the card tests hold these kernels to
// it (ops/novograd_update.py).
//
// What they compute, for leaves i = 0..N-1 with gradients g, parameters p and
// momentum m (float32), NovoGrad's per-leaf EMA e_i, its step and the
// schedule's count (int32), the rate lr and the device flag `finite` (the
// loss is finite; g counts as 0 where it is not):
//   s_i   = sum g_i^2,  norm = sqrt(sum_i s_i)             (grad_norm)
//   clip  = max_norm > 0 and !(norm < max_norm)
//   u     = clip ? (g / norm) * max_norm : g
//   s'_i  = clip ? s_i (max_norm / norm)^2 : s_i           (sum u_i^2)
//   e_i   = step == 0 ? s'_i : e_i b2 + s'_i (1 - b2)
//   d     = u / sqrt(e_i + eps) + wd p                     (the wd term for wd > 0)
//   m     = m b1 + d
//   p     = p + (-m) lr
//   step, count += 1;  weight_norm = sqrt(sum p^2) over the new p
// Each elementwise step rounds where the chain's does (__fmul_rn, __fadd_rn,
// __fdiv_rn: nothing contracted into an FMA), so the kernels differ from the
// chain only in the order of the sums of squares and in s'_i, which the chain
// sums from u. Where `finite` is false they write only grad_norm (0) and
// weight_norm: p, m, e, step and count stay bit for bit, as the chain's
// selects keep them.
//
// What bounds them on this card: bytes. The norm kernel reads each gradient
// once; the update kernel reads g, p and m and writes p and m: 6 float32 sets
// of the parameters' size (4.24 GB for JasperNetBig with the char head, 1.27
// ms at 3.35 TB/s). The chain moved about 37 such sets in ~2,100 launches.
//
// What the design does about it. Two launches over a table of every leaf,
// passed in the kernel parameter space (__grid_constant__, up to MAX_LEAVES
// leaves, 28 KB of the 32,764 bytes CUDA 12.1 allows): the gradients'
// addresses change every step, so the table is made at each launch, with no
// copy of its own. Each block takes CHUNK elements of one leaf, found by a
// binary search of the leaves' first chunks, in 16-byte loads where the
// leaf's tensors lie on 16-byte boundaries. The sums reduce with no float
// atomics, in a fixed order: each block writes its partial sum; the last
// block to finish (an integer counter, reset by that block) adds them up,
// leaf by leaf in the norm kernel, so that two runs give the same bits. The
// norm kernel's last block then takes the clip's decision and computes the
// EMA, each leaf's sqrt(e + eps) and the counters; the update kernel reads
// them from device memory, so no value goes to the host and the step never
// waits for the card.
//
// The batch norms' running statistics (two vectors of a few hundred to two
// thousand values a norm, ~180 tensors) go to one flat buffer before the
// forward and come back from it after the update where `finite` is false:
// one launch each, a block a tensor (the chain: a clone of each before the
// forward, a select and a copy of each after).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 896;  // tensors in a launch's table
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8192;      // elements a block: 8 float4 a thread

struct Leaves {
  const float* g[MAX_LEAVES];
  float* p[MAX_LEAVES];
  float* m[MAX_LEAVES];
  int numel[MAX_LEAVES];
  int first_chunk[MAX_LEAVES + 1];
  int n;
};
// the largest kernel's other arguments take under 128 bytes
static_assert(sizeof(Leaves) + 128 <= 32764, "the leaf table must fit the kernel parameter space");

struct Tensors {
  float* t[MAX_LEAVES];
  int offset[MAX_LEAVES + 1];  // into the flat buffer; tensor j has offset[j+1] - offset[j]
  int n;
};

// the last leaf whose first chunk is at or before `block` (leaves of no
// element share their successor's first chunk and are never found)
__device__ __forceinline__ int leaf_of(const Leaves& t, int block) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= block)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum, in thread 0, in the same order every run; `shared` holds
// WARPS values and is free again after the next barrier
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < WARPS ? shared[threadIdx.x] : T(0);
  if (threadIdx.x < 32) v = warp_sum(v);
  return v;
}

// Whether this block is the grid's last to finish; thread 0 has stored the
// block's partial sum. The fence orders that store before the count.
__device__ __forceinline__ bool last_block(unsigned* counter) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

__global__ void __launch_bounds__(THREADS)
    norm_kernel(const __grid_constant__ Leaves t, const bool* finite, float* partial,
                unsigned* counter, float* denom, float* clip_state, float* grad_norm, float* ema,
                int* step, int* count, float b2, float one_minus_b2, float eps, float max_norm) {
  __shared__ float red[WARPS];
  __shared__ double red_d[WARPS];
  __shared__ float sums[MAX_LEAVES];
  __shared__ float norm_s;
  __shared__ bool clip_s;
  const bool go = *finite;
  float s = 0.f;
  if (go) {
    const int i = leaf_of(t, blockIdx.x);
    const int base = (blockIdx.x - t.first_chunk[i]) * CHUNK;
    const int len = min(CHUNK, t.numel[i] - base);
    const float* __restrict__ g = t.g[i] + base;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
      const int n4 = len >> 2;
#pragma unroll 4
      for (int v = threadIdx.x; v < n4; v += THREADS) {
        const float4 x = g4[v];
        s += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      }
      done = n4 << 2;
    }
    for (int e = done + threadIdx.x; e < len; e += THREADS) s += g[e] * g[e];
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
  if (!last_block(counter)) return;

  // the last block: every partial sum is in device memory
  const bool first = *step == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < t.n; i += WARPS) {
    double a = 0.0;
    for (int c = t.first_chunk[i] + lane; c < t.first_chunk[i + 1]; c += 32)
      a += (double)__ldcg(partial + c);
    a = warp_sum(a);
    if (lane == 0) sums[i] = (float)a;
  }
  __syncthreads();
  double total = 0.0;
  for (int i = threadIdx.x; i < t.n; i += THREADS) total += (double)sums[i];
  total = block_sum(total, red_d);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn((float)total);
    const bool clip = max_norm > 0.f && !(norm < max_norm);
    norm_s = norm;
    clip_s = clip;
    clip_state[0] = norm;
    clip_state[1] = clip ? 1.f : 0.f;
    *grad_norm = norm;
  }
  __syncthreads();
  const bool clip = clip_s;
  const double r = clip ? (double)max_norm / (double)norm_s : 1.0;
  for (int i = threadIdx.x; i < t.n; i += THREADS) {
    const float s2 = clip ? (float)((double)sums[i] * r * r) : sums[i];
    const float e = first ? s2 : __fadd_rn(__fmul_rn(ema[i], b2), __fmul_rn(s2, one_minus_b2));
    denom[i] = __fsqrt_rn(__fadd_rn(e, eps));
    if (go) ema[i] = e;
  }
  __syncthreads();  // every thread has read *step
  if (threadIdx.x == 0) {
    if (go) {
      *step += 1;
      *count += 1;
    }
    *counter = 0;
  }
}

struct Rule {
  float norm, max_norm, denom, b1, wd, lr;
  bool clip;
};

// the chain's operations on one element, in its order and roundings
__device__ __forceinline__ void novograd(const Rule& k, float g, float& p, float& m) {
  const float u = k.clip ? __fmul_rn(__fdiv_rn(g, k.norm), k.max_norm) : g;
  float d = __fdiv_rn(u, k.denom);
  if (k.wd > 0.f) d = __fadd_rn(d, __fmul_rn(p, k.wd));
  m = __fadd_rn(__fmul_rn(m, k.b1), d);
  p = __fadd_rn(p, __fmul_rn(-m, k.lr));
}

__global__ void __launch_bounds__(THREADS)
    update_kernel(const __grid_constant__ Leaves t, const bool* finite, const float* clip_state,
                  const float* denom, const float* lr_ptr, float lr_value, float b1, float wd,
                  float max_norm, float* partial, unsigned* counter, float* weight_norm) {
  __shared__ float red[WARPS];
  __shared__ double red_d[WARPS];
  const bool go = *finite;
  const int i = leaf_of(t, blockIdx.x);
  const int base = (blockIdx.x - t.first_chunk[i]) * CHUNK;
  const int len = min(CHUNK, t.numel[i] - base);
  const float* __restrict__ g = t.g[i] + base;
  float* __restrict__ p = t.p[i] + base;
  float* __restrict__ m = t.m[i] + base;
  Rule k;
  k.norm = clip_state[0];
  k.clip = clip_state[1] != 0.f;
  k.max_norm = max_norm;
  k.denom = denom[i];
  k.b1 = b1;
  k.wd = wd;
  k.lr = lr_ptr != nullptr ? *lr_ptr : lr_value;
  float s = 0.f;
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(p) |
        reinterpret_cast<uintptr_t>(m)) & 15) == 0) {
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
    float4* __restrict__ p4 = reinterpret_cast<float4*>(p);
    float4* __restrict__ m4 = reinterpret_cast<float4*>(m);
    const int n4 = len >> 2;
#pragma unroll 4
    for (int v = threadIdx.x; v < n4; v += THREADS) {
      float4 pv = p4[v];
      if (go) {
        const float4 gv = g4[v];
        float4 mv = m4[v];
        novograd(k, gv.x, pv.x, mv.x);
        novograd(k, gv.y, pv.y, mv.y);
        novograd(k, gv.z, pv.z, mv.z);
        novograd(k, gv.w, pv.w, mv.w);
        m4[v] = mv;
        p4[v] = pv;
      }
      s += pv.x * pv.x + pv.y * pv.y + pv.z * pv.z + pv.w * pv.w;
    }
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < len; e += THREADS) {
    float pv = p[e];
    if (go) {
      float mv = m[e];
      novograd(k, g[e], pv, mv);
      m[e] = mv;
      p[e] = pv;
    }
    s += pv * pv;
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
  if (!last_block(counter)) return;

  double a = 0.0;
  for (int c = threadIdx.x; c < (int)gridDim.x; c += THREADS) a += (double)__ldcg(partial + c);
  a = block_sum(a, red_d);
  if (threadIdx.x == 0) {
    *weight_norm = __fsqrt_rn((float)a);
    *counter = 0;
  }
}

// back == 0: every tensor into the flat buffer; back != 0: the flat buffer
// into the tensors, only where `finite` is false
__global__ void __launch_bounds__(THREADS)
    stash_kernel(const __grid_constant__ Tensors t, float* flat, int back, const bool* finite) {
  if (back && *finite) return;
  const int j = blockIdx.x;
  float* x = t.t[j];
  float* f = flat + t.offset[j];
  const int n = t.offset[j + 1] - t.offset[j];
  for (int e = threadIdx.x; e < n; e += THREADS) {
    if (back)
      x[e] = f[e];
    else
      f[e] = x[e];
  }
}

// The leaves' table; returns its chunks (the grid), or 0 where n is out of
// range, a leaf is empty past 2^31 - CHUNK elements, or no element is there.
int fill_leaves(Leaves& t, const int64_t* g, const int64_t* p, const int64_t* m,
                const int* numel, int n) {
  if (n < 1 || n > MAX_LEAVES) return 0;
  long long chunks = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0 || numel[i] > 2147483647 - CHUNK) return 0;
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.p[i] = p != nullptr ? reinterpret_cast<float*>(p[i]) : nullptr;
    t.m[i] = m != nullptr ? reinterpret_cast<float*>(m[i]) : nullptr;
    t.numel[i] = numel[i];
    t.first_chunk[i] = (int)chunks;
    chunks += (numel[i] + CHUNK - 1) / CHUNK;
    if (chunks > 2147483647LL) return 0;
  }
  t.first_chunk[n] = (int)chunks;
  t.n = n;
  return (int)chunks;
}

}  // namespace

// The norm pass on `stream` (arguments as ops/novograd_update.py passes
// them): the leaves' gradients (addresses) and sizes, the flag, scratch of
// the grid's partial sums, a zeroed counter, N denominators and the clip's
// two values, the grad_norm output, and NovoGrad's EMA (N,), step and the
// schedule's count, updated in place. Returns the CUDA error.
extern "C" int novograd_norm(const int64_t* grads, const int* numel, int n, const bool* finite,
                             float* partial, unsigned* counter, float* denom, float* clip_state,
                             float* grad_norm, float* ema, int* step, int* count, float b2,
                             float one_minus_b2, float eps, float max_norm, void* stream_ptr) {
  Leaves t;
  const int chunks = fill_leaves(t, grads, nullptr, nullptr, numel, n);
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  norm_kernel<<<chunks, THREADS, 0, (cudaStream_t)stream_ptr>>>(
      t, finite, partial, counter, denom, clip_state, grad_norm, ema, step, count, b2,
      one_minus_b2, eps, max_norm);
  return (int)cudaGetLastError();
}

// The update pass on `stream`, after novograd_norm on the same leaves and
// scratch: the parameters and momentum (addresses) updated in place, the
// rate from lr (a float32 on the device) or, where lr is null, lr_value, and
// the weight_norm output. Returns the CUDA error.
extern "C" int novograd_apply(const int64_t* grads, const int64_t* params,
                              const int64_t* momentum, const int* numel, int n,
                              const bool* finite, const float* clip_state, const float* denom,
                              const float* lr, float lr_value, float b1, float wd, float max_norm,
                              float* partial, unsigned* counter, float* weight_norm,
                              void* stream_ptr) {
  Leaves t;
  const int chunks = fill_leaves(t, grads, params, momentum, numel, n);
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  update_kernel<<<chunks, THREADS, 0, (cudaStream_t)stream_ptr>>>(
      t, finite, clip_state, denom, lr, lr_value, b1, wd, max_norm, partial, counter,
      weight_norm);
  return (int)cudaGetLastError();
}

// Copies n float32 tensors (addresses, sizes) into the flat buffer (back 0)
// or, where *finite is false, back from it (back 1), on `stream`. Returns the
// CUDA error.
extern "C" int stash_tensors(const int64_t* tensors, const int* numel, int n, float* flat,
                             int back, const bool* finite, void* stream_ptr) {
  if (n < 1 || n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Tensors t;
  long long offset = 0;
  for (int j = 0; j < n; ++j) {
    if (numel[j] < 0) return (int)cudaErrorInvalidValue;
    t.t[j] = reinterpret_cast<float*>(tensors[j]);
    t.offset[j] = (int)offset;
    offset += numel[j];
    if (offset > 2147483647LL) return (int)cudaErrorInvalidValue;
  }
  t.offset[n] = (int)offset;
  t.n = n;
  stash_kernel<<<n, THREADS, 0, (cudaStream_t)stream_ptr>>>(t, flat, back, finite);
  return (int)cudaGetLastError();
}
