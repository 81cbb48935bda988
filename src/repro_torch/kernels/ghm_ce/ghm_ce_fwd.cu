// The forward of the fused GHM-weighted cross-entropy for Hopper (sm_90a):
// the CUDA C++ port of the Pallas TPU kernel src/repro/kernels/ghm_ce/kernel.py
// ghm_ce_pallas (_kernel :29, pallas_call :240).
//
// Client logits cl (K, B, V), f32 or bf16, contiguous; labels (B,) int32 or
// int64; w (K,) f32. With t = sum_k w_k cl_k, per row of the batch:
//
//   lse = m + log D,  D = sum_v e^(t_v - m)
//   ly  = t[label]
//   out = (1 - e^(ly - lse)) (lse - ly)   (weighted: Eq. 5-6)
//       = lse - ly                        (plain CE: Eq. 11)
//
// written as the rows of res (3, B) f32: out, lse, ly (the last two are the
// backward's residuals). The combine t is formed in registers and never
// reaches memory.
//
// Bound. Bytes: each element of cl is read once, for 2K + ~6 flops. At
// K=5, B=37, V=32003 in f32 that is 23.7 MB, 7.1 us at 3.35 TB/s; at the
// main path's K=5, B=128, V=10 it is 26 KB, 8.4 ns: there a call costs one
// launch's latency and what the host spends on it.
//
// Design: that of ensemble_kl_fwd.cu beside the ensemble-KL wrapper, which
// says more. Rows are owned: by a group of up to 32 lanes of one warp where
// V <= 1024 (two rows of 16 lanes a warp at V=10), merged through a fixed
// xor butterfly of shuffles; else by a block, whose warps merge through a
// butterfly of 8 lanes, and when B blocks cannot put two on every SM, by S
// blocks over contiguous column ranges, whose partials (m, D, ly) the last
// block to take an integer ticket merges (a group of lanes a row: each lane
// at most 4 splits in split order, then the butterfly). The grid comes from the
// shapes alone (kernels/build.py loss_fwd_geometry). ly is the label
// column's t, contributed by the one lane (and split) that holds it and
// merged by a sum that is exact, all other terms being 0. Accesses of 16
// bytes where V and every plane allow it, else two single elements a group
// width apart; all K planes of a step loaded before any is used, and the
// step's columns folded into the statistics together (their maximum, then
// one rescale), in base 2 (t log2(e): one exp2 each). A lane with no column
// carries m = -1e30, D = 0; a masked column of a step is -inf. No float
// atomics: a second call and a CUDA-graph replay give the same bits. The
// scratch and the ticket are the wrapper's (kernels/build.py loss_scratch),
// shared by the four loss kernels; every launch leaves the ticket at 0, and
// two calls at once on two streams are not supported.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 3;                // resident blocks per SM: kernels/build.py LOSS_FWD_BLOCKS_PER_SM
constexpr int MAX_ITEMS = 132 * MIN_BLOCKS;  // (row, split) pairs of a split launch: the partials the last block stages
constexpr int KREG = 8;                      // client planes a step loads ahead
constexpr int NSTAT = 3;                     // floats of a partial
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC consecutive elements, moved as one access of at most 16 bytes
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Vec { T x[VEC]; };

template <typename T, int VEC> __device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  Vec<T, VEC> v;
  if constexpr (sizeof(v) == 16) {
    *reinterpret_cast<uint4*>(&v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (sizeof(v) == 8) {
    *reinterpret_cast<uint2*>(&v) = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v.x[i] = p[i];
  }
  return v;
}

// The online statistics of some columns of a row
struct Stats {
  float m, d;  // over t2 = t log2(e), so each exponential is one exp2: running max of t2, sum of 2^(t2 - m)
  float ly;    // the label column's t, or 0 where it is not among them
};

__device__ __forceinline__ Stats no_columns() { return Stats{NEG, 0.f, 0.f}; }

// N columns of a step at once (t: -inf where masked): their maximum
// first, then one rescale of the running sum, so the columns'
// exponentials are independent of each other
template <int N>
__device__ __forceinline__ void push(Stats& a, const float (&t)[N]) {
  float m = a.m;
#pragma unroll
  for (int i = 0; i < N; ++i) m = fmaxf(m, t[i]);
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) d += exp2f(t[i] - m);
  a.d = fmaf(a.d, exp2f(a.m - m), d);
  a.m = m;
}

// one exponential: the side with the smaller maximum is scaled by
// 2^-(the difference)
__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  const float e = exp2f(-fabsf(a.m - b.m));
  return a.m >= b.m ? Stats{a.m, fmaf(b.d, e, a.d), a.ly + b.ly} : Stats{b.m, fmaf(a.d, e, b.d), a.ly + b.ly};
}

__device__ __forceinline__ Stats shfl_xor(const Stats& a, int o) {
  return Stats{__shfl_xor_sync(0xffffffffu, a.m, o), __shfl_xor_sync(0xffffffffu, a.d, o),
               __shfl_xor_sync(0xffffffffu, a.ly, o)};
}

__device__ __forceinline__ void write_row(float* res, int B, int r, const Stats& a, bool weighted) {
  const float lse = (log2f(a.d) + a.m) * LN2;
  float nll = lse - a.ly;
  if (weighted) nll *= 1.f - expf(a.ly - lse);
  res[r] = nll;
  res[B + r] = lse;
  res[2 * B + r] = a.ly;
}

struct Args {
  const void* cl;
  const void* labels;
  const float* w;
  float* res;
  float* part;
  unsigned int* ticket;
  int K, B, V;
  bool weighted, label64;
  int lanes, splits, span;
};

// VEC: elements per access; U: accesses per lane and plane in a step
template <typename TC, int VEC, int U>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ghm_ce_fwd_kernel(const Args a) {
  __shared__ Stats swarp[WARPS];
  __shared__ float spart[MAX_ITEMS * NSTAT];
  __shared__ unsigned int is_last;
  const TC* __restrict__ cl = static_cast<const TC*>(a.cl);
  const int K = a.K, B = a.B, V = a.V, G = a.lanes, S = a.splits;
  const size_t plane = (size_t)B * V;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = THREADS / G, j = tid & (G - 1);  // rows of a block's item; this thread's lane in its group
  const int items = (B + rows - 1) / rows * S;

  float wk[KREG];
#pragma unroll
  for (int k = 0; k < KREG; ++k) wk[k] = k < K ? a.w[k] : 0.f;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int row = item / S * rows + tid / G;
    const int c0 = item % S * a.span, c1 = min(V, c0 + a.span);
    Stats acc = no_columns();
    if (row < B) {
      const long long label = a.label64 ? static_cast<const long long*>(a.labels)[row]
                                        : static_cast<const int*>(a.labels)[row];
      const size_t base = (size_t)row * V;
      for (int c = c0 + j * VEC; c < c1; c += G * VEC * U) {
        // every load of the step first
        Vec<TC, VEC> x[U][KREG];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int cc = c + u * G * VEC;  // V is a multiple of VEC: an access is wholly in or out
          if (cc < c1) {
#pragma unroll
            for (int k = 0; k < KREG; ++k)
              if (k < K) x[u][k] = load<TC, VEC>(cl + k * plane + base + cc);
          }
        }
        float t[U * VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int cc = c + u * G * VEC;
          float tu[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) tu[i] = 0.f;
          if (cc < c1) {
#pragma unroll
            for (int k = 0; k < KREG; ++k)
              if (k < K) {
#pragma unroll
                for (int i = 0; i < VEC; ++i) tu[i] = fmaf(wk[k], to_f(x[u][k].x[i]), tu[i]);
              }
            for (int k = KREG; k < K; ++k) {
              const Vec<TC, VEC> xk = load<TC, VEC>(cl + k * plane + base + cc);
              const float wkk = a.w[k];
#pragma unroll
              for (int i = 0; i < VEC; ++i) tu[i] = fmaf(wkk, to_f(xk.x[i]), tu[i]);
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              if (cc + i == label) acc.ly = tu[i];
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) t[u * VEC + i] = cc < c1 ? tu[i] * LOG2E : -INFINITY;
        }
        push(acc, t);
      }
    }
    if (G <= 32) {  // a group of lanes owns the row (and S is 1)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o < G) acc = merge(acc, shfl_xor(acc, o));
      if (j == 0 && row < B) write_row(a.res, B, row, acc, a.weighted);
    } else {  // the block owns the row, or a split of it
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc = merge(acc, shfl_xor(acc, o));
      if (lane == 0) swarp[warp] = acc;
      __syncthreads();
      if (warp == 0) {  // the warps' statistics through a butterfly of WARPS lanes
        Stats r = lane < WARPS ? swarp[lane] : no_columns();
#pragma unroll
        for (int o = WARPS / 2; o > 0; o >>= 1) r = merge(r, shfl_xor(r, o));
        if (lane == 0 && S == 1) {
          write_row(a.res, B, row, r, a.weighted);
        } else if (lane == 0) {
          float* p = a.part + (size_t)item * NSTAT;
          p[0] = r.m, p[1] = r.d, p[2] = r.ly;
        }
      }
      __syncthreads();
    }
  }
  if (S == 1) return;

  // split rows: the last block to arrive merges each row's partials
  if (tid == 0) {  // thread 0 wrote the block's partials
    __threadfence();
    is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int q = 0; q < (MAX_ITEMS * NSTAT + THREADS - 1) / THREADS; ++q) {  // every partial in one round trip
    const int i = q * THREADS + tid;
    if (i < items * NSTAT) spart[i] = __ldcg(a.part + i);
  }
  __syncthreads();
  // a group of g lanes a row, g a power of two up to 32 that leaves each lane
  // at most 4 splits: each lane merges its splits in split order, then the
  // group through the butterfly
  int g = 1;
  while (g < 32 && 4 * g < S) g <<= 1;
  for (int r0 = 0; r0 < B; r0 += THREADS / g) {
    const int r = r0 + tid / g, l = tid & (g - 1);
    Stats m = no_columns();
    for (int s = l; r < B && s < S; s += g) {
      const float* p = spart + (r * S + s) * NSTAT;
      m = merge(m, Stats{p[0], p[1], p[2]});
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < g) m = merge(m, shfl_xor(m, o));
    if (l == 0 && r < B) write_row(a.res, B, r, m, a.weighted);
  }
  if (tid == 0) *a.ticket = 0u;
}

template <typename TC>
int launch(const Args& a, int vec, int blocks, cudaStream_t stream) {
  constexpr int VMAX = 16 / sizeof(TC);  // 16 bytes per access, or two single elements
  if (vec == 1)
    ghm_ce_fwd_kernel<TC, 1, 2><<<blocks, THREADS, 0, stream>>>(a);
  else if (vec == VMAX)
    ghm_ce_fwd_kernel<TC, VMAX, 1><<<blocks, THREADS, 0, stream>>>(a);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype code: 0 f32, 1 bf16; label code: 0 int32, 1 int64. res: (3, B) f32,
// written as out, lse, ly. weighted: 1 for Eq. 6, 0 for the plain CE. vec,
// lanes, splits, span, blocks, part and ticket as ensemble_kl_fwd takes them
// (part: 3 B splits floats). Returns the CUDA error of the launch (0: none),
// or -1 for arguments the kernel does not take.
extern "C" int ghm_ce_fwd(const void* cl, const void* labels, const float* w, float* res, float* part,
                          unsigned int* ticket, int K, int B, int V, int weighted, int dtype_cl, int label_code,
                          int vec, int lanes, int splits, int span, int blocks, void* stream) {
  const bool lane_rows = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (K <= 0 || B <= 0 || V <= 0 || blocks <= 0 || vec <= 0 || V % vec != 0 || span <= 0 || span % vec != 0 ||
      splits <= 0 || (long long)span * splits < V || (!lane_rows && lanes != THREADS) ||
      (label_code != 0 && label_code != 1) ||
      (splits > 1 && (lanes != THREADS || (long long)B * splits > MAX_ITEMS || part == nullptr || ticket == nullptr)))
    return -1;
  const Args a{cl, labels, w, res, part, ticket, K, B, V, weighted != 0, label_code == 1, lanes, splits, span};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_cl == 0) return launch<float>(a, vec, blocks, s);
  if (dtype_cl == 1) return launch<__nv_bfloat16>(a, vec, blocks, s);
  return -1;
}
