// The forward of the fused ensemble-KL loss for Hopper (sm_90a): the CUDA C++
// port of the Pallas TPU kernel src/repro/kernels/ensemble_kl/kernel.py
// ensemble_kl_pallas (_kernel :34, pallas_call :245).
//
// Client logits cl (K, B, V) and student logits st (B, V), f32 or bf16,
// contiguous; w (K,) f32. With t = sum_k w_k cl_k / T and s = st / T, per
// row of the batch:
//
//   out   = KL(softmax t || softmax s) T^2 = (N / D - lse_t + lse_s) T^2
//   lse_t = m_t + log D,    D = sum_v e^(t_v - m_t),  N = sum_v e^(t_v - m_t) (t_v - s_v)
//   lse_s = m_s + log D_s,  D_s = sum_v e^(s_v - m_s)
//
// written as the rows of res (3, B) f32: out, lse_t, lse_s (the last two
// are the backward's residuals). The combine t is formed in registers and
// never reaches memory.
//
// Bound. Bytes: each element of cl and st is read once, for 2K + ~10 flops
// (the K-step fma, the scaling, an exponential each for teacher and
// student). At K=5, B=37, V=32003 in f32 that is 28.4 MB, 8.5 us at
// 3.35 TB/s; at the main path's K=5, B=128, V=10 it is 31 KB, 9.6 ns: there
// a call costs one launch's latency and what the host spends on it.
//
// Design. The TPU kernel's (block_b, block_v) grid with its vocab-minor
// accumulator is not carried over: a row is owned by threads that merge in
// a fixed order, never through atomics, and the grid follows from the
// shapes alone (kernels/build.py loss_fwd_geometry), so every vocabulary
// covers the card.
//
// * Narrow rows (V <= 1024; the image path's 10, 100 or 200 classes): a
//   group of `lanes` lanes of one warp owns a row, a power of two up to 32
//   that covers the row's accesses. V=10 puts two rows on a warp, 16 lanes
//   each, and 16 rows on a block (8 blocks at the main shape). Each lane
//   walks its row's columns with stride `lanes`, keeps the online statistics
//   (m_t, D, N, m_s, D_s) in registers, and the group merges them through a
//   fixed xor butterfly of shuffles. At most the resident blocks are
//   launched; they loop over the row groups.
// * Wide rows: a block owns a row; its 8 warps' statistics meet in shared
//   memory and merge through a butterfly of 8 lanes. When B such blocks
//   cannot put two on every one of the 132 SMs (K=5, B=37, V=32003 would
//   give 37), each row is cut into S contiguous column ranges of at least
//   1024 columns, one block each (S=10 there: 370 blocks, all resident at
//   once). Thread 0 of each block writes the block's partial statistics to
//   the scratch `part`, fences and takes an integer ticket; the last block
//   to arrive stages every partial in shared memory in one round trip and
//   merges each row's with a group of lanes: each lane at most 4 splits in
//   split order, then the group's butterfly. It writes the rows and puts
//   the ticket back to 0. A second call and a CUDA-graph replay give the
//   same bits. One fence a block, and up to 4 splits a lane, keep this
//   tail short: 370 blocks all fencing, and a warp a row, made it the
//   largest cost of the call after the memory traffic.
// * Accesses: neighbouring lanes read neighbouring addresses of each plane:
//   16 bytes a lane where V and every plane's start allow it (vec), else two
//   single elements a group width apart (four, in bf16, spill registers and
//   measured slower). All K + 1 planes of a step are loaded before any is
//   used (planes k < KREG unrolled), so one memory latency covers a step,
//   and the step's columns update the statistics together: their maxima,
//   then one rescale, so their exponentials do not wait on each other.
// * The statistics are kept in base 2 (the logits times log2(e) / T, one
//   multiply), so each exponential is one exp2; the row's outputs convert
//   back with ln(2).
// * A lane with no column carries m = -1e30, D = 0, which merge without NaN
//   (V=1, B=1 and the B and V tails); a masked column of a step is -inf,
//   whose exponential is 0. bf16 logits are computed in f32.
// * The scratch and the ticket belong to the wrapper, one pair per device,
//   shared by the four loss kernels (kernels/build.py loss_scratch); every
//   launch leaves the ticket at 0. Two calls at once on two streams would
//   share them: not supported (the port issues its loss calls on one stream).
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
constexpr int NSTAT = 5;                     // floats of a partial
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

// The online statistics of some columns of a row, over the logits in base 2
// (t2 = t log2(e), s2 = s log2(e): one multiply folds 1/T and log2(e) in,
// and each exponential is one exp2)
struct Stats {
  float mt, dt, nt;  // teacher: running max of t2, sum of 2^(t2 - mt), sum of 2^(t2 - mt) (t2 - s2)
  float ms, ds;      // student: running max of s2, sum of 2^(s2 - ms)
};

__device__ __forceinline__ Stats no_columns() { return Stats{NEG, 0.f, 0.f, NEG, 0.f}; }

// N columns of a step at once (t, s: -inf where masked, diff: t - s, or 0
// where masked): their maxima first, then one rescale of the running sums,
// so the columns' exponentials are independent of each other
template <int N>
__device__ __forceinline__ void push(Stats& a, const float (&t)[N], const float (&s)[N], const float (&diff)[N]) {
  float mt = a.mt, ms = a.ms;
#pragma unroll
  for (int i = 0; i < N; ++i) mt = fmaxf(mt, t[i]), ms = fmaxf(ms, s[i]);
  float dt = 0.f, nt = 0.f, ds = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = exp2f(t[i] - mt);
    dt += e;
    nt = fmaf(e, diff[i], nt);
    ds += exp2f(s[i] - ms);
  }
  a.dt = fmaf(a.dt, exp2f(a.mt - mt), dt);
  a.nt = fmaf(a.nt, exp2f(a.mt - mt), nt);
  a.ds = fmaf(a.ds, exp2f(a.ms - ms), ds);
  a.mt = mt, a.ms = ms;
}

// one exponential each for teacher and student: the side with the smaller
// maximum is scaled by 2^-(the difference)
__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  const float et = exp2f(-fabsf(a.mt - b.mt)), es = exp2f(-fabsf(a.ms - b.ms));
  const bool ta = a.mt >= b.mt, sa = a.ms >= b.ms;
  return Stats{ta ? a.mt : b.mt, ta ? fmaf(b.dt, et, a.dt) : fmaf(a.dt, et, b.dt),
               ta ? fmaf(b.nt, et, a.nt) : fmaf(a.nt, et, b.nt), sa ? a.ms : b.ms,
               sa ? fmaf(b.ds, es, a.ds) : fmaf(a.ds, es, b.ds)};
}

__device__ __forceinline__ Stats shfl_xor(const Stats& a, int o) {
  return Stats{__shfl_xor_sync(0xffffffffu, a.mt, o), __shfl_xor_sync(0xffffffffu, a.dt, o),
               __shfl_xor_sync(0xffffffffu, a.nt, o), __shfl_xor_sync(0xffffffffu, a.ms, o),
               __shfl_xor_sync(0xffffffffu, a.ds, o)};
}

__device__ __forceinline__ void write_row(float* res, int B, int r, const Stats& a, float T) {
  const float lse_t = (log2f(a.dt) + a.mt) * LN2, lse_s = (log2f(a.ds) + a.ms) * LN2;
  res[r] = (a.nt / a.dt * LN2 - lse_t + lse_s) * (T * T);
  res[B + r] = lse_t;
  res[2 * B + r] = lse_s;
}

struct Args {
  const void* cl;
  const void* st;
  const float* w;
  float* res;
  float* part;
  unsigned int* ticket;
  int K, B, V;
  float T;
  int lanes, splits, span;
};

// VEC: elements per access; U: accesses per lane and plane in a step
template <typename TC, typename TS, int VEC, int U>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ensemble_kl_fwd_kernel(const Args a) {
  __shared__ Stats swarp[WARPS];
  __shared__ float spart[MAX_ITEMS * NSTAT];
  __shared__ unsigned int is_last;
  const TC* __restrict__ cl = static_cast<const TC*>(a.cl);
  const TS* __restrict__ st = static_cast<const TS*>(a.st);
  const int K = a.K, B = a.B, V = a.V, G = a.lanes, S = a.splits;
  const size_t plane = (size_t)B * V;
  const float T = a.T, scale = LOG2E / T;
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
      const size_t base = (size_t)row * V;
      for (int c = c0 + j * VEC; c < c1; c += G * VEC * U) {
        // every load of the step first
        Vec<TC, VEC> x[U][KREG];
        Vec<TS, VEC> y[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int cc = c + u * G * VEC;  // V is a multiple of VEC: an access is wholly in or out
          if (cc < c1) {
            y[u] = load<TS, VEC>(st + base + cc);
#pragma unroll
            for (int k = 0; k < KREG; ++k)
              if (k < K) x[u][k] = load<TC, VEC>(cl + k * plane + base + cc);
          }
        }
        float t[U * VEC], s[U * VEC], diff[U * VEC];
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
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int n = u * VEC + i;
            t[n] = cc < c1 ? tu[i] * scale : -INFINITY;
            s[n] = cc < c1 ? to_f(y[u].x[i]) * scale : -INFINITY;
            diff[n] = cc < c1 ? t[n] - s[n] : 0.f;
          }
        }
        push(acc, t, s, diff);
      }
    }
    if (G <= 32) {  // a group of lanes owns the row (and S is 1)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o < G) acc = merge(acc, shfl_xor(acc, o));
      if (j == 0 && row < B) write_row(a.res, B, row, acc, T);
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
          write_row(a.res, B, row, r, T);
        } else if (lane == 0) {
          float* p = a.part + (size_t)item * NSTAT;
          p[0] = r.mt, p[1] = r.dt, p[2] = r.nt, p[3] = r.ms, p[4] = r.ds;
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
      m = merge(m, Stats{p[0], p[1], p[2], p[3], p[4]});
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < g) m = merge(m, shfl_xor(m, o));
    if (l == 0 && r < B) write_row(a.res, B, r, m, T);
  }
  if (tid == 0) *a.ticket = 0u;
}

template <typename TC, typename TS>
int launch(const Args& a, int vec, int blocks, cudaStream_t stream) {
  constexpr int WIDE = sizeof(TC) > sizeof(TS) ? sizeof(TC) : sizeof(TS);
  constexpr int VMAX = 16 / WIDE;  // 16 bytes per access, or two single elements
  if (vec == 1)
    ensemble_kl_fwd_kernel<TC, TS, 1, 2><<<blocks, THREADS, 0, stream>>>(a);
  else if (vec == VMAX)
    ensemble_kl_fwd_kernel<TC, TS, VMAX, 1><<<blocks, THREADS, 0, stream>>>(a);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 f32, 1 bf16. res: (3, B) f32, written as out, lse_t, lse_s.
// vec: 1, or 16 bytes of the wider logit dtype (V a multiple of it and every
// plane 16-byte aligned). lanes: a power of two up to 32 (a group of lanes
// owns a row), or 256 (a block owns a row, or a split of one); splits:
// column ranges of span columns per row (span a multiple of vec, splits
// span >= V); with splits > 1, lanes is 256, B splits <= MAX_ITEMS, part
// holds 5 B splits floats and ticket is 0. Returns the CUDA error of the
// launch (0: none), or -1 for arguments the kernel does not take.
extern "C" int ensemble_kl_fwd(const void* cl, const void* st, const float* w, float* res, float* part,
                               unsigned int* ticket, int K, int B, int V, float T, int dtype_cl, int dtype_st,
                               int vec, int lanes, int splits, int span, int blocks, void* stream) {
  const bool lane_rows = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (K <= 0 || B <= 0 || V <= 0 || blocks <= 0 || vec <= 0 || V % vec != 0 || span <= 0 || span % vec != 0 ||
      splits <= 0 || (long long)span * splits < V || (!lane_rows && lanes != THREADS) ||
      (splits > 1 && (lanes != THREADS || (long long)B * splits > MAX_ITEMS || part == nullptr || ticket == nullptr)))
    return -1;
  const Args a{cl, st, w, res, part, ticket, K, B, V, T, lanes, splits, span};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_cl == 0 && dtype_st == 0) return launch<float, float>(a, vec, blocks, s);
  if (dtype_cl == 1 && dtype_st == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, vec, blocks, s);
  if (dtype_cl == 0 && dtype_st == 1) return launch<float, __nv_bfloat16>(a, vec, blocks, s);
  if (dtype_cl == 1 && dtype_st == 0) return launch<__nv_bfloat16, float>(a, vec, blocks, s);
  return -1;
}
