// The backward of the fused ensemble-KL loss for Hopper (sm_90a): the CUDA C++
// port of the Pallas TPU kernel src/repro/kernels/ensemble_kl/kernel.py
// ensemble_kl_bwd_pallas (_bwd_kernel, pallas_call :180).
//
// Client logits cl (K, B, V) and student logits st (B, V), f32 or bf16,
// contiguous; w (K,) f32; the per-row cotangent g (B,) f32 and the
// forward's residuals out, lse_t, lse_s (B,) f32. With
// t = sum_k w_k cl_k / T, s = st / T, p = e^(t - lse_t) and q = e^(s - lse_s),
// per element of the (B, V) plane:
//
//   g_ens     = T g p ((t - lse_t) - (s - lse_s) - out / T^2)
//   g_client  = w_k g_ens          (K, B, V), in cl's dtype
//   g_student = T g (q - p)        (B, V), in st's dtype
//   g_w       = <g_ens, cl_k>      (K,) f32
//
// An output whose pointer is null is neither computed nor stored: the
// generator's steps want g_client and g_student, the distillation sweep
// g_student alone, and nothing on the Co-Boosting path wants g_w here.
//
// Bound. Bytes: each element of cl and st is read once and each wanted
// cotangent written once, for a few flops each. In the generator's mode at
// K=5, B=37, V=32003 in f32 that is 56.8 MB, 17 us at 3.35 TB/s; at the main
// path's K=5, B=128, V=10 it is 61 KB, 18 ns: there a call costs one
// launch's latency and whatever the host spends on it.
//
// Design.
//
// * One launch over the N = B V elements, a grid-stride loop. A thread takes
//   16 bytes of every plane at a time (4 f32 or 8 bf16) when N and every
//   pointer allow it, else 8 bytes' worth of single elements a block width
//   apart, so neighbouring threads touch neighbouring addresses either way.
//   It derives each element's row from its index and loads the residuals of
//   the rows an access starts and ends in together with the logits, so one
//   memory latency covers a step. The K client values of its elements stay
//   in registers from the combine to the cotangents for k < KREG; planes
//   past KREG are read again, from L1/L2. The g_w code is compiled only into
//   the kernel that computes it. The wrapper sizes the grid
//   (kernels/build.py loss_bwd_geometry): one block at the main path's
//   shape, at most MIN_BLOCKS blocks per SM, all resident at once
//   (__launch_bounds__), at wide shapes. The TPU kernel's (block_b,
//   block_v) tiles are not carried over.
// * g_w in the same launch, deterministically, without float atomics. Each
//   thread sums its products in registers (k < KREG) or, per step, through a
//   fixed butterfly of warp shuffles into its warp's slot in shared memory
//   (k >= KREG); the block sums its warps in warp order. A one-block grid
//   writes g_w there and touches no scratch. Otherwise each block writes its
//   K sums to its own column of the scratch `part` (K, blocks), fences, and
//   takes an integer ticket; the last block to arrive sums the columns in a
//   fixed order, writes g_w and puts the ticket back to 0. A second call
//   gives the same bits.
// * The scratch and the ticket belong to the wrapper, one pair per device,
//   shared by both loss backward kernels (kernels/build.py gw_scratch); the
//   ticket is zeroed once and every launch leaves it at 0, so a CUDA graph
//   may capture and replay the call. Two calls running at once on two
//   streams would share the ticket and the partials and corrupt each other's
//   g_w: not supported (the port issues its loss calls on one stream).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 3;  // resident blocks per SM: kernels/build.py LOSS_BWD_BLOCKS_PER_SM
constexpr int KREG = 8;        // client planes an element keeps in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

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

template <typename T, int VEC> __device__ __forceinline__ void store(T* p, const Vec<T, VEC>& v) {
  if constexpr (sizeof(v) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&v);
  } else if constexpr (sizeof(v) == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(&v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v.x[i];
  }
}

// the same sum in every lane, by a fixed butterfly
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's g_w sums (acc[k] of each thread for k < KREG, sgw[warp K + k]
// for the rest) in a fixed order; then g_w itself (one block), or the
// block's column of part and, in the last block to arrive, the sum of the
// columns in block order.
__device__ void finish_gw(const float (&acc)[KREG], float* sgw, int K, float* g_w, float* part,
                          unsigned int* ticket) {
  __shared__ unsigned int is_last;
  __shared__ float sred[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x;
#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    if (k < K) {
      const float v = warp_sum(acc[k]);
      if (lane == 0) sgw[warp * K + k] = v;
    }
  }
  __syncthreads();
  for (int k = tid; k < K; k += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += sgw[w * K + k];
    if (nb == 1) g_w[k] = s;
    else part[(size_t)k * nb + blockIdx.x] = s;
  }
  if (nb == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == (unsigned int)(nb - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int k = 0; k < K; ++k) {
    float v = 0.f;
    for (int i = tid; i < nb; i += THREADS) v += __ldcg(part + (size_t)k * nb + i);
    v = warp_sum(v);
    if (lane == 0) sred[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += sred[w];
      g_w[k] = s;
    }
    __syncthreads();
  }
  if (tid == 0) *ticket = 0u;
}

struct Args {
  const void* cl;
  const void* st;
  const float* w;
  const float* g;
  const float* out;
  const float* lse_t;
  const float* lse_s;
  void* g_cl;
  void* g_st;
  float* g_w;
  float* part;
  unsigned int* ticket;
  int K, N, V;
  float T;
};

// The residuals of one row, as the cotangents use them
struct Row {
  float gt, lse_t, lse_s, klu;  // T g, lse_t, lse_s, out / T^2
};

__device__ __forceinline__ Row load_row(const Args& a, unsigned int r) {
  const float T = a.T;
  return Row{a.g[r] * T, a.lse_t[r], a.lse_s[r], a.out[r] / (T * T)};
}

// VEC: elements per access; R: accesses per thread and step (VEC R elements);
// WANT_W: g_w is asked for
template <typename TC, typename TS, int VEC, int R, bool WANT_W>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ensemble_kl_bwd_kernel(const Args a) {
  extern __shared__ float sgw[];  // [WARPS][K] with g_w: the warps' sums (k >= KREG: accumulated per step)
  const TC* __restrict__ cl = static_cast<const TC*>(a.cl);
  const TS* __restrict__ st = static_cast<const TS*>(a.st);
  TC* __restrict__ g_cl = static_cast<TC*>(a.g_cl);
  TS* __restrict__ g_st = static_cast<TS*>(a.g_st);
  const int K = a.K;
  const unsigned int N = a.N, V = a.V;
  const size_t plane = N;
  const bool want_cl = g_cl != nullptr, want_st = g_st != nullptr, want_ens = want_cl || WANT_W;
  const float T = a.T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float wk[KREG], acc[WANT_W ? KREG : 1];
#pragma unroll
  for (int k = 0; k < KREG; ++k) wk[k] = k < K ? a.w[k] : 0.f;
  if constexpr (WANT_W) {
#pragma unroll
    for (int k = 0; k < KREG; ++k) acc[k] = 0.f;
    if (K > KREG) {
      for (int i = tid; i < WARPS * K; i += THREADS) sgw[i] = 0.f;
      __syncthreads();
    }
  }

  constexpr unsigned int TILE = THREADS * VEC * R;
  for (unsigned int base = blockIdx.x * TILE; base < N; base += gridDim.x * TILE) {
    // every load of the step first: the logits, and the residuals of the
    // rows each access starts and ends in
    Vec<TC, VEC> c[R][KREG];
    Vec<TS, VEC> s[R];
    Row first[R], last[R];
    unsigned int r0[R], r1[R];
    bool in[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned int e = base + (j * THREADS + tid) * VEC;
      in[j] = e < N;  // N is a multiple of VEC: an access is wholly in or out
      if (in[j]) {
        r0[j] = e / V;
        first[j] = load_row(a, r0[j]);
        if constexpr (VEC > 1) {
          r1[j] = (e + VEC - 1) / V;
          last[j] = load_row(a, r1[j]);
        }
        s[j] = load<TS, VEC>(st + e);
#pragma unroll
        for (int k = 0; k < KREG; ++k)
          if (k < K) c[j][k] = load<TC, VEC>(cl + k * plane + e);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned int e = base + (j * THREADS + tid) * VEC;
      float ens[VEC];
      if (in[j]) {
        float t[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) t[i] = 0.f;
#pragma unroll
        for (int k = 0; k < KREG; ++k)
          if (k < K) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) t[i] += wk[k] * to_f(c[j][k].x[i]);
          }
        for (int k = KREG; k < K; ++k) {
          const Vec<TC, VEC> ck = load<TC, VEC>(cl + k * plane + e);
          const float w = a.w[k];
#pragma unroll
          for (int i = 0; i < VEC; ++i) t[i] += w * to_f(ck.x[i]);
        }
        unsigned int r = r0[j], col = e - r * V;
        Row row = first[j];
        Vec<TS, VEC> gs;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if (VEC > 1 && col == V) {  // the access runs into the next row
            ++r;
            col = 0;
            row = r == r1[j] ? last[j] : load_row(a, r);  // a middle row only when V < VEC
          }
          const float lt = t[i] / T - row.lse_t;
          const float ls = to_f(s[j].x[i]) / T - row.lse_s;
          const float p = expf(lt);
          if (want_st) gs.x[i] = from_f<TS>(row.gt * (expf(ls) - p));
          ens[i] = want_ens ? row.gt * (p * (lt - ls - row.klu)) : 0.f;
          ++col;
        }
        if (want_st) store<TS, VEC>(g_st + e, gs);
        if (want_cl) {
#pragma unroll
          for (int k = 0; k < KREG; ++k)
            if (k < K) {
              Vec<TC, VEC> o;
#pragma unroll
              for (int i = 0; i < VEC; ++i) o.x[i] = from_f<TC>(wk[k] * ens[i]);
              store<TC, VEC>(g_cl + k * plane + e, o);
            }
          for (int k = KREG; k < K; ++k) {
            const float w = a.w[k];
            Vec<TC, VEC> o;
#pragma unroll
            for (int i = 0; i < VEC; ++i) o.x[i] = from_f<TC>(w * ens[i]);
            store<TC, VEC>(g_cl + k * plane + e, o);
          }
        }
        if constexpr (WANT_W) {
#pragma unroll
          for (int k = 0; k < KREG; ++k)
            if (k < K) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[k] += to_f(c[j][k].x[i]) * ens[i];
            }
        }
      }
      if constexpr (WANT_W) {
        // planes past KREG: every lane joins the shuffle, in or out of the plane
        for (int k = KREG; k < K; ++k) {
          float v = 0.f;
          if (in[j]) {
            const Vec<TC, VEC> ck = load<TC, VEC>(cl + k * plane + e);
#pragma unroll
            for (int i = 0; i < VEC; ++i) v += to_f(ck.x[i]) * ens[i];
          }
          v = warp_sum(v);
          if (lane == 0) sgw[warp * K + k] += v;
        }
      }
    }
  }
  if constexpr (WANT_W) finish_gw(acc, sgw, K, a.g_w, a.part, a.ticket);
}

template <typename TC, typename TS, bool WANT_W>
int launch_w(const Args& a, int vec, int blocks, size_t smem, cudaStream_t stream) {
  constexpr int WIDE = sizeof(TC) > sizeof(TS) ? sizeof(TC) : sizeof(TS);
  constexpr int VMAX = 16 / WIDE, RSINGLE = 8 / WIDE;  // 16 bytes per access, or 8 bytes of single elements
  if (vec == 1)
    ensemble_kl_bwd_kernel<TC, TS, 1, RSINGLE, WANT_W><<<blocks, THREADS, smem, stream>>>(a);
  else if (vec == VMAX)
    ensemble_kl_bwd_kernel<TC, TS, VMAX, 1, WANT_W><<<blocks, THREADS, smem, stream>>>(a);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, typename TS>
int launch(const Args& a, int vec, int blocks, cudaStream_t stream) {
  if (a.g_w == nullptr) return launch_w<TC, TS, false>(a, vec, blocks, 0, stream);
  return launch_w<TC, TS, true>(a, vec, blocks, sizeof(float) * WARPS * a.K, stream);
}

}  // namespace

// dtype codes: 0 f32, 1 bf16. vec: 1, or 16 bytes of the wider logit dtype
// (N a multiple of it and every plane 16-byte aligned). A null g_cl, g_st or
// g_w skips that cotangent; with g_w and blocks > 1, part holds K * blocks
// floats and ticket is 0. Returns the CUDA error of the launch (0: none), or
// -1 for arguments the kernel does not take.
extern "C" int ensemble_kl_bwd(const void* cl, const void* st, const float* w, const float* g,
                               const float* out, const float* lse_t, const float* lse_s, void* g_cl, void* g_st,
                               float* g_w, float* part, unsigned int* ticket, int K, int B, int V, float T,
                               int dtype_cl, int dtype_st, int vec, int blocks, void* stream) {
  const long long n = (long long)B * V;
  if (K <= 0 || B <= 0 || V <= 0 || n >= (1LL << 31) || blocks <= 0 || vec <= 0 ||
      n % vec != 0 || (long long)WARPS * K * sizeof(float) > 48 * 1024 ||
      (g_w != nullptr && blocks > 1 && (part == nullptr || ticket == nullptr)))
    return -1;
  const Args a{cl, st, w, g, out, lse_t, lse_s, g_cl, g_st, g_w, part, ticket, K, (int)n, V, T};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_cl == 0 && dtype_st == 0) return launch<float, float>(a, vec, blocks, s);
  if (dtype_cl == 1 && dtype_st == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, vec, blocks, s);
  if (dtype_cl == 0 && dtype_st == 1) return launch<float, __nv_bfloat16>(a, vec, blocks, s);
  if (dtype_cl == 1 && dtype_st == 0) return launch<__nv_bfloat16, float>(a, vec, blocks, s);
  return -1;
}
