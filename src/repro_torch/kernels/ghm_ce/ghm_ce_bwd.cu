// The backward of the fused GHM-weighted cross-entropy for Hopper (sm_90a):
// the CUDA C++ port of the Pallas TPU kernel src/repro/kernels/ghm_ce/kernel.py
// ghm_ce_bwd_pallas (_bwd_kernel, pallas_call :177).
//
// Client logits cl (K, B, V), f32 or bf16, contiguous; labels (B,) int32 or
// int64; w (K,) f32; the per-row cotangent g (B,) f32 and the
// forward's residuals lse and ly (B,) f32. With t = sum_k w_k cl_k,
// p = e^(t - lse), p_y = e^(ly - lse) and e_y the one-hot label, per element
// of the (B, V) plane:
//
//   g_t      = g coeff (p - e_y),  coeff = 1                  (mode 0: plain CE, Eq. 11)
//                                        = 1 - p_y            (mode 1: difficulty held, Eq. 6)
//                                        = 1 - p_y + p_y (lse - ly)   (mode 2: full gradient)
//   g_client = w_k g_t             (K, B, V), in cl's dtype
//   g_w      = <g_t, cl_k>         (K,) f32 (the Eq. 12 EE step reads it)
//
// An output whose pointer is null is neither computed nor stored: the
// generator's steps want g_client alone, the EE step g_w alone.
//
// Bound. Bytes: each element of cl is read once and g_client written once,
// for a few flops each. In the generator's mode at K=5, B=37, V=32003 in f32
// that is 47.4 MB, 14 us at 3.35 TB/s; at the main path's K=5, B=128, V=10,
// 51 KB, 15 ns: there a call costs one launch's latency and whatever the
// host spends on it.
//
// Design: that of ensemble_kl_bwd.cu beside the ensemble-KL wrapper, which
// says more. One launch, a grid-stride loop over the N = B V elements, 16
// bytes of every plane per access where N and the pointers allow it (else 8
// bytes' worth of single elements a block width apart); the residuals (g
// coeff and the label) of the rows an access starts and ends in loaded
// with the logits; the client values of an element in registers for
// k < KREG; the g_w code compiled only into the kernel that computes it.
// g_w in the same launch: per-thread and per-warp sums in a fixed order,
// then either written by a one-block grid or combined by the last block to
// take the integer ticket, with no float atomics. The scratch and the ticket are the wrapper's (kernels/build.py
// loss_scratch), shared by the four loss kernels; every launch leaves the
// ticket at 0, so a CUDA graph may capture the call, and two calls running
// at once on two streams are not supported (they would share the ticket).
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
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v.x[i] = p[i];
  }
  return v;
}

template <typename T, int VEC> __device__ __forceinline__ void store(T* p, const Vec<T, VEC>& v) {
  if constexpr (sizeof(v) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&v);
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
  const void* labels;
  const float* w;
  const float* g;
  const float* lse;
  const float* ly;
  void* g_cl;
  float* g_w;
  float* part;
  unsigned int* ticket;
  int K, N, V, mode;
};

// The residuals of one row, as the cotangents use them
struct Row {
  float gc, lse;  // g coeff, lse
  long long label;
};

template <typename TL> __device__ __forceinline__ Row load_row(const Args& a, const TL* labels, unsigned int r) {
  const float lse = a.lse[r];
  float coeff = 1.f;
  if (a.mode != 0) {
    const float ly = a.ly[r], py = expf(ly - lse);
    coeff = 1.f - py;
    if (a.mode == 2) coeff = coeff + py * (lse - ly);
  }
  return Row{a.g[r] * coeff, lse, (long long)labels[r]};
}

// VEC: elements per access; R: accesses per thread and step (VEC R elements);
// WANT_W: g_w is asked for
template <typename TC, typename TL, int VEC, int R, bool WANT_W>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ghm_ce_bwd_kernel(const Args a) {
  extern __shared__ float sgw[];  // [WARPS][K] with g_w: the warps' sums (k >= KREG: accumulated per step)
  const TC* __restrict__ cl = static_cast<const TC*>(a.cl);
  const TL* __restrict__ labels = static_cast<const TL*>(a.labels);
  TC* __restrict__ g_cl = static_cast<TC*>(a.g_cl);
  const int K = a.K;
  const unsigned int N = a.N, V = a.V;
  const size_t plane = N;
  const bool want_cl = g_cl != nullptr;
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
    Row first[R], last[R];
    unsigned int r0[R], r1[R];
    bool in[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned int e = base + (j * THREADS + tid) * VEC;
      in[j] = e < N;  // N is a multiple of VEC: an access is wholly in or out
      if (in[j]) {
        r0[j] = e / V;
        first[j] = load_row(a, labels, r0[j]);
        if constexpr (VEC > 1) {
          r1[j] = (e + VEC - 1) / V;
          last[j] = load_row(a, labels, r1[j]);
        }
#pragma unroll
        for (int k = 0; k < KREG; ++k)
          if (k < K) c[j][k] = load<TC, VEC>(cl + k * plane + e);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned int e = base + (j * THREADS + tid) * VEC;
      float gt[VEC];
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
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if (VEC > 1 && col == V) {  // the access runs into the next row
            ++r;
            col = 0;
            row = r == r1[j] ? last[j] : load_row(a, labels, r);  // a middle row only when V < VEC
          }
          const float p = expf(t[i] - row.lse);
          gt[i] = row.gc * (p - ((long long)col == row.label ? 1.f : 0.f));
          ++col;
        }
        if (want_cl) {
#pragma unroll
          for (int k = 0; k < KREG; ++k)
            if (k < K) {
              Vec<TC, VEC> o;
#pragma unroll
              for (int i = 0; i < VEC; ++i) o.x[i] = from_f<TC>(wk[k] * gt[i]);
              store<TC, VEC>(g_cl + k * plane + e, o);
            }
          for (int k = KREG; k < K; ++k) {
            const float w = a.w[k];
            Vec<TC, VEC> o;
#pragma unroll
            for (int i = 0; i < VEC; ++i) o.x[i] = from_f<TC>(w * gt[i]);
            store<TC, VEC>(g_cl + k * plane + e, o);
          }
        }
        if constexpr (WANT_W) {
#pragma unroll
          for (int k = 0; k < KREG; ++k)
            if (k < K) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[k] += to_f(c[j][k].x[i]) * gt[i];
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
            for (int i = 0; i < VEC; ++i) v += to_f(ck.x[i]) * gt[i];
          }
          v = warp_sum(v);
          if (lane == 0) sgw[warp * K + k] += v;
        }
      }
    }
  }
  if constexpr (WANT_W) finish_gw(acc, sgw, K, a.g_w, a.part, a.ticket);
}

template <typename TC, typename TL, bool WANT_W>
int launch_w(const Args& a, int vec, int blocks, size_t smem, cudaStream_t stream) {
  constexpr int VMAX = 16 / sizeof(TC), RSINGLE = 8 / sizeof(TC);  // 16 bytes per access, or 8 bytes of single elements
  if (vec == 1)
    ghm_ce_bwd_kernel<TC, TL, 1, RSINGLE, WANT_W><<<blocks, THREADS, smem, stream>>>(a);
  else if (vec == VMAX)
    ghm_ce_bwd_kernel<TC, TL, VMAX, 1, WANT_W><<<blocks, THREADS, smem, stream>>>(a);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, typename TL>
int launch(const Args& a, int vec, int blocks, cudaStream_t stream) {
  if (a.g_w == nullptr) return launch_w<TC, TL, false>(a, vec, blocks, 0, stream);
  return launch_w<TC, TL, true>(a, vec, blocks, sizeof(float) * WARPS * a.K, stream);
}

}  // namespace

// dtype codes: 0 f32, 1 bf16; label codes: 0 int32, 1 int64; mode: 0 plain
// CE, 1 weighted with the difficulty held constant, 2 weighted, full
// gradient. vec: 1, or 16 bytes of the logit dtype (N a multiple of it and
// every plane 16-byte aligned). A null g_cl or g_w skips that cotangent; with
// g_w and blocks > 1, part holds K * blocks floats and ticket is 0. Returns
// the CUDA error of the launch (0: none), or -1 for arguments the kernel does
// not take.
extern "C" int ghm_ce_bwd(const void* cl, const void* labels, const float* w, const float* g,
                          const float* lse, const float* ly, void* g_cl, float* g_w, float* part,
                          unsigned int* ticket, int K, int B, int V, int mode, int dtype, int label_dtype, int vec,
                          int blocks, void* stream) {
  const long long n = (long long)B * V;
  if (K <= 0 || B <= 0 || V <= 0 || n >= (1LL << 31) || blocks <= 0 || vec <= 0 ||
      mode < 0 || mode > 2 || n % vec != 0 || (long long)WARPS * K * sizeof(float) > 48 * 1024 ||
      (g_w != nullptr && blocks > 1 && (part == nullptr || ticket == nullptr)))
    return -1;
  const Args a{cl, labels, w, g, lse, ly, g_cl, g_w, part, ticket, K, (int)n, V, mode};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && label_dtype == 0) return launch<float, int32_t>(a, vec, blocks, s);
  if (dtype == 0 && label_dtype == 1) return launch<float, int64_t>(a, vec, blocks, s);
  if (dtype == 1 && label_dtype == 0) return launch<__nv_bfloat16, int32_t>(a, vec, blocks, s);
  if (dtype == 1 && label_dtype == 1) return launch<__nv_bfloat16, int64_t>(a, vec, blocks, s);
  return -1;
}
