// Flash-attention backward for Hopper (sm_90a): the CUDA C++ port of the
// two passes of the Pallas TPU function src/repro/kernels/flash_attention/
// kernel.py:227 flash_attention_bwd_pallas,
//
//   flash_bwd_dq_kernel  <- the dq pass,    _bwd_dq_kernel  (pallas_call :295)
//   flash_bwd_dkv_kernel <- the dk/dv pass, _bwd_dkv_kernel (pallas_call :314)
//
// Inputs in the JAX layouts, read in place (f32 or bf16, contiguous):
// q and dout (B, Sq, H, hd), k and v (B, Sk, KH, hd), the forward's lse
// (B, Sq, H) f32, and delta = sum_hd dout * out (B, Sq, H) f32, which the
// wrapper computes. Head h = kh * G + g, G = H / KH. Positions of queries
// and keys both count from 0; masks as in the forward (k < Sk; causal
// k <= q; window k > q - window; softcap on the scores before masking).
//
// Both passes rebuild each probability tile from the saved lse instead of
// storing it: s = q k^T * scale (then cap * tanh(s / cap) under softcap),
// p = exp(s - lse) where the masks let k be seen and 0 elsewhere (rows the
// forward found fully masked have lse = 1e30, so their p is 0 too),
// dp = dout v^T, du = p (dp - delta) dact with dact = 1 - tanh^2 under
// softcap, else 1. Then
//
//   dq = scale * du k              (in q's dtype),
//   dk = du^T (q * scale)          summed over the G heads of each kv head,
//   dv = p^T dout                  likewise; both in k's dtype.
//
// Design.
//
// dq pass: one block per (q tile, kv head, batch row), like the forward.
// The block holds ROWS = 64 query rows: the G heads of one kv head times
// BQ = ROWS / G positions, so each K/V tile is staged in shared memory
// once for all G heads (GQA). Each of the 8 warps owns 8 rows and keeps
// their dq accumulators in registers (head dim across the lanes) over the
// whole kv sweep; a tile is BK = 32 keys, one per lane for s and dp. Tiles
// that the causal or window mask hides from every row of the block are
// skipped.
//
// dk/dv pass: one block per (kv tile, kv head, batch row). The block
// holds BKV = 32 keys, 4 per warp, with their dk and dv accumulators in
// registers, and loops over the G query heads of its kv head and, for
// each, over the q tiles (32 rows, one per lane) that can see some key of
// the tile: causal q >= first key, window q < last key + window. The GQA
// group is reduced here, in the block, so the kernel writes (B, Sk, KH, hd)
// directly; every output element has one owner and one fixed summation
// order, with no atomics: two runs give the same bits.
//
// Tails in Sq and Sk are masked; nothing is padded.
//
// Bound. At the training shape of smollm-135m (B = 8, S = 256, 9 heads
// over 3 kv heads, hd 64, causal) the dq pass is 0.9 GFLOP (3 products
// over the causal pairs) and the dk/dv pass 1.2 GFLOP (4), each over about
// 9 MB in bf16: at the tensor cores' bf16 rate the bytes would bound them
// (about 2.5 us), at the f32 rate of the CUDA cores, where this first
// version computes, the operations (14 and 18 us). The score loops do one
// FMA per two shared-memory reads, so those reads set the pace.
// What the design does about it: every operand tile is read from device
// memory once per block and reused from shared memory across the block's
// rows (and, in the dk/dv pass, across its keys), scores never touch device
// memory, and masked tiles are skipped.
//
// Which inputs each pass serves. Both serve f32 (their checks need f32
// products, not bf16 ones, and the f32 full-width gradient gap of 2.3e-6
// rests on them), and bf16 only when a caller names them: bf16 inputs, the
// main paths', go to the tensor-core dq and dk/dv passes of
// flash_attention_sm90.cu (bf16 wgmma tiles fed by TMA).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 8;             // dq pass: query rows per warp
constexpr int ROWS = WARPS * RPW;  // dq pass: query rows per block
constexpr int BK = 32;             // dq pass: keys per tile, one per lane
constexpr int KPW = 4;             // dk/dv pass: keys per warp
constexpr int BKV = WARPS * KPW;   // dk/dv pass: keys per block
constexpr int BQT = 32;            // dk/dv pass: query rows per tile, one per lane
constexpr float MASKED_LSE = 1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// du for one (query row, key) pair from the raw score u = q k^T * scale
__device__ __forceinline__ void probs(float u, float dp, float lse, float delta, bool ok, float softcap,
                                      float& p, float& du) {
  float s = u, dact = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(u / softcap);
    s = t * softcap;
    dact = 1.f - t * t;
  }
  p = ok ? expf(s - lse) : 0.f;
  du = p * (dp - delta) * dact;
}

__device__ __forceinline__ bool visible(int qp, int key, int Sq, int Sk, int causal, int window) {
  bool ok = qp < Sq && key < Sk;
  if (causal) ok = ok && key <= qp;
  if (window > 0) ok = ok && key > qp - window;
  return ok;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Sk, int H, int KH, int BQ, int causal, int window,
                    float softcap, float scale) {
  constexpr int DPL = HD / 32;  // head-dim entries per lane in the du k product
  extern __shared__ float smem[];
  float* qs = smem;                // [ROWS][HD], pre-scaled
  float* dos = qs + ROWS * HD;     // [ROWS][HD]
  float* ks = dos + ROWS * HD;     // [BK][HD + 1], padded: lanes read rows
  float* vs = ks + BK * (HD + 1);  // [BK][HD + 1]

  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int g = r / BQ, qp = q0 + r % BQ;
    float x = 0.f, y = 0.f;
    if (g < G && qp < Sq) {
      const size_t off = ((size_t)(b * Sq + qp) * H + kh * G + g) * HD + d;
      x = to_f(q[off]) * scale;
      y = to_f(dout[off]);
    }
    qs[i] = x;
    dos[i] = y;
  }

  float row_lse[RPW], row_delta[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    const int g = r / BQ, qp = q0 + r % BQ;
    row_lse[i] = MASKED_LSE;
    row_delta[i] = 0.f;
    if (g < G && qp < Sq) {
      const size_t row = (size_t)(b * Sq + qp) * H + kh * G + g;
      row_lse[i] = lse[row];
      row_delta[i] = delta[row];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  // keys any row of this block can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;

  for (int t0 = (k_lo / BK) * BK; t0 < k_hi; t0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int j = i / HD, d = i % HD, key = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < Sk) {
        const size_t off = ((size_t)(b * Sk + key) * KH + kh) * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j * (HD + 1) + d] = kx;
      vs[j * (HD + 1) + d] = vx;
    }
    __syncthreads();

    const int key = t0 + lane;
    const float* kr = ks + lane * (HD + 1);
    const float* vr = vs + lane * (HD + 1);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int g = r / BQ, qp = q0 + r % BQ;
      if (g >= G || qp >= Sq) continue;  // uniform across the warp
      const float* qr = qs + r * HD;
      const float* dr = dos + r * HD;
      float u = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        u = fmaf(qr[d], kr[d], u);
        dp = fmaf(dr[d], vr[d], dp);
      }
      float p, du;
      probs(u, dp, row_lse[i], row_delta[i], visible(qp, key, Sq, Sk, causal, window), softcap, p, du);
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float duj = __shfl_sync(0xffffffffu, du, j);
        const float* kj = ks + j * (HD + 1) + lane;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(duj, kj[32 * c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    const int g = r / BQ, qp = q0 + r % BQ;
    if (g >= G || qp >= Sq) continue;
    const size_t row = (size_t)(b * Sq + qp) * H + kh * G + g;
#pragma unroll
    for (int c = 0; c < DPL; ++c) dq[row * HD + lane + 32 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KH, int causal,
                     int window, float softcap, float scale) {
  constexpr int DPL = HD / 32;
  extern __shared__ float smem[];
  float* ks = smem;                  // [BKV][HD]: read as broadcasts
  float* vs = ks + BKV * HD;         // [BKV][HD]
  float* qs = vs + BKV * HD;         // [BQT][HD + 1], pre-scaled, padded: lanes read rows
  float* dos = qs + BQT * (HD + 1);  // [BQT][HD + 1]
  float* ls = dos + BQT * (HD + 1);  // [BQT] lse of the tile's rows
  float* ds = ls + BQT;              // [BQT] delta of the tile's rows

  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < BKV * HD; i += THREADS) {
    const int j = i / HD, d = i % HD, key = k0 + j;
    float kx = 0.f, vx = 0.f;
    if (key < Sk) {
      const size_t off = ((size_t)(b * Sk + key) * KH + kh) * HD + d;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    ks[i] = kx;
    vs[i] = vx;
  }

  float dka[KPW][DPL], dva[KPW][DPL];
#pragma unroll
  for (int i = 0; i < KPW; ++i)
#pragma unroll
    for (int c = 0; c < DPL; ++c) dka[i][c] = dva[i][c] = 0.f;

  // query rows that can see some key of this block
  const int k_last = min(k0 + BKV, Sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;  // exclusive

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int t0 = (q_lo / BQT) * BQT; t0 < q_hi; t0 += BQT) {
      __syncthreads();
      for (int i = tid; i < BQT * HD; i += THREADS) {
        const int j = i / HD, d = i % HD, qp = t0 + j;
        float x = 0.f, y = 0.f;
        if (qp < Sq) {
          const size_t off = ((size_t)(b * Sq + qp) * H + h) * HD + d;
          x = to_f(q[off]) * scale;
          y = to_f(dout[off]);
        }
        qs[j * (HD + 1) + d] = x;
        dos[j * (HD + 1) + d] = y;
      }
      if (tid < BQT) {
        const int qp = t0 + tid;
        const size_t row = (size_t)(b * Sq + qp) * H + h;
        ls[tid] = qp < Sq ? lse[row] : MASKED_LSE;
        ds[tid] = qp < Sq ? delta[row] : 0.f;
      }
      __syncthreads();

      const int qp = t0 + lane;
      const float* qr = qs + lane * (HD + 1);
      const float* dr = dos + lane * (HD + 1);
      const float row_lse = ls[lane], row_delta = ds[lane];
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        const int j = warp * KPW + i, key = k0 + j;
        if (key >= Sk) continue;  // uniform across the warp
        const float* kr = ks + j * HD;
        const float* vr = vs + j * HD;
        float u = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) {
          u = fmaf(qr[d], kr[d], u);
          dp = fmaf(dr[d], vr[d], dp);
        }
        float p, du;
        probs(u, dp, row_lse, row_delta, visible(qp, key, Sq, Sk, causal, window), softcap, p, du);
#pragma unroll 8
        for (int jj = 0; jj < BQT; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
          const float duj = __shfl_sync(0xffffffffu, du, jj);
          const float* qj = qs + jj * (HD + 1) + lane;
          const float* dj = dos + jj * (HD + 1) + lane;
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            dva[i][c] = fmaf(pj, dj[32 * c], dva[i][c]);
            dka[i][c] = fmaf(duj, qj[32 * c], dka[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    const int key = k0 + warp * KPW + i;
    if (key >= Sk) continue;
    const size_t row = (size_t)(b * Sk + key) * KH + kh;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      dk[row * HD + lane + 32 * c] = from_f<T>(dka[i][c]);
      dv[row * HD + lane + 32 * c] = from_f<T>(dva[i][c]);
    }
  }
}

template <typename K>
int opt_in_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;  // the default suffices
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int Sq, int Sk, int H, int KH, int causal, int window,
              float softcap, cudaStream_t stream) {
  const int BQ = ROWS / (H / KH);
  const size_t smem = sizeof(float) * (2 * ROWS * HD + 2 * BK * (HD + 1));
  auto kern = flash_bwd_dq_kernel<T, HD>;
  if (int err = opt_in_smem(kern, smem)) return err;
  dim3 grid((Sq + BQ - 1) / BQ, KH, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      lse, delta, static_cast<T*>(dq), Sq, Sk, H, KH, BQ, causal, window, softcap, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH, int causal,
               int window, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BKV * HD + 2 * BQT * (HD + 1) + 2 * BQT);
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  if (int err = opt_in_smem(kern, smem)) return err;
  dim3 grid((Sk + BKV - 1) / BKV, KH, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KH, causal, window, softcap,
      1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int H, int KH) {
  return B <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0;
}

}  // namespace

#define DISPATCH_HD(T, FN, ...)                        \
  switch (hd) {                                        \
    case 32: return FN<T, 32>(__VA_ARGS__);            \
    case 64: return FN<T, 64>(__VA_ARGS__);            \
    case 128: return FN<T, 128>(__VA_ARGS__);          \
    default: return -1;                                \
  }

// dtype: 0 = float32, 1 = bfloat16. Each returns 0, a CUDA error code, or
// -1 for a shape the kernel does not take (hd not in {32, 64, 128}; in the
// dq pass also G = H / KH > 64).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, void* dq, int B, int Sq, int Sk,
                                      int H, int KH, int hd, int causal, int window, float softcap, int dtype,
                                      void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH) || H / KH > ROWS) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_HD(float, launch_dq, q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KH, causal, window, softcap, s)
  }
  if (dtype == 1) {
    DISPATCH_HD(__nv_bfloat16, launch_dq, q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KH, causal, window,
                softcap, s)
  }
  return -1;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int KH, int hd, int causal, int window, float softcap,
                                       int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_HD(float, launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KH, causal, window, softcap,
                s)
  }
  if (dtype == 1) {
    DISPATCH_HD(__nv_bfloat16, launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KH, causal, window,
                softcap, s)
  }
  return -1;
}
