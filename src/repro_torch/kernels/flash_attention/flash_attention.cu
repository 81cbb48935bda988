// Blocked online-softmax attention forward for Hopper (sm_90a): the CUDA
// C++ port of the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py flash_attention_pallas (_kernel).
//
// q (B, Sq, H, hd), k and v (B, Sk, KH, hd), read in place (f32 or bf16,
// contiguous); out (B, Sq, H, hd) in q's dtype and lse (B, Sq, H) f32.
// Head h = kh * G + g, G = H / KH (the JAX reshape order). Positions of
// queries and keys both count from 0. Masks: k < Sk; causal k <= q;
// window k > q - window; softcap tanh(s / cap) * cap before masking.
// A fully-masked row gets out = 0 and lse = 1e30.
//
// Design. One block per (q tile, kv head, batch row). The block holds
// ROWS = 64 query rows: the G heads of one kv head times BQ = ROWS / G
// positions, so each K/V tile is loaded into shared memory once and used
// by all G query heads of its kv head (GQA). Each of the 8 warps owns 8
// rows and keeps their (m, l, acc) statistics in registers across the kv
// sweep; a tile is BK = 32 keys, one per lane for the scores, and the P·V
// product puts the head dim across the lanes. Tiles that no row of the
// block can see (causal upper edge, window lower edge) are skipped. Tails
// in Sq and Sk are masked, nothing is padded.
//
// Bound. At the serving shapes (N <= 8 prompts, Sq = Sk <= a few hundred,
// hd = 64) the work is a few hundred MFLOP: the kernel is launch- and
// latency-bound. It computes in f32 on the CUDA cores, which is what f32
// inputs need (their checks hold f32 products, not bf16 ones): it serves
// f32, and bf16 only when a caller names it. bf16 inputs, the main paths',
// go to the tensor-core forward of flash_attention_sm90.cu (bf16 wgmma
// tiles fed by TMA), whose header note gives its bound and design.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 8;
constexpr int RPW = 8;             // query rows per warp
constexpr int ROWS = WARPS * RPW;  // query rows per block
constexpr int BK = 32;             // keys per tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int KH, int BQ,
                 int causal, int window, float softcap, float scale) {
  constexpr int DPL = HD / 32;  // head-dim entries per lane in the P·V product
  extern __shared__ float smem[];
  float* qs = smem;                  // [ROWS][HD], pre-scaled
  float* ks = qs + ROWS * HD;        // [BK][HD + 1], padded: lanes read rows
  float* vs = ks + BK * (HD + 1);    // [BK][HD]

  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < ROWS * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    const int g = r / BQ, qp = q0 + r % BQ;
    float x = 0.f;
    if (g < G && qp < Sq) x = to_f(q[((size_t)(b * Sq + qp) * H + kh * G + g) * HD + d]) * scale;
    qs[i] = x;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  // keys any row of this block can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;

  for (int t0 = (k_lo / BK) * BK; t0 < k_hi; t0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD, key = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < Sk) {
        const size_t off = ((size_t)(b * Sk + key) * KH + kh) * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j * (HD + 1) + d] = kx;
      vs[j * HD + d] = vx;
    }
    __syncthreads();

    const int key = t0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int g = r / BQ, qp = q0 + r % BQ;
      if (g >= G || qp >= Sq) continue;  // uniform across the warp
      const float* qr = qs + r * HD;
      const float* kr = ks + lane * (HD + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      bool ok = key < Sk;
      if (causal) ok = ok && key <= qp;
      if (window > 0) ok = ok && key > qp - window;
      const float m_new = fmaxf(m[i], warp_max(ok ? s : NEG));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = vs + j * HD + lane;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(pj, vr[32 * c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    const int g = r / BQ, qp = q0 + r % BQ;
    if (g >= G || qp >= Sq) continue;
    const size_t row = (size_t)(b * Sq + qp) * H + kh * G + g;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) out[row * HD + lane + 32 * c] = from_f<T>(acc[i][c] * inv);
    if (lane == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : 1e30f;
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq, int Sk,
           int H, int KH, int causal, int window, float softcap, cudaStream_t stream) {
  const int G = H / KH;
  const int BQ = ROWS / G;
  const size_t smem = sizeof(float) * (ROWS * HD + BK * (HD + 1) + BK * HD);
  auto kern = flash_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {  // above the default: opt in
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + BQ - 1) / BQ, KH, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      lse, Sq, Sk, H, KH, BQ, causal, window, softcap, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
              int Sk, int H, int KH, int causal, int window, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, window, softcap, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0, a CUDA error code, or -1
// for a shape the kernel does not take (hd not in {32, 64, 128}, G > 64).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                                   int B, int Sq, int Sk, int H, int KH, int hd, int causal, int window,
                                   float softcap, int dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > ROWS || Sq <= 0 || Sk <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(hd, q, k, v, out, lse, B, Sq, Sk, H, KH, causal, window, softcap, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, lse, B, Sq, Sk, H, KH, causal, window, softcap, s);
  return -1;
}
