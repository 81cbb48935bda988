// Paged flash-decode (Sq = 1) attention for Hopper (sm_90a): the CUDA C++
// port of the Pallas TPU kernel src/repro/kernels/flash_decode/kernel.py
// flash_decode_pallas (_kernel).
//
// q (B, H, hd); k_pages and v_pages (P, ps, KH, hd), read in place (f32 or
// bf16, contiguous); page_table (B, W) int32; pos (B,) int32; out (B, H, hd)
// in q's dtype. Logical index j of row b lives at
// (page_table[b, j / ps], j % ps). Without a window j is the absolute
// position (valid iff j <= pos); with one, the logical space is a ring of
// cache_len slots and j's absolute position is rebuilt from the write head
// pos % cache_len, as the dense decode does. j >= cache_len is never valid.
//
// Design. One block per (kv head, batch row), one warp per query head of
// the GQA group (G = H / KH warps). The block walks the W table entries:
// it loads the page id, skips the page when no logical index on it can be
// valid (the JAX page_live predicate), and stages the page's (ps, hd) K and
// V in shared memory, zero-filled at masked positions, so a masked entry
// contributes exactly nothing even when the page holds garbage (table
// entries that point at the engine's scratch page). Each warp then scores
// its query head against the page, 32 keys per pass, and folds it into an
// online softmax kept in registers; the P·V product puts the head dim
// across the lanes.
//
// Bound. Decode reads every live K/V page once: bytes-bound, and at the
// serving shapes (8 slots, a few hundred positions) launch-bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

__device__ __forceinline__ bool valid_index(int j, int p, int cache_len, int window) {
  bool ok;
  if (window > 0) {
    const int slot_w = p % cache_len;
    const int wrap = (p / cache_len) * cache_len;
    const int k_pos = j <= slot_w ? wrap + j : wrap - cache_len + j;
    ok = k_pos >= 0 && k_pos <= p && k_pos > p - window;
  } else {
    ok = j <= p;
  }
  return ok && j < cache_len;
}

template <typename T, int HD>
__global__ void flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                                    const T* __restrict__ vp, const int* __restrict__ table,
                                    const int* __restrict__ pos, T* __restrict__ out, int H, int KH,
                                    int ps, int W, int cache_len, int window, float softcap, float scale) {
  constexpr int DPL = HD / 32;
  extern __shared__ float smem[];
  const int G = H / KH;
  float* qs = smem;                // [G][HD], pre-scaled
  float* ks = qs + G * HD;         // [ps][HD + 1]
  float* vs = ks + ps * (HD + 1);  // [ps][HD]
  int* oks = reinterpret_cast<int*>(vs + ps * HD);  // [ps]

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const int p = pos[b];

  for (int i = tid; i < G * HD; i += blockDim.x)
    qs[i] = to_f(q[((size_t)b * H + kh * G + i / HD) * HD + i % HD]) * scale;

  float m = NEG, l = 0.f, acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

  for (int wi = 0; wi < W; ++wi) {
    const int base = wi * ps;
    bool live = base <= p && base < cache_len;
    if (window > 0) live = live || (p >= cache_len && base < cache_len);
    if (!live) continue;  // uniform across the block
    const size_t page = (size_t)table[(size_t)b * W + wi];
    __syncthreads();
    for (int j = tid; j < ps; j += blockDim.x) oks[j] = valid_index(base + j, p, cache_len, window);
    __syncthreads();
    for (int i = tid; i < ps * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (oks[j]) {
        const size_t off = ((page * ps + j) * KH + kh) * HD + d;
        kx = to_f(kp[off]);
        vx = to_f(vp[off]);
      }
      ks[j * (HD + 1) + d] = kx;
      vs[j * HD + d] = vx;
    }
    __syncthreads();

    const float* qr = qs + g * HD;
    for (int j0 = 0; j0 < ps; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < ps && oks[min(j, ps - 1)];
      float s = 0.f;
      if (j < ps) {
        const float* kr = ks + j * (HD + 1);
#pragma unroll 16
        for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      }
      const float m_new = fmaxf(m, warp_max(ok ? s : NEG));
      const float pj_own = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(pj_own);
      m = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[c] *= corr;
      const int n = min(32, ps - j0);
      for (int jj = 0; jj < n; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pj_own, jj);
        const float* vr = vs + (j0 + jj) * HD + lane;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[c] = fmaf(pj, vr[32 * c], acc[c]);
      }
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  const size_t row = (size_t)b * H + kh * G + g;
#pragma unroll
  for (int c = 0; c < DPL; ++c) out[row * HD + lane + 32 * c] = from_f<T>(acc[c] * inv);
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* table, const int* pos, void* out,
           int B, int H, int KH, int ps, int W, int cache_len, int window, float softcap,
           cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = sizeof(float) * (G * HD + ps * (HD + 1) + ps * HD) + sizeof(int) * ps;
  auto kern = flash_decode_kernel<T, HD>;
  if (smem > 48 * 1024) {  // above the default: opt in
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(KH, B);
  kern<<<grid, 32 * G, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kp),
                                       static_cast<const T*>(vp), table, pos, static_cast<T*>(out), H, KH,
                                       ps, W, cache_len, window, softcap, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* kp, const void* vp, const int* table, const int* pos,
              void* out, int B, int H, int KH, int ps, int W, int cache_len, int window, float softcap,
              cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, kp, vp, table, pos, out, B, H, KH, ps, W, cache_len, window, softcap, stream);
    case 64: return launch<T, 64>(q, kp, vp, table, pos, out, B, H, KH, ps, W, cache_len, window, softcap, stream);
    case 128: return launch<T, 128>(q, kp, vp, table, pos, out, B, H, KH, ps, W, cache_len, window, softcap, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0, a CUDA error code, or -1
// for a shape the kernel does not take (hd not in {32, 64, 128}, G > 32).
extern "C" int flash_decode(const void* q, const void* kp, const void* vp, const int* table, const int* pos,
                            void* out, int B, int H, int KH, int hd, int ps, int W, int cache_len, int window,
                            float softcap, int dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > 32 || ps <= 0 || W <= 0 || cache_len <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(hd, q, kp, vp, table, pos, out, B, H, KH, ps, W, cache_len, window, softcap, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, kp, vp, table, pos, out, B, H, KH, ps, W, cache_len, window, softcap, s);
  return -1;
}
