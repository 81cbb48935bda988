// Paged flash-decode (Sq = 1) attention for Hopper (sm_90a), split across
// the card (flash-decoding): the CUDA C++ port of the Pallas TPU kernel
// src/repro/kernels/flash_decode/kernel.py flash_decode_pallas (_kernel,
// pallas_call :145).
//
// q (B, H, hd); k_pages and v_pages (P, ps, KH, hd), read in place (f32 or
// bf16, contiguous, 16-byte aligned); page_table (B, W) int32; pos (B,)
// int32; out (B, H, hd) in q's dtype. Logical index j of row b lives at
// (page_table[b, j / ps], j % ps). Without a window j is the absolute
// position (valid iff j <= pos); with one, the logical space is a ring of
// cache_len slots and j's absolute position is rebuilt from the write head
// pos % cache_len, as the dense decode does. j >= cache_len is never valid.
//
// Bound. Decode reads every live K/V page once for 4 flops per element:
// bytes. At the serving shape (8 slots at position 160, 16-token pages,
// 9 heads over 3 kv heads, hd 64, bf16) that is about 1 MB, 0.3 us at
// 3.35 TB/s, far below a launch. What held the first version back was not
// the bytes but the latency: 24 blocks, each walking its pages one after
// another, one memory round trip and three barriers per page.
//
// Design.
//
// * Split the pages across the card. The grid is (S, KH, B): S splits of
//   each (row, kv head)'s live table entries. S comes from B, KH and W
//   alone (kernel.py decode_splits: B KH S covers the 132 SMs), so the
//   grid never depends on the data and no call reads pos on the host. Each
//   block reads its row's pos on the device, counts the row's live entries
//   (the JAX page_live predicate: the entries up to ceil((pos + 1) / ps),
//   or, once a ring has wrapped, all ceil(cache_len / ps)) and takes the
//   s-th of S near-equal shares of them, in order. Entries past the live
//   ones are never touched, however large W is.
// * All of a block's pages in flight at once. The block loads its page ids,
//   then issues a 16-byte cp.async for every row piece of every page's K
//   and V before the first wait, so the block pays one memory latency, not
//   one per page. Rows stay in the input dtype in shared memory; a masked
//   position is zero-filled by the copy itself (source size 0), so a table
//   entry that points at the engine's scratch page contributes nothing and
//   is never read. A split with more pages than fit the staging buffer
//   (about 64 KB) walks them in chunks of that size.
// * Few idle lanes. HD * sizeof(T) / 16 pieces of 16 bytes make a key row
//   (8 at hd 64 in bf16, 16 in f32); the lanes of a key are that count
//   rounded up to a power of two, so a key's lanes sit in one aligned group
//   of a warp and a log-step shuffle sums its score. Where the pieces are a
//   power of two (hd 32, 64, 128) no lane idles: a warp scores 4 keys (2
//   in f32) at once at hd 64 and a 128-thread block a 16-token page. At hd
//   80 and 96 (10 and 12 pieces in bf16, 20 and 24 in f32) the extra lanes
//   of a key's group (6 and 4 of 16, 12 and 8 of 32) hold zero pieces and
//   issue no copy. The staging rows stay HD * sizeof(T) bytes, a multiple
//   of 16 at every hd. The G query heads of the kv head reuse each key's
//   registers. The softmax runs one warp per head over the chunk's scores in
//   shared memory, and P V gives each thread one (head, dim) output, read
//   across the staged V rows. At G = 3 query rows the tensor cores would
//   idle: a wgmma tile has 64 rows.
// * Combine without atomics. Each split writes its f32 partials (m, l and
//   acc[hd] for each of its G heads) to scratch, and a second kernel,
//   launched from the same entry point, combines the S partials of each
//   (row, head) in split order: out = sum_s acc_s e^(m_s - M) /
//   sum_s l_s e^(m_s - M). A split with no live entry writes m = -1e30,
//   l = 0. A second call gives the same bits. With S = 1 the split kernel
//   writes out itself.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_BYTES = 64 * 1024;  // K and V rows of one chunk, at least one page
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// 16 bytes of a row in shared memory, as f32
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[N]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
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

// Shared memory of a split block, in bytes from a 16-byte-aligned base:
// K and V rows of a chunk (T), then f32 q (pre-scaled), acc, the chunk's
// scores, m, l and the rescale of each head, then the chunk's page ids.
template <typename T, int HD>
struct Layout {
  int ks, vs, qs, acc, sc, m, l, corr, pid, bytes;
  __host__ __device__ Layout(int G, int chunk_pages, int ps) {
    const int tokens = chunk_pages * ps;
    ks = 0;
    vs = ks + tokens * HD * (int)sizeof(T);
    qs = vs + tokens * HD * (int)sizeof(T);
    acc = qs + G * HD * 4;
    sc = acc + G * HD * 4;
    m = sc + G * tokens * 4;
    l = m + G * 4;
    corr = l + G * 4;
    pid = corr + G * 4;
    bytes = pid + chunk_pages * 4;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                          const int* __restrict__ table, const int* __restrict__ pos, T* __restrict__ out,
                          float* __restrict__ part, int H, int KH, int ps, int W, int cache_len, int window,
                          float softcap, float scale, int chunk_pages) {
  constexpr int VN = Piece<T>::N;  // elements of a 16-byte piece
  constexpr int LPK = HD / VN;     // pieces of a key row
  static_assert(HD % VN == 0 && LPK <= 32, "a key row is at most 32 whole 16-byte pieces");
  constexpr int LANES = LPK <= 1 ? 1 : LPK <= 2 ? 2 : LPK <= 4 ? 4 : LPK <= 8 ? 8 : LPK <= 16 ? 16 : 32;
  constexpr int KPP = THREADS / LANES;  // keys scored per pass of the block
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = H / KH;
  const Layout<T, HD> L(G, chunk_pages, ps);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* corr_s = reinterpret_cast<float*>(smem + L.corr);
  int* pid = reinterpret_cast<int*>(smem + L.pid);
  const int tokens_cap = chunk_pages * ps;

  const int split = blockIdx.x, S = gridDim.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  // this row's live table entries, and this split's share of them
  const int n_live = max(0, min(W, (min(p + 1, cache_len) + ps - 1) / ps));
  const int lo = (int)((long long)split * n_live / S), hi = (int)((long long)(split + 1) * n_live / S);

  for (int i = tid; i < G * HD; i += THREADS) {
    qs[i] = to_f(q[((size_t)b * H + kh * G) * HD + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG;
    l_s[g] = 0.f;
  }

  for (int c0 = lo; c0 < hi; c0 += chunk_pages) {
    const int np = min(chunk_pages, hi - c0), n_tok = np * ps;
    __syncthreads();  // the previous chunk is done with the buffers
    for (int i = tid; i < np; i += THREADS) pid[i] = table[(size_t)b * W + c0 + i];
    __syncthreads();
    // every 16-byte piece of every K and V row of the chunk, all in flight
    for (int i = tid; i < n_tok * LPK; i += THREADS) {
      const int t = i / LPK, piece = i % LPK;
      const int page = t / ps, j = t % ps;
      const bool ok = valid_index((c0 + page) * ps + j, p, cache_len, window);
      const size_t off = (((size_t)pid[page] * ps + j) * KH + kh) * HD + piece * VN;
      cp_async16(ks + t * HD + piece * VN, ok ? kp + off : kp, ok ? 16 : 0);
      cp_async16(vs + t * HD + piece * VN, ok ? vp + off : vp, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: LANES lanes per key (the first LPK hold its pieces), every
    // head of the group against it
    const int sub = tid % LANES, slot = tid / LANES;
    for (int t0 = 0; t0 < n_tok; t0 += KPP) {  // uniform bound: every lane takes part in the shuffles
      const int t = t0 + slot;
      const bool in = t < n_tok;
      const bool holds = sub < LPK;  // this lane holds a piece of the key
      float kx[VN];
      if (in && holds) {
        Piece<T>::load(ks + t * HD + sub * VN, kx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kx[e] = 0.f;
      }
      const bool ok = in && valid_index((c0 + t / ps) * ps + t % ps, p, cache_len, window);
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        if (holds) {
          const float* qr = qs + g * HD + sub * VN;
#pragma unroll
          for (int e = 0; e < VN; ++e) s = fmaf(qr[e], kx[e], s);
        }
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (in && sub == 0) {
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          sc[g * tokens_cap + t] = ok ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per head: p = e^(s - m) in place of s
    for (int g = warp; g < G; g += WARPS) {
      float* sr = sc + g * tokens_cap;
      float mx = -INFINITY;
      for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, sr[t]);
      const float m_old = m_s[g], m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < n_tok; t += 32) {
        const float e = expf(sr[t] - m_new);
        sr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: one (head, dim) output per thread and pass
    for (int o = tid; o < G * HD; o += THREADS) {
      const int g = o / HD, d = o % HD;
      const float* pr = sc + g * tokens_cap;
      float a = acc[o] * corr_s[g];
      for (int t = 0; t < n_tok; ++t) a = fmaf(pr[t], to_f(vs[t * HD + d]), a);
      acc[o] = a;
    }
  }
  __syncthreads();

  const size_t row0 = (size_t)b * H + kh * G;  // the group's first (row, head)
  if (S == 1) {
    for (int o = tid; o < G * HD; o += THREADS) {
      const float l = l_s[o / HD];
      out[row0 * HD + o] = from_f<T>(l > 0.f ? acc[o] / l : 0.f);
    }
    return;
  }
  // partials: acc (B H, S, HD), then (m, l) (B H, S, 2)
  const size_t rows = (size_t)gridDim.z * H;
  for (int o = tid; o < G * HD; o += THREADS) {
    const int g = o / HD, d = o % HD;
    part[((row0 + g) * S + split) * HD + d] = acc[o];
  }
  float* ml = part + rows * S * HD;
  for (int g = tid; g < G; g += THREADS) {
    ml[((row0 + g) * S + split) * 2] = m_s[g];
    ml[((row0 + g) * S + split) * 2 + 1] = l_s[g];
  }
}

// One thread per (row, head, dim): the S partials in split order.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int rows, int HD, int S) {
  const int i = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= rows * HD) return;
  const int r = i / HD, d = i % HD;
  const float* ml = part + (size_t)rows * S * HD + (size_t)r * S * 2;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < S; ++s) {
    const float w = expf(ml[2 * s] - M);
    l = fmaf(ml[2 * s + 1], w, l);
    a = fmaf(part[((size_t)r * S + s) * HD + d], w, a);
  }
  out[i] = from_f<T>(l > 0.f ? a / l : 0.f);
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* table, const int* pos, void* out, float* part,
           int B, int H, int KH, int ps, int W, int cache_len, int window, float softcap, int S,
           cudaStream_t stream) {
  const int G = H / KH;
  const int page_bytes = 2 * ps * HD * (int)sizeof(T);
  const int chunk_pages = max(1, min((W + S - 1) / S, STAGE_BYTES / page_bytes));
  const Layout<T, HD> L(G, chunk_pages, ps);
  auto kern = flash_decode_split_kernel<T, HD>;
  // opt in to the largest shared memory a block can have, once per kernel
  // (so a CUDA-graph capture of a later call makes no attribute call)
  static const int smem_err =
      (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (smem_err) return smem_err;
  dim3 grid(S, KH, B);
  kern<<<grid, THREADS, L.bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kp),
                                           static_cast<const T*>(vp), table, pos, static_cast<T*>(out), part, H, KH,
                                           ps, W, cache_len, window, softcap, 1.f / sqrtf((float)HD), chunk_pages);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (S == 1) return 0;
  const int n = B * H * HD;
  flash_decode_combine_kernel<T><<<(n + COMBINE_THREADS - 1) / COMBINE_THREADS, COMBINE_THREADS, 0, stream>>>(
      part, static_cast<T*>(out), B * H, HD, S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* kp, const void* vp, const int* table, const int* pos, void* out,
              float* part, int B, int H, int KH, int ps, int W, int cache_len, int window, float softcap, int S,
              cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, kp, vp, table, pos, out, part, B, H, KH, ps, W, cache_len, window, softcap, S, stream);
    case 64: return launch<T, 64>(q, kp, vp, table, pos, out, part, B, H, KH, ps, W, cache_len, window, softcap, S, stream);
    case 80: return launch<T, 80>(q, kp, vp, table, pos, out, part, B, H, KH, ps, W, cache_len, window, softcap, S, stream);
    case 96: return launch<T, 96>(q, kp, vp, table, pos, out, part, B, H, KH, ps, W, cache_len, window, softcap, S, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, table, pos, out, part, B, H, KH, ps, W, cache_len, window, softcap, S, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. splits: S >= 1 (part: B H S (hd + 2)
// f32 of scratch when S > 1, else unused). Returns 0, a CUDA error code, or
// -1 for a shape the kernel does not take (hd not in {32, 64, 80, 96, 128},
// G > 32, a grid past its limits).
extern "C" int flash_decode(const void* q, const void* kp, const void* vp, const int* table, const int* pos,
                            void* out, float* part, int B, int H, int KH, int hd, int ps, int W, int cache_len,
                            int window, float softcap, int splits, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || KH <= 0 || KH > 65535 || H % KH != 0 || H / KH > 32 || ps <= 0 || W <= 0 ||
      cache_len <= 0 || splits <= 0 || (splits > 1 && part == nullptr))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, kp, vp, table, pos, out, part, B, H, KH, ps, W, cache_len, window, softcap, splits, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, kp, vp, table, pos, out, part, B, H, KH, ps, W, cache_len, window, softcap,
                                    splits, s);
  return -1;
}
