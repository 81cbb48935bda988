// Flash attention on Hopper's tensor cores (sm_90a), bf16 in, f32
// accumulate: the forward and both backward passes of the Pallas TPU
// kernels in src/repro/kernels/flash_attention/kernel.py,
//
//   flash_fwd_sm90_kernel     <- _kernel          (:32, pallas_call :372 in
//                                                  flash_attention_pallas)
//   flash_bwd_dq_sm90_kernel  <- _bwd_dq_kernel   (:124, pallas_call :295 in
//                                                  flash_attention_bwd_pallas)
//   flash_bwd_dkv_sm90_kernel <- _bwd_dkv_kernel  (:173, pallas_call :314 in
//                                                  flash_attention_bwd_pallas)
//
// They serve bf16 inputs; f32 inputs go to the CUDA-core kernels of
// flash_attention.cu and flash_attention_bwd.cu, which compute in f32
// throughout. The wrappers in kernel.py choose by dtype.
//
// Contract (as in those kernels). q and dout (B, Sq, H, hd), k and v
// (B, Sk, KH, hd), bf16, read in place; lse and delta (B, Sq, H) f32.
// Head h = kh * G + g, G = H / KH. Positions of queries and keys both count
// from 0. Masks: k < Sk; causal k <= q; window k > q - window; softcap
// cap * tanh(s / cap) on the scaled scores before masking. hd in
// {32, 64, 128}. The forward writes out (bf16) and lse (f32); a
// fully-masked row gets out = 0 and lse = 1e30. The backward passes
// rebuild p = exp(s - lse) and du = p (dp - delta) dact from the forward's
// lse (a fully-masked row's p is exactly 0, so its dq is 0). The dq pass
// writes dq = scale du k (bf16), each row by one block. The dk/dv pass
// writes dk = scale du^T q and dv = p^T dout (bf16), each summed over the G
// query heads of its kv head inside one block, in a fixed order. Neither
// uses atomics: a second call gives the same bits.
//
// Bound. At smollm-135m's training shape (8 x 256 tokens, 9 heads over 3
// kv heads, hd 64, causal) the forward does 0.6 GFLOP of products over
// 6.4 MB, the dq pass 0.9 GFLOP and the dk/dv pass 1.2 GFLOP over about
// 9 MB each: at the bf16 tensor cores' rate (989 TFLOP/s) all three are
// bound by the bytes (2-3 us at 3.35 TB/s); the CUDA-core kernels they
// replace for bf16 computed in f32, far from either bound (the dq pass
// there took 187 us, bound by its f32 arithmetic and shared-memory reads).
// What the design does about it:
//
// * Products on the tensor cores. Every matrix product is a wgmma
//   (m64nNk16, bf16 in, f32 accumulate) issued by one consumer warpgroup
//   (4 warps). S = Q K^T (and dP = dout V^T) read both operands from
//   shared memory, K-major; P V takes P from registers: the m64n64
//   accumulator of S, rounded to bf16, is already laid out as wgmma's A
//   fragments for the next product, so P never touches shared memory. dS
//   feeds dS K (dq pass) and dS^T Q (dk/dv pass) the same way. V, K (dq
//   pass) and dout and Q (dk/dv pass) are then MN-major B operands, read
//   with wgmma's transpose bit.
// * Copies by TMA, overlapped with the products. One producer warp issues
//   4-D tensor-map loads (cp.async.bulk.tensor) of whole 64-row tiles
//   straight from the JAX layouts (rows of one head are H * hd apart, which
//   a 4-D map addresses and a flat bulk copy cannot) into a 2-stage ring;
//   each stage has a full and an empty mbarrier, so the next tile loads
//   while the current one computes. The maps swizzle the tiles as wgmma's
//   descriptors expect: 128-byte swizzle for 64-column boxes (hd 64; hd 128
//   is two boxes), 64-byte swizzle for hd 32. Out-of-range rows come in as
//   zeros and are masked by position.
// * Softmax in registers. A row's 64 scores of a tile lie in the 4 threads
//   of a quad, so its max and sum take 2 shuffles each. Only tiles that
//   cross the causal diagonal, the window edge or a sequence end are
//   masked; tiles no row can see are never loaded.
//
// Forward and dq pass: one block per (query head, batch row, 64 query
// positions), q tiles last to first so the heaviest causal blocks start in
// the first wave (288 blocks at the training shape). The G heads of one kv
// head re-read its K/V tiles from L2 (a training batch's K and V are
// 1.5 MB against 50 MB of L2), which keeps each row's position equal to its
// row index. The dq pass loads its Q and dout tiles once, streams K and V
// through the ring, and keeps dq in the warpgroup's registers over the
// sweep beside S and dP (64 + 64 f32 a thread, and at hd 128 another 64 for
// dq; ptxas reports no spill at any hd). Its lse and delta (two rows a
// thread) sit in registers. dS is rounded to bf16 for dS K, as P is for
// P V; the f32 CUDA-core pass stays for f32 inputs.
// dk/dv pass: one block per (64 keys, kv head,
// batch row); the K and V tiles are loaded once, and the block walks the
// G heads and, for each, the 64-row q tiles that can see its keys (causal:
// from its first key; window: below its last key + window), with dk and
// dv accumulated in the warpgroup's registers throughout (at hd 128 they
// take 128 of a thread's registers, and the pass spills a few). At the
// training shape that is 96
// blocks on 132 SMs: splitting the sweep over a second warpgroup is later
// work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                     // query rows of a tile
constexpr int BN = 64;                     // keys of a tile
constexpr int STAGES = 2;                  // depth of the TMA ring
constexpr int CONSUMERS = 128;             // one warpgroup runs the products
constexpr int THREADS = CONSUMERS + 32;    // and one warp issues the copies
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED_LSE = 1e30f;

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of the given parity has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once: a producer's first
// wait on an empty slot passes. A wait that never ends (a copy that never
// lands) traps, so it fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// A box of a 4-D tensor map into shared memory; completion counts its
// bytes on the mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (before wg_fence, after wg_wait_all).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (static_cast<uint64_t>(swizzle) << 62);
}

// A tile of 64 rows by HD bf16 columns, as TMA leaves it in shared memory:
// HD / CW boxes of 64 rows by CW columns, each row CW * 2 bytes, swizzled
// in 8-row atoms (1024 bytes at CW = 64, 512 at CW = 32).
template <int HD>
struct Tile {
  static constexpr int CW = HD < 64 ? HD : 64;       // columns per box
  static constexpr int BOX = 64 * CW * 2;             // bytes per box
  static constexpr int BYTES = 64 * HD * 2;           // bytes per tile
  static constexpr uint32_t SWIZZLE = CW == 64 ? 1 : 2;
  static constexpr uint32_t ATOM = 8 * CW * 2;        // bytes of 8 rows

  // Rows of the tile are the product's M or N, its columns the K (16 per
  // step): step kk lies in box 16 kk / CW, at byte 32 * (kk % (CW / 16))
  // of each row; the hardware applies the swizzle to the full address.
  static __device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
    return make_desc(tile + (16 * kk / CW) * BOX + (16 * kk % CW) * 2, 16, ATOM, SWIZZLE);
  }
  // Rows of the tile are the product's K (16 per step), its columns the N:
  // step kk starts at row 16 kk; 8-row groups are ATOM apart along K (the
  // stride offset) and boxes BOX apart along N (the leading offset).
  static __device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
    return make_desc(tile + 16 * kk * CW * 2, BOX, ATOM, SWIZZLE);
  }
  // Rows row0 .. row0 + 63 of head `head` of batch row b, every column.
  static __device__ __forceinline__ void load(uint32_t tile, const CUtensorMap* map, uint32_t bar, int head, int row0,
                                              int b) {
#pragma unroll
    for (int c = 0; c < HD / CW; ++c) tma_load_4d(tile + c * BOX, map, bar, c * CW, head, row0, b);
  }
};

// ---------------------------------------------------------------------------
// wgmma m64nNk16, bf16 in, f32 accumulate (the operand lists spelled out)

// D (64 x 64, f32) {=, +=} A (64 x 16, K-major in shared memory) * B (64 x 16, K-major in
// shared memory); accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, f32) += A (64 x 16 bf16, in registers) * B (16 x 32, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16 bf16, in registers) * B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16 bf16, in registers) * B (16 x 128, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ bool visible(int qp, int key, int Sq, int Sk, int causal, int window) {
  bool ok = qp < Sq && key < Sk;
  if (causal) ok = ok && key <= qp;
  if (window > 0) ok = ok && key > qp - window;
  return ok;
}

// The 4 A fragments (16 columns each) of a 64 x 64 accumulator rounded to
// bf16: accumulator entries 8 kk .. 8 kk + 7 of a thread are exactly its
// A registers for step kk.
__device__ __forceinline__ void to_a_frags(const float (&acc)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// ---------------------------------------------------------------------------
// forward

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int H, int KH, int causal, int window, float softcap,
                      float scale) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q, full[STAGES], empty[STAGES]
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t q_bar = smem_u32(&bars[0]);
  auto k_tile = [&](int s) { return base + (1 + s) * T::BYTES; };
  auto v_tile = [&](int s) { return base + (1 + STAGES + s) * T::BYTES; };
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };

  // the q tiles run last to first, so under a causal mask the blocks with
  // the most kv tiles start in the first wave and the light ones fill the tail
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / KH);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  // the kv tiles some row of this block can see
  const int q_last = min(q0 + BM, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int t_first = k_lo / BN;
  const int n_tiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - t_first : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_bar, T::BYTES);
      T::load(q_tile, &tq, q_bar, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::BYTES);
        const int key0 = (t_first + i) * BN;
        T::load(k_tile(s), &tk, full(s), kh, key0, b);
        T::load(v_tile(s), &tv, full(s), kh, key0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: thread owns rows row0 and row0 + 8 of the tile,
  // and columns col0 + 8 j + {0, 1} of each (the wgmma accumulator layout)
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  float o[HD / 2], sc[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // row max (log2 units), thread's part of the row sum
  const float qk_scale = scale * LOG2E;

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);

    // S = Q K^T
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(sc, T::k_major(q_tile, kk), T::k_major(k_tile(s), kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scale (log2 units), softcap, masks
    const int key0 = (t_first + i) * BN;
    const bool edge = key0 + BN > Sk || (causal && key0 + BN - 1 > q0) || (window > 0 && key0 <= q0 + BM - 1 - window);
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      float x = sc[idx];
      x = softcap > 0.f ? softcap * LOG2E * tanhf(x * (scale / softcap)) : x * qk_scale;
      if (edge) {
        const int qp = q0 + row0 + 8 * ((idx >> 1) & 1), key = key0 + 8 * (idx >> 2) + col0 + (idx & 1);
        if (!visible(qp, key, Sq, Sk, causal, window)) x = -INFINITY;
      }
      sc[idx] = x;
    }

    // online softmax: a row lies in the 4 threads of a quad
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float ref = mx == -INFINITY ? 0.f : mx;  // a row that has seen nothing yet keeps p = 0
      const float corr = exp2f(m[hf] - ref);
      m[hf] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * hf + e] - ref);
          sc[4 * j + 2 * hf + e] = p;
          sum += p;
        }
      l[hf] = l[hf] * corr + sum;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 2 * hf] *= corr;
        o[4 * j + 2 * hf + 1] *= corr;
      }
    }

    // O += P V, P from registers
    uint32_t pa[4][4];
    to_a_frags(sc, pa);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, pa[kk], T::mn_major(v_tile(s), kk));
    wg_commit();
    wg_wait_all();
    fence_regs(o);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qp = q0 + row0 + 8 * hf;
    if (qp >= Sq) continue;
    const size_t row = (static_cast<size_t>(b) * Sq + qp) * H + h;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    __nv_bfloat16* dst = out + row * HD + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    if ((lane & 3) == 0) lse[row] = sum > 0.f ? (m[hf] + log2f(sum)) * LN2 : MASKED_LSE;
  }
}

// ---------------------------------------------------------------------------
// dk/dv pass

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                          int KH, int causal, int window, float softcap, float scale) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // k/v, full[STAGES], empty[STAGES]
  __shared__ float lse_s[STAGES][BM];                     // lse * log2(e) of the stage's q rows
  __shared__ float delta_s[STAGES][BM];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t k_tile = base, v_tile = base + T::BYTES;
  const uint32_t kv_bar = smem_u32(&bars[0]);
  auto q_tile = [&](int s) { return base + (2 + s) * T::BYTES; };
  auto do_tile = [&](int s) { return base + (2 + STAGES + s) * T::BYTES; };
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };

  const int kh = blockIdx.y, b = blockIdx.z, G = H / KH;
  const int k0 = blockIdx.x * BN;
  // the q tiles that can see some key of this block, for each of the G heads
  const int k_last = min(k0 + BN, Sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;  // exclusive
  const int t_first = q_lo / BM;
  const int nt = q_hi > q_lo ? (q_hi + BM - 1) / BM - t_first : 0;
  const int n_items = G * nt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);  // every producer lane writes lse and delta, then arrives
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * T::BYTES);
      T::load(k_tile, &tk, kv_bar, kh, k0, b);
      T::load(v_tile, &tv, kv_bar, kh, k0, b);
    }
    for (int it = 0; it < n_items; ++it) {
      const int s = it % STAGES;
      const int h = kh * G + it / nt, qt0 = (t_first + it % nt) * BM;
      mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
      for (int r = lane; r < BM; r += 32) {
        const int qp = qt0 + r;
        const size_t row = (static_cast<size_t>(b) * Sq + qp) * H + h;
        lse_s[s][r] = qp < Sq ? lse[row] * LOG2E : MASKED_LSE;
        delta_s[s][r] = qp < Sq ? delta[row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * T::BYTES);
        T::load(q_tile(s), &tq, full(s), h, qt0, b);
        T::load(do_tile(s), &tdo, full(s), h, qt0, b);
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // the consumer warpgroup: rows are keys (row0, row0 + 8), columns q rows
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  float dka[HD / 2], dva[HD / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  const float qk_scale = scale * LOG2E;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % STAGES;
    const int qt0 = (t_first + it % nt) * BM;
    mbar_wait(full(s), (it / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dout^T
    fence_regs(st);
    fence_regs(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(st, T::k_major(k_tile, kk), T::k_major(q_tile(s), kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(dpt, T::k_major(v_tile, kk), T::k_major(do_tile(s), kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(s - lse), masked; dS^T = P^T (dP^T - delta) dact
    const bool edge = k0 + BN > Sk || qt0 + BM > Sq || (causal && k0 + BN - 1 > qt0) ||
                      (window > 0 && qt0 + BM - 1 >= k0 + window);
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int qc = 8 * (idx >> 2) + col0 + (idx & 1);
      const float row_lse = lse_s[s][qc];
      float p, dact = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(st[idx] * (scale / softcap));
        p = exp2f(fmaf(t, softcap * LOG2E, -row_lse));
        dact = 1.f - t * t;
      } else {
        p = exp2f(fmaf(st[idx], qk_scale, -row_lse));
      }
      if (edge && !visible(qt0 + qc, k0 + row0 + 8 * ((idx >> 1) & 1), Sq, Sk, causal, window)) p = 0.f;
      st[idx] = p;
      dpt[idx] = p * (dpt[idx] - delta_s[s][qc]) * dact;
    }

    // dV += P^T dout and dK += dS^T Q, the left operands from registers
    uint32_t pa[4][4], da[4][4];
    to_a_frags(st, pa);
    to_a_frags(dpt, da);
    fence_regs(dva);
    fence_regs(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dva, pa[kk], T::mn_major(do_tile(s), kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dka, da[kk], T::mn_major(q_tile(s), kk));
    wg_commit();
    wg_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + row0 + 8 * hf;
    if (key >= Sk) continue;
    const size_t row = (static_cast<size_t>(b) * Sk + key) * KH + kh;
    __nv_bfloat16* dkr = dk + row * HD + col0;
    __nv_bfloat16* dvr = dv + row * HD + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * hf] * scale, dka[4 * j + 2 * hf + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * hf], dva[4 * j + 2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq pass

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KH, int causal, int window,
                         float softcap, float scale) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q/dout, full[STAGES], empty[STAGES]
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t q_tile = base, do_tile = base + T::BYTES;
  const uint32_t q_bar = smem_u32(&bars[0]);
  auto k_tile = [&](int s) { return base + (2 + s) * T::BYTES; };
  auto v_tile = [&](int s) { return base + (2 + STAGES + s) * T::BYTES; };
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };

  // as in the forward: q tiles last to first, and the kv tiles some row of
  // this block can see
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / KH);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int q_last = min(q0 + BM, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int t_first = k_lo / BN;
  const int n_tiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - t_first : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_bar, 2 * T::BYTES);
      T::load(q_tile, &tq, q_bar, h, q0, b);
      T::load(do_tile, &tdo, q_bar, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::BYTES);
        const int key0 = (t_first + i) * BN;
        T::load(k_tile(s), &tk, full(s), kh, key0, b);
        T::load(v_tile(s), &tv, full(s), kh, key0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: thread owns rows row0 and row0 + 8 of the tile,
  // whose lse (log2 units) and delta it keeps in registers
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = q0 + row0 + 8 * hf;
    const size_t row = (static_cast<size_t>(b) * Sq + qp) * H + h;
    row_lse[hf] = qp < Sq ? lse[row] * LOG2E : MASKED_LSE;
    row_delta[hf] = qp < Sq ? delta[row] : 0.f;
  }
  float dqa[HD / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  const float qk_scale = scale * LOG2E;

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);

    // S = Q K^T and dP = dout V^T
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(sc, T::k_major(q_tile, kk), T::k_major(k_tile(s), kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(dp, T::k_major(do_tile, kk), T::k_major(v_tile(s), kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp(s - lse), masked; dS = P (dP - delta) dact, in place of dP
    const int key0 = (t_first + i) * BN;
    const bool edge = key0 + BN > Sk || (causal && key0 + BN - 1 > q0) || (window > 0 && key0 <= q0 + BM - 1 - window);
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int hf = (idx >> 1) & 1;
      float p, dact = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(sc[idx] * (scale / softcap));
        p = exp2f(fmaf(t, softcap * LOG2E, -row_lse[hf]));
        dact = 1.f - t * t;
      } else {
        p = exp2f(fmaf(sc[idx], qk_scale, -row_lse[hf]));
      }
      if (edge && !visible(q0 + row0 + 8 * hf, key0 + 8 * (idx >> 2) + col0 + (idx & 1), Sq, Sk, causal, window))
        p = 0.f;
      dp[idx] = p * (dp[idx] - row_delta[hf]) * dact;
    }

    // dQ += dS K, dS from registers (rounded to bf16), K MN-major
    uint32_t da[4][4];
    to_a_frags(dp, da);
    fence_regs(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dqa, da[kk], T::mn_major(k_tile(s), kk));
    wg_commit();
    wg_wait_all();
    fence_regs(dqa);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = q0 + row0 + 8 * hf;
    if (qp >= Sq) continue;
    const size_t row = (static_cast<size_t>(b) * Sq + qp) * H + h;
    __nv_bfloat16* dst = dq + row * HD + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * hf] * scale, dqa[4 * j + 2 * hf + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launchers

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_SHAPE = -1;       // a shape the kernels do not take
constexpr int ERR_NO_ENCODE = -2;   // the CUDA driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = -1000;   // minus the CUresult of a failed encode

// The CUDA driver's tensor-map encoder, found through the runtime (the library
// links no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map of a (B, S, heads, HD) bf16 tensor, innermost first, with a
// box of CW columns of one head for 64 positions.
template <int HD>
int make_map(CUtensorMap* map, const void* ptr, int heads, int seq, int B) {
  using T = Tile<HD>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)heads * HD * 2, (cuuint64_t)seq * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::CW, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, T::CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE - (int)r;
}

// Opts a kernel in to its dynamic shared memory. Each launcher calls it
// once per process, in a function-local static (the size depends only on
// the kernel), so later launches, CUDA-graph captures among them, make no
// attribute call.
template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq, int Sk, int H,
               int KH, int causal, int window, float softcap, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (int err = make_map<HD>(&mq, q, H, Sq, B)) return err;
  if (int err = make_map<HD>(&mk, k, KH, Sk, B)) return err;
  if (int err = make_map<HD>(&mv, v, KH, Sk, B)) return err;
  const size_t smem = 1024 + (1 + 2 * STAGES) * Tile<HD>::BYTES;
  auto kern = flash_fwd_sm90_kernel<HD>;
  static const int smem_err = set_smem(kern, smem);
  if (smem_err) return smem_err;
  dim3 grid(H, B, (Sq + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H, KH, causal,
                                         window, softcap, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int Sq, int Sk, int H, int KH, int causal, int window, float softcap,
               cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (int err = make_map<HD>(&mq, q, H, Sq, B)) return err;
  if (int err = make_map<HD>(&mk, k, KH, Sk, B)) return err;
  if (int err = make_map<HD>(&mv, v, KH, Sk, B)) return err;
  if (int err = make_map<HD>(&mdo, dout, H, Sq, B)) return err;
  const size_t smem = 1024 + (2 + 2 * STAGES) * Tile<HD>::BYTES;
  auto kern = flash_bwd_dkv_sm90_kernel<HD>;
  static const int smem_err = set_smem(kern, smem);
  if (smem_err) return smem_err;
  dim3 grid((Sk + BN - 1) / BN, KH, B);
  kern<<<grid, THREADS, smem, stream>>>(mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
                                         static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, KH, causal, window, softcap,
                                         1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
              void* dq, int B, int Sq, int Sk, int H, int KH, int causal, int window, float softcap,
              cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (int err = make_map<HD>(&mq, q, H, Sq, B)) return err;
  if (int err = make_map<HD>(&mk, k, KH, Sk, B)) return err;
  if (int err = make_map<HD>(&mv, v, KH, Sk, B)) return err;
  if (int err = make_map<HD>(&mdo, dout, H, Sq, B)) return err;
  const size_t smem = 1024 + (2 + 2 * STAGES) * Tile<HD>::BYTES;
  auto kern = flash_bwd_dq_sm90_kernel<HD>;
  static const int smem_err = set_smem(kern, smem);
  if (smem_err) return smem_err;
  dim3 grid(H, B, (Sq + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, KH,
                                         causal, window, softcap, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// also past the grid's limits: 65535 batch rows, 65535 q tiles
bool bad_shape(int B, int Sq, int Sk, int H, int KH) {
  return B <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 || B > 65535 || (Sq + BM - 1) / BM > 65535;
}

}  // namespace

// bf16 only. Each returns 0, a CUDA error code, -1 for a shape the kernels
// do not take (hd not in {32, 64, 128}), -2 when the CUDA driver offers no
// tensor-map encoder, or -1000 - r when encoding a map failed with CUresult r.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                                        int Sq, int Sk, int H, int KH, int hd, int causal, int window,
                                        float softcap, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH)) return ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_fwd<32>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, window, softcap, s);
    case 64: return launch_fwd<64>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, window, softcap, s);
    case 128: return launch_fwd<128>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, window, softcap, s);
    default: return ERR_SHAPE;
  }
}

extern "C" int flash_attention_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                            const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                                            int Sk, int H, int KH, int hd, int causal, int window, float softcap,
                                            void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH)) return ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KH, causal, window, softcap, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KH, causal, window, softcap, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KH, causal, window, softcap, s);
    default: return ERR_SHAPE;
  }
}

extern "C" int flash_attention_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                           const float* lse, const float* delta, void* dq, int B, int Sq, int Sk,
                                           int H, int KH, int hd, int causal, int window, float softcap,
                                           void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH)) return ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KH, causal, window, softcap, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KH, causal, window, softcap, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KH, causal, window, softcap, s);
    default: return ERR_SHAPE;
  }
}
