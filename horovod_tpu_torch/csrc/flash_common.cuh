// Shared machinery of the flash-attention kernels B3 (flash_fwd.cu) and B4
// (flash_bwd.cu) for Hopper (sm_90a): masking, TMA tensor maps and loads,
// mbarrier rings, wgmma descriptors and instructions, all as inline PTX.
//
// Layout (B, T, H, D) everywhere, as in the JAX package: q (B, Tq, H, D),
// k/v (B, Tk, Hkv, D) bf16, H % Hkv == 0 (grouped-query attention: q head h
// reads kv head h / (H/Hkv)). Causal masking against global q_offset /
// kv_offset, a sliding window (query p sees keys [p-window+1, p]), packed
// segment ids, ragged Tq/Tk.
//
// Tiles reach shared memory through the Tensor Memory Accelerator. Each
// operand has one tensor map over its (B, T, heads, D) array read as 4-D
// (D, heads, T, B), with a box of (min(D, 64) columns, 1 head, rows, 1
// batch): the hardware fills rows past T with zeros, so ragged lengths need
// no padding and a tile never reads into the next batch row (the masks
// still exclude those rows). A row of a box is 32, 64 or 128 bytes
// (D = 16, 32, >= 64) and is swizzled by the same span (32B/64B/128B
// swizzle), the layout wgmma reads without bank conflicts; at D = 128 a
// tile is two boxes of 64 columns, one after the other.
//
// wgmma operands are described by 64-bit shared-memory descriptors. An
// operand whose reduction dimension is D (Q, K, V and dO read along the
// head dim) is "K-major": 8-row groups `atom` bytes apart (SBO), a k-step of
// 16 columns moves the start address 32 bytes inside the swizzled row (or
// to the next box). An operand whose reduction dimension runs along the
// tile's rows (V in P·V, dO and Q in the dk/dv products, K in dS·K) is
// "MN-major" (transpose bit set): 8-row groups along K `atom` bytes apart
// (SBO), the second 64-column box `box bytes` further (LBO), a k-step of 16
// rows moves the start address 16 rows. Tiles start on 1024-byte
// boundaries, so the swizzle phase of every address is the hardware's.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the running max of a row that saw nothing
constexpr float kPosBig = 1e30f;
constexpr float kDeadLse = -5e29f;  // an LSE at or below this: a dead row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Two consumer warpgroups (wgmma's 64-row unit each) and a producer
// warpgroup, of which one warp issues every load and the other three exit
// at once. A block's registers are fixed at launch (384 threads × 168):
// setmaxnreg moves them from the producer warpgroup (down to 24) to the
// consumers (up to 240), 128 × 144 = 256 × 72 registers.
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerWarp = kConsumers / 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// The dynamic shared memory a block may use on sm_90.
constexpr int kMaxSmem = 232448;

enum DType { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

struct Shape {
  int b, tq, tk, h, hkv, group;  // group = h / hkv
  int causal, window;            // window <= 0: none
  int q_off, kv_off;
  float scale;                   // softmax scale, natural units
};

// -- masking -------------------------------------------------------------------

__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int ceildiv(int a, int b) {
  return -floordiv(-a, b);
}

// Is key position kpos (local index kloc) visible from query qpos?
__device__ __forceinline__ bool visible(const Shape& s, int qpos, int kpos,
                                        int kloc, int qseg, int kvseg,
                                        bool segs) {
  return kloc < s.tk && (!s.causal || qpos >= kpos) &&
         (s.window <= 0 || kpos > qpos - s.window) && (!segs || qseg == kvseg);
}

// True when every (q, k) pair of the tile pair is visible and every key is
// inside Tk (_block_visibility's "interior"): the tile needs no mask.
__device__ __forceinline__ bool interior(const Shape& s, int q_first,
                                         int q_last, int k_first, int k_last,
                                         int kend_local, bool segs) {
  return !segs && kend_local <= s.tk && (!s.causal || q_first >= k_last) &&
         (s.window <= 0 || k_first >= q_last - (s.window - 1));
}

// The kv tiles [begin, end) of `bk` keys that queries [q_first, q_last]
// (global positions) can see: tiles wholly in the causal future or beyond
// the window are never visited.
__device__ __forceinline__ void kv_tile_range(const Shape& s, int q_first,
                                              int q_last, int bk, int& begin,
                                              int& end) {
  const int nk = (s.tk + bk - 1) / bk;
  begin = 0;
  end = nk;
  if (s.causal) end = min(nk, max(0, floordiv(q_last - s.kv_off, bk) + 1));
  if (s.window > 0)
    begin = max(0, ceildiv(q_first - s.window + 1 - s.kv_off - (bk - 1), bk));
}

// The q tiles [begin, end) of `bq` rows that see keys [k_first, k_last].
__device__ __forceinline__ void q_tile_range(const Shape& s, int k_first,
                                             int k_last, int bq, int& begin,
                                             int& end) {
  const int nq = (s.tq + bq - 1) / bq;
  begin = 0;
  end = nq;
  if (s.causal) begin = max(0, ceildiv(k_first - s.q_off - (bq - 1), bq));
  if (s.window > 0)
    end = min(nq, max(0, floordiv(k_last + s.window - 1 - s.q_off, bq) + 1));
}

// -- registers -------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (-inf gives +0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The A operand of a 64×16 k-step from a 64×N fp32 accumulator: columns
// 16kk..16kk+15 are the accumulator's 8-column blocks 2kk and 2kk+1, and
// the accumulator layout (lane g = lane/4 holds rows g and g+8, columns
// 2(lane%4), +1 of each block) is the register-A layout, rounded to bf16.
template <int R>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&acc)[R],
                                       int kk) {
  const float* x = acc + 8 * kk;
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);

template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Write one warp's 16 rows of a 64×D accumulator (times `mul`) to rows
// row0.. of a (.., T, heads, D) tensor; rows at or beyond `t` are dropped.
template <int D, typename OutT>
__device__ __forceinline__ void store_rows(OutT* base, long long rs, int row0,
                                           int t, const float (&acc)[D / 2],
                                           float mul_lo, float mul_hi,
                                           int lane) {
  const int r_lo = row0 + (lane >> 2), r_hi = r_lo + 8;
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r_lo < t)
      store2<OutT>(base + r_lo * rs + j * 8 + c, acc[4 * j] * mul_lo,
                   acc[4 * j + 1] * mul_lo);
    if (r_hi < t)
      store2<OutT>(base + r_hi * rs + j * 8 + c, acc[4 * j + 2] * mul_hi,
                   acc[4 * j + 3] * mul_hi);
  }
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous instructions that own them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// wgmma reads register A operands while it runs: keep them alive (and
// their registers unused) until after its wait.
template <int K>
__device__ __forceinline__ void keep_frags(const uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3])
                 : "memory");
}

// -- shared memory, mbarriers, TMA ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts 10 s (a tile takes microseconds) can only be a fault of the
// pipeline's protocol: it traps, so the launch fails instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// One TMA load of box (c0.., c1, c2.., c3) of a 4-D tensor map into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- wgmma -------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1: 128B, 2: 64B, 3: 32B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)layout << 62);
}

// One 64×N×16 wgmma, bf16 in, fp32 accumulators d (N/2 per thread): `ss`
// reads A and B from shared memory, `rs` takes A from registers. TB is the
// transpose bit of B (1: MN-major). scale_d = 0 ignores d's old value.
template <int N, int TB>
struct Wgmma;

template <int TB>
struct Wgmma<16, TB> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Wgmma<32, TB> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Wgmma<64, TB> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Wgmma<128, TB> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
};

// -- tiles in shared memory ----------------------------------------------------------

// A tile of ROWS rows of D bf16, as TMA writes it: min(D, 64)-column boxes,
// each ROWS rows of kRowBytes, swizzled by kRowBytes.
template <int D, int ROWS>
struct Tile {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;  // 32, 64 or 128
  static constexpr int kBoxBytes = ROWS * kRowBytes;
  static constexpr int kBytes = ROWS * D * 2;
  static constexpr int kAtom = 8 * kRowBytes;  // 8 swizzled rows
  static constexpr uint32_t kLayout =
      kRowBytes == 128 ? 1u : kRowBytes == 64 ? 2u : 3u;
  static_assert(kBytes % 1024 == 0, "tiles keep 1024-byte alignment");

  // K-major operand (reduction over D): 64 rows from `row0`, k-step kk.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int row0,
                                                    int kk) {
    const int col = kk * 16;
    const uint32_t addr = base + (col / kBoxCols) * kBoxBytes +
                          row0 * kRowBytes + (col % kBoxCols) * 2;
    return make_desc(addr, 16, kAtom, kLayout);
  }

  // MN-major operand (reduction over rows, N = D): rows 16kk..16kk+15.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return make_desc(base + kk * 16 * kRowBytes, kBoxBytes, kAtom, kLayout);
  }

  // Issue the TMA loads of rows t0.. of head `head`, batch `b`.
  static __device__ __forceinline__ void load(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int head, int t0,
                                              int b) {
#pragma unroll
    for (int i = 0; i < kBoxes; ++i)
      tma_load(static_cast<unsigned char*>(dst) + i * kBoxBytes, map, bar,
               i * kBoxCols, head, t0, b);
  }
};

// -- host: tensor maps ------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// entry point, so nothing links against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a (B, T, heads, D) bf16 array with boxes of
// (min(D, 64), 1, rows, 1); false if the encoding is refused.
template <int D>
bool encode_bthd(CUtensorMap* map, const void* ptr, int b, int t, int heads,
                 int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  constexpr int kBoxCols = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)t * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = kBoxCols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : kBoxCols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid_shape(const Shape& s, int d) {
  return s.b > 0 && s.tq > 0 && s.tk > 0 && s.h > 0 && s.hkv > 0 &&
         s.h % s.hkv == 0 && s.group == s.h / s.hkv &&
         (d == 16 || d == 32 || d == 64 || d == 128) &&
         (long long)s.b * s.h <= 0x7fffffffLL;
}

Shape make_shape(int b, int tq, int tk, int h, int hkv, int causal, int window,
                 int q_off, int kv_off, float scale) {
  Shape s;
  s.b = b;
  s.tq = tq;
  s.tk = tk;
  s.h = h;
  s.hkv = hkv;
  s.group = hkv > 0 ? h / hkv : 0;
  s.causal = causal;
  s.window = window;
  s.q_off = q_off;
  s.kv_off = kv_off;
  s.scale = scale;
  return s;
}

// Allow `bytes` of dynamic shared memory, then launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int bytes, cudaStream_t st,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
