// Flash attention for Hopper (sm_90a): kernels B3 (forward) and B4 (backward).
//
// Replaces the TPU's Pallas kernels in horovod_tpu/ops/flash_attention.py:
//   B3 flash_fwd_kernel                  <- _fwd_kernel        (O and per-row LSE)
//   B4 flash_bwd_dkdv_kernel +
//      flash_bwd_dq_kernel               <- _bwd_fused_kernel  (dq, dk, dv)
// Layout (B, T, H, D) everywhere, as in the JAX package: q (B, Tq, H, D),
// k/v (B, Tk, Hkv, D) bf16, H % Hkv == 0 (grouped-query attention: q head h
// reads kv head h / (H/Hkv)). Causal masking against global q_offset /
// kv_offset, a sliding window (query p sees keys [p-window+1, p]), packed
// segment ids, ragged Tq/Tk (masked by bounds, nothing padded or copied).
// O is written in bf16 or fp32 (the caller's dtype), the LSE as fp32
// (B, H, Tq) in natural-log units.
//
// Bound. At the LM's shape (B=2, T=8192, H=8, D=128, causal) one forward
// does 2 products of 2·B·H·T²·D/2 flops ≈ 275 GFLOP against ≈ 100 MB of
// q/k/v/O: ≈ 2700 flops per byte, far above the card's ≈ 295 balance point,
// so the tensor cores bound it (≈ 0.28 ms at 989 TFLOP/s dense bf16, H100
// SXM data sheet); the backward's 5-product minimum gives ≈ 0.69 ms.
//
// Design against that bound, kept simple for a first port (no TMA, no
// wgmma, no pipelining — a later PR's work):
//  * Products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate), with operand fragments read from shared memory and
//    the score tile kept in registers: the m16n8k16 accumulator layout is
//    the A-operand layout of the next product, so P (forward) and dS
//    (backward) go from softmax straight into the next mma without a trip
//    through shared memory.
//  * One block of 4 warps per (q tile of 64 rows, head, batch) in the
//    forward and the dq kernel; each warp owns 16 rows. K/V tiles are staged
//    in shared memory; the operand that a product reads along its output
//    columns is staged transposed, so every fragment is one 32-bit load.
//    Row strides carry 8 bf16 of padding, which makes those loads free of
//    bank conflicts.
//  * The softmax scale multiplies the fp32 scores inside the kernel and the
//    running softmax is taken in base 2 (exp2 is the hardware's native
//    exponential); the TPU kernel instead folds √(scale·log2e) into the bf16
//    operands — a divergence in rounding only (ROADMAP §C).
//  * Tiles wholly in the causal future or beyond the window are never
//    visited (the loop bounds follow _block_visibility); tiles wholly
//    visible skip the per-element mask.
//  * A row that sees nothing (segment ids, or kv_offset > q_offset) keeps
//    the running max at -1e30: O = 0 and LSE ≈ -6.9e29, as on the TPU. The
//    backward maps such rows (LSE <= -5e29) to +1e30 so their probabilities
//    and gradients are exactly 0.
//  * B4 is deterministic and uses no float atomics: the TPU kernel sums dk/dv
//    along a sequential grid dimension, but Hopper's blocks run in no order.
//    So B4 is split in two kernels. flash_bwd_dkdv_kernel owns one kv tile
//    of 64 keys and loops over the q-heads of its GQA group and, inside,
//    over the visible q tiles, summing dk/dv in registers in a fixed order.
//    flash_bwd_dq_kernel owns one q tile and loops over the visible kv
//    tiles. Each recomputes P and dP, so B4 does 7 products per tile pair
//    where the TPU's fused sweep does 5: the price of determinism without a
//    cross-block reduction (the other way, fp32 dq partials per kv tile
//    summed afterwards, costs B·H·Tq·D·4 bytes per kv tile — 8.6 GB at
//    the LM's shape with 64-key tiles).
//  * di = rowsum(dO·O) − g_lse is elementwise work done by the caller.
//
// Head dims 16, 32, 64 and 128 are instantiated (every head dim the repo's
// models use); others are refused. Plain C interface for ctypes: every entry
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// refuses); the Python wrapper raises on a non-zero result. Kernels run on
// the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;  // bf16 elements of padding at the end of smem rows
constexpr float kNegInf = -1e30f;
constexpr float kPosBig = 1e30f;
constexpr float kDeadLse = -5e29f;  // an LSE at or below this: a dead row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Forward and dq kernels: q rows per block; kv rows per forward tile.
constexpr int kBq = 64;
constexpr int kBkFwd = 64;
// dq kernel: kv rows per tile. dk/dv kernel: kv rows per block, q rows per
// tile. Smaller inner tiles keep the backward's accumulators in registers.
constexpr int kBkDq = 32;
constexpr int kBkv = 64;
constexpr int kBqIn = 32;

enum DType { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

struct Shape {
  int b, tq, tk, h, hkv, group;  // group = h / hkv
  int causal, window;            // window <= 0: none
  int q_off, kv_off;
  float scale;                   // softmax scale, natural units
};

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* qseg;   // (B, Tq) or null
  const int* kvseg;  // (B, Tk) or null
  void* out;         // (B, Tq, H, D)
  float* lse;        // (B, H, Tq)
  Shape s;
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;   // (B, Tq, H, D)
  const float* lse;   // (B, H, Tq)
  const float* di;    // (B, H, Tq): rowsum(dO·O) - g_lse
  const int* qseg;
  const int* kvseg;
  void* dq;           // (B, Tq, H, D)
  void* dk;           // (B, Tk, Hkv, D)
  void* dv;
  Shape s;
};

// -- small helpers -------------------------------------------------------------

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int ceildiv(int a, int b) { return -floordiv(-a, b); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a·b on one m16n8k16 tile: a 16×16 (row-major), b 16×8, fp32 d.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16×16 block at (row0, col0) of a row-major smem matrix.
// Lane (g = lane/4, t = lane%4) holds rows g and g+8, columns 2t, 2t+1 and
// 2t+8, 2t+9.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* x, int ld,
                                       int row0, int col0, int lane) {
  const bf16* p = x + (row0 + (lane >> 2)) * ld + col0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment of the 16×8 block (k0.., n0..) of a matrix stored n-major in
// smem (element (k, n) at y[n·ld + k]): lane holds column g, rows 2t, 2t+1
// and 2t+8, 2t+9.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* y,
                                       int ld, int n0, int k0, int lane) {
  const bf16* p = y + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// Stage `rows` rows of D bf16 (global row stride rs elements) into smem,
// row-major (stride ld) and/or transposed (dst_t[c·ldt + r]); rows at or
// beyond `valid` are zero. 16-byte loads.
template <int D>
__device__ __forceinline__ void stage(bf16* dst, int ld, bf16* dst_t, int ldt,
                                      const bf16* src, long long rs, int rows,
                                      int valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + (long long)r * rs + c);
    if (dst) *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    if (dst_t) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * ldt + r] = e[j];
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Is key position kpos (local index kloc) visible from query qpos?
__device__ __forceinline__ bool visible(const Shape& s, int qpos, int kpos,
                                        int kloc, int qseg, int kvseg,
                                        bool segs) {
  return kloc < s.tk && (!s.causal || qpos >= kpos) &&
         (s.window <= 0 || kpos > qpos - s.window) && (!segs || qseg == kvseg);
}

// True when every (q, k) pair of the tile pair is visible and unpadded
// (_block_visibility's "interior").
__device__ __forceinline__ bool interior(const Shape& s, int q_first,
                                         int q_last, int k_first, int k_last,
                                         int kend_local, bool segs) {
  return !segs && kend_local <= s.tk && (!s.causal || q_first >= k_last) &&
         (s.window <= 0 || k_first >= q_last - (s.window - 1));
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

// Write a warp's 16×D fp32 accumulator (scaled) to rows row0.. of a
// (.., T, heads, D) tensor; rows at or beyond `t` are dropped.
template <int D, typename OutT>
__device__ __forceinline__ void store_rows(OutT* base, long long rs, int row0,
                                           int t, const float (&acc)[D / 8][4],
                                           float mul_lo, float mul_hi,
                                           int lane) {
  const int r_lo = row0 + (lane >> 2), r_hi = r_lo + 8;
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r_lo < t)
      store2<OutT>(base + r_lo * rs + j * 8 + c, acc[j][0] * mul_lo,
                   acc[j][1] * mul_lo);
    if (r_hi < t)
      store2<OutT>(base + r_hi * rs + j * 8 + c, acc[j][2] * mul_hi,
                   acc[j][3] * mul_hi);
  }
}

// -- B3: forward -----------------------------------------------------------------

template <int D>
constexpr int fwd_smem() {
  return ((kBq + kBkFwd) * (D + kPad) + D * (kBkFwd + kPad)) * 2 + kBkFwd * 4;
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  constexpr int BK = kBkFwd, LD = D + kPad, LDT = BK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBq * LD;
  bf16* vt = ks + BK * LD;
  int* kvseg_s = reinterpret_cast<int*>(vt + D * LDT);

  const Shape& s = a.s;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.group;
  const int q0 = blockIdx.x * kBq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const bool segs = a.qseg != nullptr;
  const long long qrs = (long long)s.h * D, krs = (long long)s.hkv * D;

  stage<D>(qs, LD, nullptr, 0,
           a.q + ((long long)b * s.tq + q0) * qrs + (long long)h * D, qrs, kBq,
           min(kBq, s.tq - q0));
  const int r_lo = q0 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const int qpos_lo = s.q_off + r_lo, qpos_hi = s.q_off + r_hi;
  int qseg_lo = -1, qseg_hi = -1;
  if (segs) {
    if (r_lo < s.tq) qseg_lo = a.qseg[(long long)b * s.tq + r_lo];
    if (r_hi < s.tq) qseg_hi = a.qseg[(long long)b * s.tq + r_hi];
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs, LD, warp * 16, kk * 16, lane);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  const float c2 = s.scale * kLog2e;

  const int q_first = s.q_off + q0, q_last = q_first + kBq - 1;
  const int nk = (s.tk + BK - 1) / BK;
  int j_begin = 0, j_end = nk;
  if (s.causal) j_end = min(nk, max(0, floordiv(q_last - s.kv_off, BK) + 1));
  if (s.window > 0)
    j_begin = max(0, ceildiv(q_first - s.window + 1 - s.kv_off - (BK - 1), BK));

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK, kvalid = min(BK, s.tk - k0);
    __syncthreads();  // the previous tile's readers are done
    const long long koff = ((long long)b * s.tk + k0) * krs + (long long)hk * D;
    stage<D>(ks, LD, nullptr, 0, a.k + koff, krs, BK, kvalid);
    stage<D>(nullptr, 0, vt, LDT, a.v + koff, krs, BK, kvalid);
    if (segs)
      for (int i = threadIdx.x; i < BK; i += kThreads)
        kvseg_s[i] = i < kvalid ? a.kvseg[(long long)b * s.tk + k0 + i] : -2;
    __syncthreads();

    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, ks, LD, n * 8, kk * 16, lane);
        mma(sc[n], qf[kk], b0, b1);
      }

    const int k_first = s.kv_off + k0, k_last = k_first + BK - 1;
    uint32_t vis = 0xffffffffu;  // bit n*4+e: element (n, e) visible
    if (!interior(s, q_first, q_last, k_first, k_last, k0 + BK, segs)) {
      vis = 0u;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t4 + (e & 1);
          const bool hi = e >= 2;
          const bool ok = visible(s, hi ? qpos_hi : qpos_lo, k_first + col,
                                  k0 + col, hi ? qseg_hi : qseg_lo,
                                  segs ? kvseg_s[col] : 0, segs);
          vis |= (uint32_t)ok << (n * 4 + e);
        }
    }
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (vis >> (n * 4 + e)) & 1u ? sc[n][e] * c2 : kNegInf;
        sc[n][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const float pe = (vis >> (n * 4 + e)) & 1u
                             ? exp2f(sc[n][e] - (hi ? mn_hi : mn_lo))
                             : 0.f;
        sc[n][e] = pe;
        if (hi) sum_hi += pe;
        else sum_lo += pe;
      }
    // Per-thread partial row sums: alpha is the same across the quad, so
    // the quad's partials are summed once at the end.
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      o[jd][0] *= al_lo;
      o[jd][1] *= al_lo;
      o[jd][2] *= al_hi;
      o[jd][3] *= al_hi;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        uint32_t b0, b1;
        load_b(b0, b1, vt, LDT, jd * 8, kk * 16, lane);
        mma(o[jd], pa, b0, b1);
      }
    }
  }

  l_lo = fmaxf(quad_sum(l_lo), 1e-20f);
  l_hi = fmaxf(quad_sum(l_hi), 1e-20f);
  OutT* obase = static_cast<OutT*>(a.out) + ((long long)b * s.tq) * qrs +
                (long long)h * D;
  store_rows<D, OutT>(obase, qrs, q0 + warp * 16, s.tq, o, 1.f / l_lo,
                      1.f / l_hi, lane);
  if (t4 == 0) {
    float* lrow = a.lse + ((long long)b * s.h + h) * s.tq;
    if (r_lo < s.tq) lrow[r_lo] = (m_lo + log2f(l_lo)) * kLn2;
    if (r_hi < s.tq) lrow[r_hi] = (m_hi + log2f(l_hi)) * kLn2;
  }
}

// -- B4: backward, dk/dv ------------------------------------------------------------

template <int D>
constexpr int dkdv_smem() {
  return (2 * kBkv * (D + kPad) + 2 * kBqIn * (D + kPad) +
          2 * D * (kBqIn + kPad)) * 2 + 3 * kBqIn * 4;
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int BQ = kBqIn, LD = D + kPad, LDT = BQ + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kBkv * LD;
  bf16* qs = vs + kBkv * LD;
  bf16* dos = qs + BQ * LD;
  bf16* qt = dos + BQ * LD;
  bf16* dot = qt + D * LDT;
  float* lse_s = reinterpret_cast<float*>(dot + D * LDT);
  float* di_s = lse_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(di_s + BQ);

  const Shape& s = a.s;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const bool segs = a.qseg != nullptr;
  const long long qrs = (long long)s.h * D, krs = (long long)s.hkv * D;
  const long long koff = ((long long)b * s.tk + k0) * krs + (long long)hk * D;
  const int kvalid = min(kBkv, s.tk - k0);

  stage<D>(ks, LD, nullptr, 0, a.k + koff, krs, kBkv, kvalid);
  stage<D>(vs, LD, nullptr, 0, a.v + koff, krs, kBkv, kvalid);
  const int kr_lo = k0 + warp * 16 + (lane >> 2), kr_hi = kr_lo + 8;
  const int kpos_lo = s.kv_off + kr_lo, kpos_hi = s.kv_off + kr_hi;
  int kvseg_lo = -2, kvseg_hi = -2;
  if (segs) {
    if (kr_lo < s.tk) kvseg_lo = a.kvseg[(long long)b * s.tk + kr_lo];
    if (kr_hi < s.tk) kvseg_hi = a.kvseg[(long long)b * s.tk + kr_hi];
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const float c2 = s.scale * kLog2e;

  const int k_first = s.kv_off + k0, k_last = k_first + kBkv - 1;
  const int nq = (s.tq + BQ - 1) / BQ;
  int i_begin = 0, i_end = nq;
  if (s.causal) i_begin = max(0, ceildiv(k_first - s.q_off - (BQ - 1), BQ));
  if (s.window > 0)
    i_end = min(nq, max(0, floordiv(k_last + s.window - 1 - s.q_off, BQ) + 1));

  for (int hh = 0; hh < s.group; ++hh) {
    const int h = hk * s.group + hh;
    const float* lrow = a.lse + ((long long)b * s.h + h) * s.tq;
    const float* drow = a.di + ((long long)b * s.h + h) * s.tq;
    for (int i = i_begin; i < i_end; ++i) {
      const int q0 = i * BQ, qvalid = min(BQ, s.tq - q0);
      __syncthreads();
      const long long qoff = ((long long)b * s.tq + q0) * qrs + (long long)h * D;
      stage<D>(qs, LD, qt, LDT, a.q + qoff, qrs, BQ, qvalid);
      stage<D>(dos, LD, dot, LDT, a.dout + qoff, qrs, BQ, qvalid);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        float l2 = kPosBig, d = 0.f;
        if (r < qvalid) {
          const float l = lrow[q0 + r];
          l2 = l <= kDeadLse ? kPosBig : l * kLog2e;
          d = drow[q0 + r];
        }
        lse_s[r] = l2;
        di_s[r] = d;
        if (segs) qseg_s[r] = r < qvalid ? a.qseg[(long long)b * s.tq + q0 + r] : -1;
      }
      __syncthreads();

      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, ks, LD, warp * 16, kk * 16, lane);
        load_a(va, vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, qs, LD, n * 8, kk * 16, lane);
          mma(st[n], ka, b0, b1);
          load_b(b0, b1, dos, LD, n * 8, kk * 16, lane);
          mma(dpt[n], va, b0, b1);
        }
      }
      const int q_first = s.q_off + q0, q_last = q_first + BQ - 1;
      const bool inner = interior(s, q_first, q_last, k_first, k_last,
                                  k0 + kBkv, segs);
      // Element (n, e): key row lo (e < 2) or hi, query column
      // n*8 + 2t + (e & 1).
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t4 + (e & 1);
          const bool hi = e >= 2;
          bool ok = true;
          if (!inner)
            ok = visible(s, s.q_off + q0 + col, hi ? kpos_hi : kpos_lo,
                         hi ? kr_hi : kr_lo, segs ? qseg_s[col] : 0,
                         hi ? kvseg_hi : kvseg_lo, segs);
          const float pe = ok ? exp2f(st[n][e] * c2 - lse_s[col]) : 0.f;
          st[n][e] = pe;
          dpt[n][e] = pe * (dpt[n][e] - di_s[col]);
        }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        da[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        da[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        da[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        da[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          uint32_t b0, b1;
          load_b(b0, b1, dot, LDT, jd * 8, kk * 16, lane);  // dV += Pᵀ·dO
          mma(dv[jd], pa, b0, b1);
          load_b(b0, b1, qt, LDT, jd * 8, kk * 16, lane);   // dK += dSᵀ·Q
          mma(dk[jd], da, b0, b1);
        }
      }
    }
  }

  OutT* dkb = static_cast<OutT*>(a.dk) + ((long long)b * s.tk) * krs +
              (long long)hk * D;
  OutT* dvb = static_cast<OutT*>(a.dv) + ((long long)b * s.tk) * krs +
              (long long)hk * D;
  store_rows<D, OutT>(dkb, krs, k0 + warp * 16, s.tk, dk, s.scale, s.scale,
                      lane);
  store_rows<D, OutT>(dvb, krs, k0 + warp * 16, s.tk, dv, 1.f, 1.f, lane);
}

// -- B4: backward, dq -----------------------------------------------------------------

template <int D>
constexpr int dq_smem() {
  return (2 * kBq * (D + kPad) + 2 * kBkDq * (D + kPad) +
          D * (kBkDq + kPad)) * 2 + kBkDq * 4;
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int BK = kBkDq, LD = D + kPad, LDT = BK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kBq * LD;
  bf16* ks = dos + kBq * LD;
  bf16* vs = ks + BK * LD;
  bf16* kt = vs + BK * LD;
  int* kvseg_s = reinterpret_cast<int*>(kt + D * LDT);

  const Shape& s = a.s;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.group;
  const int q0 = blockIdx.x * kBq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const bool segs = a.qseg != nullptr;
  const long long qrs = (long long)s.h * D, krs = (long long)s.hkv * D;
  const long long qoff = ((long long)b * s.tq + q0) * qrs + (long long)h * D;
  const int qvalid = min(kBq, s.tq - q0);

  stage<D>(qs, LD, nullptr, 0, a.q + qoff, qrs, kBq, qvalid);
  stage<D>(dos, LD, nullptr, 0, a.dout + qoff, qrs, kBq, qvalid);
  const int r_lo = q0 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const int qpos_lo = s.q_off + r_lo, qpos_hi = s.q_off + r_hi;
  const float* lrow = a.lse + ((long long)b * s.h + h) * s.tq;
  const float* drow = a.di + ((long long)b * s.h + h) * s.tq;
  float l2_lo = kPosBig, l2_hi = kPosBig, di_lo = 0.f, di_hi = 0.f;
  int qseg_lo = -1, qseg_hi = -1;
  if (r_lo < s.tq) {
    const float l = lrow[r_lo];
    l2_lo = l <= kDeadLse ? kPosBig : l * kLog2e;
    di_lo = drow[r_lo];
    if (segs) qseg_lo = a.qseg[(long long)b * s.tq + r_lo];
  }
  if (r_hi < s.tq) {
    const float l = lrow[r_hi];
    l2_hi = l <= kDeadLse ? kPosBig : l * kLog2e;
    di_hi = drow[r_hi];
    if (segs) qseg_hi = a.qseg[(long long)b * s.tq + r_hi];
  }

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  const float c2 = s.scale * kLog2e;

  const int q_first = s.q_off + q0, q_last = q_first + kBq - 1;
  const int nk = (s.tk + BK - 1) / BK;
  int j_begin = 0, j_end = nk;
  if (s.causal) j_end = min(nk, max(0, floordiv(q_last - s.kv_off, BK) + 1));
  if (s.window > 0)
    j_begin = max(0, ceildiv(q_first - s.window + 1 - s.kv_off - (BK - 1), BK));

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK, kvalid = min(BK, s.tk - k0);
    __syncthreads();
    const long long koff = ((long long)b * s.tk + k0) * krs + (long long)hk * D;
    stage<D>(ks, LD, kt, LDT, a.k + koff, krs, BK, kvalid);
    stage<D>(vs, LD, nullptr, 0, a.v + koff, krs, BK, kvalid);
    if (segs)
      for (int i = threadIdx.x; i < BK; i += kThreads)
        kvseg_s[i] = i < kvalid ? a.kvseg[(long long)b * s.tk + k0 + i] : -2;
    __syncthreads();

    float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, qs, LD, warp * 16, kk * 16, lane);
      load_a(da, dos, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, ks, LD, n * 8, kk * 16, lane);
        mma(sc[n], qa, b0, b1);
        load_b(b0, b1, vs, LD, n * 8, kk * 16, lane);
        mma(dp[n], da, b0, b1);
      }
    }
    const int k_first = s.kv_off + k0, k_last = k_first + BK - 1;
    const bool inner = interior(s, q_first, q_last, k_first, k_last, k0 + BK,
                                segs);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        const bool hi = e >= 2;
        bool ok = true;
        if (!inner)
          ok = visible(s, hi ? qpos_hi : qpos_lo, k_first + col, k0 + col,
                       hi ? qseg_hi : qseg_lo, segs ? kvseg_s[col] : 0, segs);
        const float pe =
            ok ? exp2f(sc[n][e] * c2 - (hi ? l2_hi : l2_lo)) : 0.f;
        sc[n][e] = pe * (dp[n][e] - (hi ? di_hi : di_lo));  // dS
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      da[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      da[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      da[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        uint32_t b0, b1;
        load_b(b0, b1, kt, LDT, jd * 8, kk * 16, lane);  // dQ += dS·K
        mma(dq[jd], da, b0, b1);
      }
    }
  }

  OutT* dqb = static_cast<OutT*>(a.dq) + ((long long)b * s.tq) * qrs +
              (long long)h * D;
  store_rows<D, OutT>(dqb, qrs, q0 + warp * 16, s.tq, dq, s.scale, s.scale,
                      lane);
}

// -- launch ---------------------------------------------------------------------------

template <int D, typename OutT>
int fwd_launch(const FwdArgs& a, cudaStream_t st) {
  const dim3 grid((a.s.tq + kBq - 1) / kBq, a.s.h, a.s.b);
  const int bytes = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<D, OutT><<<grid, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int bwd_launch(const BwdArgs& a, cudaStream_t st) {
  const dim3 grid_kv((a.s.tk + kBkv - 1) / kBkv, a.s.hkv, a.s.b);
  const int kv_bytes = dkdv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D, OutT><<<grid_kv, kThreads, kv_bytes, st>>>(a);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 grid_q((a.s.tq + kBq - 1) / kBq, a.s.h, a.s.b);
  const int q_bytes = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, OutT><<<grid_q, kThreads, q_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

bool valid_shape(const Shape& s, int d) {
  return s.b > 0 && s.tq > 0 && s.tk > 0 && s.h > 0 && s.hkv > 0 &&
         s.h % s.hkv == 0 && s.group == s.h / s.hkv &&
         (d == 16 || d == 32 || d == 64 || d == 128) && s.b <= 65535 &&
         s.h <= 65535;
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

}  // namespace

extern "C" {

// B3. out_dtype: 0 fp32, 1 bf16. window <= 0: no window. qseg/kvseg: both
// null or both (B, Tq)/(B, Tk) int32.
int hvd_flash_fwd(const void* q, const void* k, const void* v,
                  const void* qseg, const void* kvseg, void* out, void* lse,
                  int b, int tq, int tk, int h, int hkv, int d, int causal,
                  int window, int q_off, int kv_off, float scale,
                  int out_dtype, void* stream) {
  FwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.qseg = static_cast<const int*>(qseg);
  a.kvseg = static_cast<const int*>(kvseg);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.s = make_shape(b, tq, tk, h, hkv, causal, window, q_off, kv_off, scale);
  if (!valid_shape(a.s, d) || (qseg == nullptr) != (kvseg == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_FWD(D)                                                     \
  case D:                                                              \
    return out_dtype == kBF16 ? fwd_launch<D, bf16>(a, st)             \
           : out_dtype == kF32 ? fwd_launch<D, float>(a, st)           \
                               : (int)cudaErrorInvalidValue;
  switch (d) {
    HVD_FWD(16)
    HVD_FWD(32)
    HVD_FWD(64)
    HVD_FWD(128)
  }
#undef HVD_FWD
  return (int)cudaErrorInvalidValue;
}

// B4: dq (B, Tq, H, D), dk/dv (B, Tk, Hkv, D), all in out_dtype. di:
// (B, H, Tq) fp32, rowsum(dO·O) - g_lse.
int hvd_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di,
                  const void* qseg, const void* kvseg, void* dq, void* dk,
                  void* dv, int b, int tq, int tk, int h, int hkv, int d,
                  int causal, int window, int q_off, int kv_off, float scale,
                  int out_dtype, void* stream) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.qseg = static_cast<const int*>(qseg);
  a.kvseg = static_cast<const int*>(kvseg);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.s = make_shape(b, tq, tk, h, hkv, causal, window, q_off, kv_off, scale);
  if (!valid_shape(a.s, d) || (qseg == nullptr) != (kvseg == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_BWD(D)                                                     \
  case D:                                                              \
    return out_dtype == kBF16 ? bwd_launch<D, bf16>(a, st)             \
           : out_dtype == kF32 ? bwd_launch<D, float>(a, st)           \
                               : (int)cudaErrorInvalidValue;
  switch (d) {
    HVD_BWD(16)
    HVD_BWD(32)
    HVD_BWD(64)
    HVD_BWD(128)
  }
#undef HVD_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
