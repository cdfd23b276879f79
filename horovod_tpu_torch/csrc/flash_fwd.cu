// Flash attention for Hopper (sm_90a): kernel B3, the forward.
//
// Replaces the TPU's Pallas kernel horovod_tpu/ops/flash_attention.py
// _fwd_kernel (its pallas_call at :390): O and the per-row LSE of
// online-softmax attention, never materializing the (Tq, Tk) scores. O is
// written in bf16 or fp32 (the caller's dtype), the LSE as fp32 (B, H, Tq)
// in natural-log units.
//
// Bound. At the LM's shape (B=2, T=8192, H=8, D=128, causal) one forward
// does 2 products of 2·B·H·T²·D/2 flops ≈ 275 GFLOP against ≈ 100 MB of
// q/k/v/O: ≈ 2700 flops per byte, far above the card's ≈ 295 balance point,
// so the tensor cores bound it (≈ 0.28 ms at 989 TFLOP/s dense bf16, H100
// SXM data sheet). Only wgmma reaches that rate, and only if the tiles it
// reads are in shared memory before it asks for them.
//
// Design (machinery in flash_common.cuh):
//  * One block per (128 q rows, head, batch): two consumer warpgroups of 64
//    rows each and a producer warpgroup, one warp of which issues every
//    load (flash_common.cuh). The producer loads Q once and streams
//    K/V tiles of 128 keys through a ring of kStages shared-memory stages by
//    TMA, each stage guarded by a "full" mbarrier (TMA bytes landed) and an
//    "empty" one (both consumer warpgroups done with it); its lanes also
//    copy the tile's kv segment ids beside it. setmaxnreg moves registers
//    from the producer to the consumers.
//  * S = Q·Kᵀ is a wgmma with both operands in shared memory, both K-major
//    (D is contiguous in Q and K). The online softmax runs on the fp32
//    accumulator in registers, in base 2, with the scale on the fp32 scores
//    (the TPU kernel folds √(scale·log2e) into the bf16 operands: a
//    difference in rounding only, ROADMAP §C).
//  * O += P·V takes P from registers (the accumulator layout is wgmma's
//    register-A layout, rounded to bf16) and V from shared memory as an
//    MN-major operand (transpose bit), so nothing is ever staged transposed.
//  * Tiles wholly in the causal future or beyond the window are never
//    loaded (loop bounds); interior tiles skip the per-element mask.
//  * Heaviest first: under a causal mask the last q tiles see the most
//    keys, so block y takes q tile nq-1-y and those start first.
//  * A row that sees nothing (segment ids, or kv_offset > q_offset) keeps
//    the running max at -1e30: O = 0 and LSE ≈ -6.9e29, as on the TPU.
//
// Shared memory, D = 128: Q 32 KB + 2 stages × (K + V, 2 × 32 KB) = 160 KB
// (+ segment ids and barriers) of the 227 KB a block may use; D <= 64 keeps
// 3 stages (D = 64: 16 + 3 × 32 = 112 KB).
//
// Plain C interface for ctypes: hvd_flash_fwd returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments or tensor maps it refuses);
// the Python wrapper raises on a non-zero result. The
// kernel runs on the caller's stream and allocates nothing.

#include "flash_common.cuh"

namespace {

struct FwdArgs {
  const int* qseg;   // (B, Tq) or null
  const int* kvseg;  // (B, Tk) or null
  void* out;         // (B, Tq, H, D)
  float* lse;        // (B, H, Tq)
  Shape s;
};

template <int D>
struct FwdCfg {
  static constexpr int kBq = 128;  // q rows per block: 2 warpgroups × 64
  static constexpr int kBk = 128;  // keys per tile
  static constexpr int kStages = D == 128 ? 2 : 3;
  typedef Tile<D, kBq> QTile;
  typedef Tile<D, kBk> KVTile;
  static constexpr int kStageBytes = 2 * KVTile::kBytes;  // K then V
  static constexpr int kTileBytes = QTile::kBytes + kStages * kStageBytes;
  static constexpr int kSegBytes = kStages * kBk * 4;
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem = 1024 + kTileBytes + kSegBytes + kBarBytes;
  static_assert(kSmem <= kMaxSmem, "over a block's shared memory");
};

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, FwdArgs a) {
  typedef FwdCfg<D> C;
  constexpr int BQ = C::kBq, BK = C::kBk, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ring = smem + C::QTile::kBytes;
  int* kvseg_s = reinterpret_cast<int*>(smem + C::kTileBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kTileBytes +
                                                 C::kSegBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const Shape& s = a.s;
  const int h = blockIdx.x % s.h, b = blockIdx.x / s.h, hk = h / s.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const bool segs = a.qseg != nullptr;
  const int q_first = s.q_off + q0, q_last = q_first + BQ - 1;
  int j_begin, j_end;
  kv_tile_range(s, q_first, q_last, BK, j_begin, j_end);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= kProducerWarp) {
    set_max_regs_dec<kProducerRegs>();
    if (warp != kProducerWarp) return;
    if (lane == 0) {
      mbar_arrive_tx(q_full, C::QTile::kBytes);
      C::QTile::load(qs, &tm_q, q_full, h, q0, b);
    }
    for (int j = j_begin, it = 0; j < j_end; ++j, ++it) {
      const int st = it % S;
      mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
      const int k0 = j * BK;
      if (segs)
        for (int i = lane; i < BK; i += 32)
          kvseg_s[st * BK + i] =
              k0 + i < s.tk ? a.kvseg[(long long)b * s.tk + k0 + i] : -2;
      if (lane == 0) {
        unsigned char* kt = ring + st * C::kStageBytes;
        mbar_arrive_tx(&full[st], C::kStageBytes);
        C::KVTile::load(kt, &tm_k, &full[st], hk, k0, b);
        C::KVTile::load(kt + C::KVTile::kBytes, &tm_v, &full[st], hk, k0, b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    set_max_regs_inc<kConsumerRegs>();
    const int wg = warp >> 2, w4 = warp & 3, t4 = lane & 3;
    const int r_lo = q0 + 64 * wg + 16 * w4 + (lane >> 2), r_hi = r_lo + 8;
    const int qpos_lo = s.q_off + r_lo, qpos_hi = s.q_off + r_hi;
    int qseg_lo = -1, qseg_hi = -1;
    if (segs) {
      if (r_lo < s.tq) qseg_lo = a.qseg[(long long)b * s.tq + r_lo];
      if (r_hi < s.tq) qseg_hi = a.qseg[(long long)b * s.tq + r_hi];
    }
    const uint32_t q_addr = smem_u32(qs);
    const uint32_t ring_addr = smem_u32(ring);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
    const float c2 = s.scale * kLog2e;

    mbar_wait(q_full, 0);
    for (int j = j_begin, it = 0; j < j_end; ++j, ++it) {
      const int st = it % S;
      const uint32_t k_addr = ring_addr + st * C::kStageBytes;
      const uint32_t v_addr = k_addr + C::KVTile::kBytes;
      mbar_wait(&full[st], (it / S) & 1);

      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, 0>::ss(sc, C::QTile::kmajor(q_addr, 64 * wg, kk),
                         C::KVTile::kmajor(k_addr, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Element i of the accumulator: row lo (i%4 < 2) or hi, key column
      // 8(i/4) + 2·t4 + i%2. Masked scores are -inf: p = 0 even in a row
      // whose max is still -1e30.
      const int k0 = j * BK, k_first = s.kv_off + k0;
      if (interior(s, q_first, q_last, k_first, k_first + BK - 1, k0 + BK,
                   segs)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= c2;
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
          const bool hi = (i & 2) != 0;
          const bool ok = visible(s, hi ? qpos_hi : qpos_lo, k_first + col,
                                  k0 + col, hi ? qseg_hi : qseg_lo,
                                  segs ? kvseg_s[st * BK + col] : 0, segs);
          sc[i] = ok ? sc[i] * c2 : -INFINITY;
        }
      }
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (i & 2) mx_hi = fmaxf(mx_hi, sc[i]);
        else mx_lo = fmaxf(mx_lo, sc[i]);
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float al_lo = fast_exp2(m_lo - mn_lo);
      const float al_hi = fast_exp2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const bool hi = (i & 2) != 0;
        const float p = fast_exp2(sc[i] - (hi ? mn_hi : mn_lo));
        sc[i] = p;
        if (hi) sum_hi += p;
        else sum_lo += p;
      }
      // Per-thread partial row sums: alpha is the same across the quad, so
      // the quad's partials are summed once at the end.
      l_lo = l_lo * al_lo + sum_lo;
      l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? al_hi : al_lo;

      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) a_frag(pa[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<D, 1>::rs(o, pa[kk], C::KVTile::mnmajor(v_addr, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      keep_frags(pa);
      mbar_arrive(&empty[st]);
    }

    l_lo = fmaxf(quad_sum(l_lo), 1e-20f);
    l_hi = fmaxf(quad_sum(l_hi), 1e-20f);
    const long long qrs = (long long)s.h * D;
    OutT* obase = static_cast<OutT*>(a.out) + ((long long)b * s.tq) * qrs +
                  (long long)h * D;
    store_rows<D, OutT>(obase, qrs, q0 + 64 * wg + 16 * w4, s.tq, o,
                        1.f / l_lo, 1.f / l_hi, lane);
    if (t4 == 0) {
      float* lrow = a.lse + ((long long)b * s.h + h) * s.tq;
      if (r_lo < s.tq) lrow[r_lo] = (m_lo + log2f(l_lo)) * kLn2;
      if (r_hi < s.tq) lrow[r_hi] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

template <int D, typename OutT>
int fwd_launch(const void* q, const void* k, const void* v, const FwdArgs& a,
               cudaStream_t st) {
  typedef FwdCfg<D> C;
  const Shape& s = a.s;
  CUtensorMap tq, tk, tv;
  if (!encode_bthd<D>(&tq, q, s.b, s.tq, s.h, C::kBq) ||
      !encode_bthd<D>(&tk, k, s.b, s.tk, s.hkv, C::kBk) ||
      !encode_bthd<D>(&tv, v, s.b, s.tk, s.hkv, C::kBk))
    return (int)cudaErrorInvalidValue;
  const int nq = (s.tq + C::kBq - 1) / C::kBq;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  return launch(flash_fwd_kernel<D, OutT>, dim3(s.h * s.b, nq), C::kSmem, st,
                tq, tk, tv, a);
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
    return out_dtype == kBF16 ? fwd_launch<D, bf16>(q, k, v, a, st)    \
           : out_dtype == kF32 ? fwd_launch<D, float>(q, k, v, a, st)  \
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

}  // extern "C"
