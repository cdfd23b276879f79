// Flash attention for Hopper (sm_90a): kernel B4, the backward.
//
// Replaces the TPU's Pallas kernel horovod_tpu/ops/flash_attention.py
// _bwd_fused_kernel (its pallas_call at :675): dq, dk, dv from the saved
// LSE (FlashAttention-2 gradients), with di = rowsum(dO·O) − g_lse computed
// by the caller. dq (B, Tq, H, D), dk/dv (B, Tk, Hkv, D) in the caller's
// dtype (bf16 or fp32).
//
// Bound. At the LM's shape (B=2, T=8192, H=8, D=128, causal) the 5-product
// minimum is ≈ 687 GFLOP against ≈ 200 MB moved: tensor-core bound,
// ≈ 0.69 ms at 989 TFLOP/s dense bf16 (H100 SXM data sheet).
//
// Determinism without float atomics. The TPU kernel sums dk/dv along a
// sequential grid dimension, but Hopper's blocks run in no order, so B4 is
// two kernels that each sum one gradient inside one block in a fixed order:
//  * flash_bwd_dkdv_kernel: one block per 128 keys (two consumer warpgroups
//    of 64 keys). K and V are loaded once by TMA and stay in shared memory;
//    one producer warp streams 64-row Q and dO tiles, with their LSE, di
//    and q segment ids, through a ring of stages: for each q head of the
//    GQA group, over the visible q tiles. Per tile: Sᵀ = K·Qᵀ and
//    dPᵀ = V·dOᵀ (wgmma, both operands in shared memory, K-major), then
//    Pᵀ = exp2(Sᵀ·c − lse₂), dSᵀ = Pᵀ∘(dPᵀ − di) in registers, then
//    dV += Pᵀ·dO and dK += dSᵀ·Q with A from registers and dO/Q read as
//    MN-major operands. dK and dV stay in registers.
//  * flash_bwd_dq_kernel: one block per 128 q rows. Q, dO, LSE and di are
//    loaded once; K/V tiles of 64 keys stream through the ring. S = Q·Kᵀ,
//    dP = dO·Vᵀ, dS, then dQ += dS·K with K as an MN-major operand.
// Each recomputes P and dP, so B4 does 7 products per tile pair where the
// TPU's fused sweep does 5: the price of determinism without a cross-block
// reduction (ROADMAP §C). Rows whose LSE marks them dead (<= -5e29) map to
// lse₂ = +1e30, so their probabilities and gradients are exactly 0; so do
// rows past Tq (TMA reads them as zeros).
//
// Scheduling: under a causal mask the first key tiles are seen by the most
// queries (dk/dv kernel: block y takes key tile y) and the last q tiles see
// the most keys (dq kernel: block y takes q tile nq-1-y): heaviest first.
//
// Shared memory, D = 128: dk/dv kernel K + V 64 KB + 3 stages × (Q + dO,
// 2 × 16 KB) = 160 KB; dq kernel Q + dO 64 KB + 3 stages × (K + V,
// 2 × 16 KB) = 160 KB (+ rows' LSE/di/segment ids and barriers).
//
// Plain C interface for ctypes: hvd_flash_bwd returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments or tensor maps it refuses); the
// kernels run on the caller's stream and allocate nothing.

#include "flash_common.cuh"

namespace {

struct BwdArgs {
  const float* lse;  // (B, H, Tq)
  const float* di;   // (B, H, Tq): rowsum(dO·O) - g_lse
  const int* qseg;   // (B, Tq) or null
  const int* kvseg;  // (B, Tk) or null
  void* dq;          // (B, Tq, H, D)
  void* dk;          // (B, Tk, Hkv, D)
  void* dv;
  Shape s;
};

// The backward's base-2 LSE of a row: +1e30 for a dead row, so exp2 of any
// score minus it is exactly 0.
__device__ __forceinline__ float lse2_of(float l) {
  return l <= kDeadLse ? kPosBig : l * kLog2e;
}

// -- dk/dv ---------------------------------------------------------------------------

template <int D>
struct DkdvCfg {
  static constexpr int kBk = 128;  // keys per block: 2 warpgroups × 64
  static constexpr int kBq = 64;   // q rows per streamed tile
  static constexpr int kStages = 3;
  typedef Tile<D, kBk> KTile;
  typedef Tile<D, kBq> QTile;
  static constexpr int kStageBytes = 2 * QTile::kBytes;  // Q then dO
  static constexpr int kTileBytes = 2 * KTile::kBytes + kStages * kStageBytes;
  static constexpr int kRowBytes = 3 * kStages * kBq * 4;  // lse₂, di, qseg
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem = 1024 + kTileBytes + kRowBytes + kBarBytes;
  static_assert(kSmem <= kMaxSmem, "over a block's shared memory");
};

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          BwdArgs a) {
  typedef DkdvCfg<D> C;
  constexpr int BK = C::kBk, BQ = C::kBq, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = ks + C::KTile::kBytes;
  unsigned char* ring = vs + C::KTile::kBytes;
  float* lse_s = reinterpret_cast<float*>(smem + C::kTileBytes);  // [S][BQ]
  float* di_s = lse_s + S * BQ;
  int* qseg_s = reinterpret_cast<int*>(di_s + S * BQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(qseg_s + S * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const Shape& s = a.s;
  const int hk = blockIdx.x % s.hkv, b = blockIdx.x / s.hkv;
  const int k0 = blockIdx.y * BK;  // heaviest first under a causal mask
  const bool segs = a.qseg != nullptr;
  const int k_first = s.kv_off + k0, k_last = k_first + BK - 1;
  int i_begin, i_end;
  q_tile_range(s, k_first, k_last, BQ, i_begin, i_end);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
      mbar_arrive_tx(kv_full, 2 * C::KTile::kBytes);
      C::KTile::load(ks, &tm_k, kv_full, hk, k0, b);
      C::KTile::load(vs, &tm_v, kv_full, hk, k0, b);
    }
    int it = 0;
    for (int hh = 0; hh < s.group; ++hh) {
      const int h = hk * s.group + hh;
      const long long row = ((long long)b * s.h + h) * s.tq;
      for (int i = i_begin; i < i_end; ++i, ++it) {
        const int st = it % S;
        mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
        const int q0 = i * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < s.tq;
          lse_s[st * BQ + r] = in ? lse2_of(a.lse[row + q0 + r]) : kPosBig;
          di_s[st * BQ + r] = in ? a.di[row + q0 + r] : 0.f;
          if (segs)
            qseg_s[st * BQ + r] =
                in ? a.qseg[(long long)b * s.tq + q0 + r] : -1;
        }
        if (lane == 0) {
          unsigned char* qt = ring + st * C::kStageBytes;
          mbar_arrive_tx(&full[st], C::kStageBytes);
          C::QTile::load(qt, &tm_q, &full[st], h, q0, b);
          C::QTile::load(qt + C::QTile::kBytes, &tm_do, &full[st], h, q0, b);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    set_max_regs_inc<kConsumerRegs>();
    const int wg = warp >> 2, w4 = warp & 3, t4 = lane & 3;
    const int kr_lo = k0 + 64 * wg + 16 * w4 + (lane >> 2), kr_hi = kr_lo + 8;
    const int kpos_lo = s.kv_off + kr_lo, kpos_hi = s.kv_off + kr_hi;
    int kvseg_lo = -2, kvseg_hi = -2;
    if (segs) {
      if (kr_lo < s.tk) kvseg_lo = a.kvseg[(long long)b * s.tk + kr_lo];
      if (kr_hi < s.tk) kvseg_hi = a.kvseg[(long long)b * s.tk + kr_hi];
    }
    const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
    const uint32_t ring_addr = smem_u32(ring);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const float c2 = s.scale * kLog2e;

    mbar_wait(kv_full, 0);
    int it = 0;
    for (int hh = 0; hh < s.group; ++hh) {
      for (int i = i_begin; i < i_end; ++i, ++it) {
        const int st = it % S;
        const uint32_t q_addr = ring_addr + st * C::kStageBytes;
        const uint32_t do_addr = q_addr + C::QTile::kBytes;
        mbar_wait(&full[st], (it / S) & 1);

        // Four products in four commit groups, each waited for only when
        // its result is needed: Pᵀ is computed while dPᵀ runs, dSᵀ while
        // dV's product runs.
        float sct[BQ / 2], dpt[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BQ, 0>::ss(sct, C::KTile::kmajor(k_addr, 64 * wg, kk),
                           C::QTile::kmajor(q_addr, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BQ, 0>::ss(dpt, C::KTile::kmajor(v_addr, 64 * wg, kk),
                           C::QTile::kmajor(do_addr, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sct);

        // Element e: key row lo (e%4 < 2) or hi, q column 8(e/4) + 2·t4 + e%2.
        const int q0 = i * BQ, q_first = s.q_off + q0;
        const bool inner = interior(s, q_first, q_first + BQ - 1, k_first,
                                    k_last, k0 + BK, segs);
        const float* lrow = lse_s + st * BQ;
        const float* drow = di_s + st * BQ;
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int col = 8 * (e / 4) + 2 * t4 + (e & 1);
          const bool hi = (e & 2) != 0;
          const bool ok =
              inner || visible(s, q_first + col, hi ? kpos_hi : kpos_lo,
                               hi ? kr_hi : kr_lo,
                               segs ? qseg_s[st * BQ + col] : 0,
                               hi ? kvseg_hi : kvseg_lo, segs);
          sct[e] = ok ? fast_exp2(sct[e] * c2 - lrow[col]) : 0.f;
        }
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) a_frag(pa[kk], sct, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)  // dV += Pᵀ·dO
          Wgmma<D, 1>::rs(dv, pa[kk], C::QTile::mnmajor(do_addr, kk), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dpt);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int col = 8 * (e / 4) + 2 * t4 + (e & 1);
          dpt[e] = sct[e] * (dpt[e] - drow[col]);
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) a_frag(da[kk], dpt, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)  // dK += dSᵀ·Q
          Wgmma<D, 1>::rs(dk, da[kk], C::QTile::mnmajor(q_addr, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        keep_frags(pa);
        keep_frags(da);
        mbar_arrive(&empty[st]);
      }
    }

    const long long krs = (long long)s.hkv * D;
    const long long base = ((long long)b * s.tk) * krs + (long long)hk * D;
    const int row0 = k0 + 64 * wg + 16 * w4;
    store_rows<D, OutT>(static_cast<OutT*>(a.dk) + base, krs, row0, s.tk, dk,
                        s.scale, s.scale, lane);
    store_rows<D, OutT>(static_cast<OutT*>(a.dv) + base, krs, row0, s.tk, dv,
                        1.f, 1.f, lane);
  }
}

// -- dq ------------------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int kBq = 128;  // q rows per block: 2 warpgroups × 64
  static constexpr int kBk = 64;   // keys per streamed tile
  static constexpr int kStages = 3;
  typedef Tile<D, kBq> QTile;
  typedef Tile<D, kBk> KTile;
  static constexpr int kStageBytes = 2 * KTile::kBytes;  // K then V
  static constexpr int kTileBytes = 2 * QTile::kBytes + kStages * kStageBytes;
  static constexpr int kSegBytes = kStages * kBk * 4;
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem = 1024 + kTileBytes + kSegBytes + kBarBytes;
  static_assert(kSmem <= kMaxSmem, "over a block's shared memory");
};

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, BwdArgs a) {
  typedef DqCfg<D> C;
  constexpr int BQ = C::kBq, BK = C::kBk, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = qs + C::QTile::kBytes;
  unsigned char* ring = dos + C::QTile::kBytes;
  int* kvseg_s = reinterpret_cast<int*>(smem + C::kTileBytes);  // [S][BK]
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
      mbar_arrive_tx(q_full, 2 * C::QTile::kBytes);
      C::QTile::load(qs, &tm_q, q_full, h, q0, b);
      C::QTile::load(dos, &tm_do, q_full, h, q0, b);
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
        C::KTile::load(kt, &tm_k, &full[st], hk, k0, b);
        C::KTile::load(kt + C::KTile::kBytes, &tm_v, &full[st], hk, k0, b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    set_max_regs_inc<kConsumerRegs>();
    const int wg = warp >> 2, w4 = warp & 3, t4 = lane & 3;
    const int r_lo = q0 + 64 * wg + 16 * w4 + (lane >> 2), r_hi = r_lo + 8;
    const int qpos_lo = s.q_off + r_lo, qpos_hi = s.q_off + r_hi;
    const long long row = ((long long)b * s.h + h) * s.tq;
    float l2_lo = kPosBig, l2_hi = kPosBig, di_lo = 0.f, di_hi = 0.f;
    int qseg_lo = -1, qseg_hi = -1;
    if (r_lo < s.tq) {
      l2_lo = lse2_of(a.lse[row + r_lo]);
      di_lo = a.di[row + r_lo];
      if (segs) qseg_lo = a.qseg[(long long)b * s.tq + r_lo];
    }
    if (r_hi < s.tq) {
      l2_hi = lse2_of(a.lse[row + r_hi]);
      di_hi = a.di[row + r_hi];
      if (segs) qseg_hi = a.qseg[(long long)b * s.tq + r_hi];
    }
    const uint32_t q_addr = smem_u32(qs), do_addr = smem_u32(dos);
    const uint32_t ring_addr = smem_u32(ring);

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const float c2 = s.scale * kLog2e;

    // dQ's product of a tile stays in flight until the next tile's S and
    // dP are issued; its stage is released (and its dS registers reused)
    // only after it completes.
    uint32_t da[BK / 16][4];
    int prev = -1;  // the stage whose dQ product is in flight
    mbar_wait(q_full, 0);
    for (int j = j_begin, it = 0; j < j_end; ++j, ++it) {
      const int st = it % S;
      const uint32_t k_addr = ring_addr + st * C::kStageBytes;
      const uint32_t v_addr = k_addr + C::KTile::kBytes;
      mbar_wait(&full[st], (it / S) & 1);

      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, 0>::ss(sc, C::QTile::kmajor(q_addr, 64 * wg, kk),
                         C::KTile::kmajor(k_addr, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, 0>::ss(dp, C::QTile::kmajor(do_addr, 64 * wg, kk),
                         C::KTile::kmajor(v_addr, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<2>();  // the previous tile's dQ product
      if (prev >= 0) {
        keep_frags(da);
        mbar_arrive(&empty[prev]);
      }
      wgmma_wait<1>();
      fence_regs(sc);

      // Element e: row lo (e%4 < 2) or hi, key column 8(e/4) + 2·t4 + e%2.
      const int k0 = j * BK, k_first = s.kv_off + k0;
      const bool inner = interior(s, q_first, q_last, k_first,
                                  k_first + BK - 1, k0 + BK, segs);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int col = 8 * (e / 4) + 2 * t4 + (e & 1);
        const bool hi = (e & 2) != 0;
        const bool ok =
            inner || visible(s, hi ? qpos_hi : qpos_lo, k_first + col,
                             k0 + col, hi ? qseg_hi : qseg_lo,
                             segs ? kvseg_s[st * BK + col] : 0, segs);
        sc[e] = ok ? fast_exp2(sc[e] * c2 - (hi ? l2_hi : l2_lo)) : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        sc[e] *= dp[e] - ((e & 2) ? di_hi : di_lo);  // dS
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) a_frag(da[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // dQ += dS·K
        Wgmma<D, 1>::rs(dq, da[kk], C::KTile::mnmajor(k_addr, kk), 1);
      wgmma_commit();
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(dq);
    if (prev >= 0) {
      keep_frags(da);
      mbar_arrive(&empty[prev]);
    }

    const long long qrs = (long long)s.h * D;
    store_rows<D, OutT>(static_cast<OutT*>(a.dq) + ((long long)b * s.tq) * qrs +
                            (long long)h * D,
                        qrs, q0 + 64 * wg + 16 * w4, s.tq, dq, s.scale,
                        s.scale, lane);
  }
}

// -- launch --------------------------------------------------------------------------

template <int D, typename OutT>
int bwd_launch(const void* q, const void* k, const void* v, const void* dout,
               const BwdArgs& a, cudaStream_t st) {
  typedef DkdvCfg<D> KV;
  typedef DqCfg<D> Q;
  const Shape& s = a.s;
  const int nk = (s.tk + KV::kBk - 1) / KV::kBk;
  const int nq = (s.tq + Q::kBq - 1) / Q::kBq;
  if (nk > 65535 || nq > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_bthd<D>(&tq, q, s.b, s.tq, s.h, KV::kBq) ||
      !encode_bthd<D>(&tdo, dout, s.b, s.tq, s.h, KV::kBq) ||
      !encode_bthd<D>(&tk, k, s.b, s.tk, s.hkv, KV::kBk) ||
      !encode_bthd<D>(&tv, v, s.b, s.tk, s.hkv, KV::kBk))
    return (int)cudaErrorInvalidValue;
  int err = launch(flash_bwd_dkdv_kernel<D, OutT>, dim3(s.hkv * s.b, nk),
                   KV::kSmem, st, tq, tk, tv, tdo, a);
  if (err != 0) return err;
  if (!encode_bthd<D>(&tq, q, s.b, s.tq, s.h, Q::kBq) ||
      !encode_bthd<D>(&tdo, dout, s.b, s.tq, s.h, Q::kBq) ||
      !encode_bthd<D>(&tk, k, s.b, s.tk, s.hkv, Q::kBk) ||
      !encode_bthd<D>(&tv, v, s.b, s.tk, s.hkv, Q::kBk))
    return (int)cudaErrorInvalidValue;
  return launch(flash_bwd_dq_kernel<D, OutT>, dim3(s.h * s.b, nq), Q::kSmem,
                st, tq, tk, tv, tdo, a);
}

}  // namespace

extern "C" {

// B4: dq (B, Tq, H, D), dk/dv (B, Tk, Hkv, D), all in out_dtype. di:
// (B, H, Tq) fp32, rowsum(dO·O) - g_lse.
int hvd_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di,
                  const void* qseg, const void* kvseg, void* dq, void* dk,
                  void* dv, int b, int tq, int tk, int h, int hkv, int d,
                  int causal, int window, int q_off, int kv_off, float scale,
                  int out_dtype, void* stream) {
  BwdArgs a;
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
#define HVD_BWD(D)                                                          \
  case D:                                                                   \
    return out_dtype == kBF16 ? bwd_launch<D, bf16>(q, k, v, dout, a, st)   \
           : out_dtype == kF32 ? bwd_launch<D, float>(q, k, v, dout, a, st) \
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
