// BatchNorm channel sums for Hopper (sm_90a): kernel B1, one launch a call.
//
// Replaces the TPU's Pallas kernel horovod_tpu/ops/batchnorm.py::_sums_kernel
// (Σx and Σx² per channel). Reads a channels-last (N, C) matrix, bf16 or
// fp32, row-major with C contiguous, and writes two (C,) fp32 vectors.
// Squares are formed in fp32 after the load (the TPU kernel squared in the
// input dtype; this matches the JAX CPU path, see ROADMAP §C).
//
// Bound. A column reduction of ~3 flops per element read, far below the
// card's ~295 flops/byte balance point: device memory bounds it, N·C·2 bytes
// in bf16 at 3.35 TB/s (H100 SXM data sheet), ≈0.85 ms for ResNet-50's 53
// BatchNorm layers at batch 128. 28 of those 53 calls read 25.7 MB or less
// (bounds of 1.9-7.7 µs), so a fixed cost per call weighs as much as the
// rate of the large ones.
//
// Design against that bound.
//  * One launch. A block owns a contiguous range of rows of one channel
//    tile (below) and reduces it to one fp32 partial row (Σx and Σx² of the
//    tile's channels) in device memory. The grid is persistent and
//    launched cooperatively, so all its blocks are resident at once: they
//    meet at a grid barrier (one 64-bit word of the caller's stream: an
//    integer arrival count and a generation, both moved by the last block
//    to arrive), and then block b adds slice b of the channels over
//    every partial row and writes it out, 32 lanes of a warp a channel
//    sum (fewer when there are fewer rows): each lane adds every 32nd row
//    in row order, a butterfly of shuffles adds the lanes. The combine
//    runs on the whole grid, one round of reads deep. No float atomics: every
//    sum has a fixed order and the result is the same bits from run to run.
//  * A bulk-copy ring. The producer warp streams the block's rows with 1-D
//    bulk copies (cp.async.bulk) into a ring of 4 stages of 16 KB behind
//    full and empty mbarriers, so 64 KB a block are in flight whatever the
//    thread count. 256 consumer threads reduce each stage from shared
//    memory with 16-byte loads; each owns a fixed set of channel vectors (8
//    bf16 or 4 fp32 channels): at C = 64 bf16 one of 8 vectors of 32 rows
//    a pass.
//  * Channel tiles. Every block writes a partial row of its channels, so
//    wide rows would make the partials a large share of the traffic (264
//    blocks × 16 KB at C = 2048 bf16, 17% of a 25.7 MB input). The rows are
//    cut into tiles of at most 512 bytes along the grid's y, as many blocks
//    along x as the card keeps for each tile: the partials stay within
//    264 × 2 × 256 floats. A tile narrower than the row is copied a row at
//    a time, the producer warp's lanes issuing one copy each.
//  * A grid sized to the shape: at most as many blocks as the card keeps
//    resident (two an SM), fewer for a small input (at least 32 KB a
//    block), row ranges balanced to within one row.
//  * Every input in the same launch. A bulk copy needs a 16-byte aligned
//    address and a size that is a multiple of 16: rows and tiles of
//    C·size bytes from an aligned base meet both exactly when C is a
//    multiple of 8 (bf16) or 4 (fp32). Otherwise (odd C, an unaligned
//    base) the same kernel reads the rows with ordinary loads, in tiles of
//    at most 1024 channels.
//
// The launch plan (grid, channel tile, rows a stage) is made by the Python
// wrapper (horovod_tpu_torch/ops/batchnorm.py::sums_plan), which also sizes
// the scratch: [Σx (C) | Σx² (C) | partial rows (gx, 2, C)] fp32, one
// buffer. The barrier words (one uint64 per channel tile) belong to the
// caller's stream and are zero-count between calls. Plain C interface for
// ctypes; every entry returns cudaGetLastError() or cudaErrorInvalidValue
// for a plan it refuses.

#include <algorithm>

#include "flash_common.cuh"  // smem_u32, mbarrier helpers (10 s watchdog)

namespace {

constexpr int kSumThreads = 256;     // consumer threads a block
constexpr int kSumBlock = kSumThreads + 32;  // + one producer warp
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxVecs = 4;          // channel vectors a consumer owns, at most
constexpr int kBatch = 16;           // partial rows in flight a combine lane
constexpr int kMaxDevices = 64;
// dtype codes: DType (kF32, kBF16) of flash_common.cuh.

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out);

template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float* out) {
  out[0] = *p;
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* out) {
  out[0] = __bfloat162float(*p);
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this block's shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Grid barrier of `blocks` resident blocks, called by one thread of each,
// on one 64-bit word: its low half counts this barrier's arrivals, its
// high half is the generation, `g` as read at the kernel's start. The last
// arrival moves the word to the next generation with a count of zero, so
// the word is ready for the next launch; a block waits until it reads
// every arrival counted or the generation moved. Every write a block made
// before the barrier is visible to every block after it. A wait that
// outlasts 10 s traps, as mbar_wait does.
__device__ __forceinline__ void grid_barrier(unsigned long long* bar,
                                             unsigned int blocks,
                                             unsigned int g) {
  __threadfence();  // the block's writes come before its arrival
  if ((unsigned int)atomicAdd(bar, 1ull) == blocks - 1) {
    atomicAdd(bar, (1ull << 32) - blocks);
  } else {
    const volatile unsigned long long* word = bar;
    const uint64_t t0 = global_ns();
    for (;;) {
      const unsigned long long v = *word;
      if ((unsigned int)(v >> 32) != g || (unsigned int)v == blocks) break;
      if (global_ns() - t0 > 10000000000ull) __trap();
    }
  }
  __threadfence();
}

// B1. Block (bx, by) sums rows [bx·n/gx, (bx+1)·n/gx) of channel tile by
// (channels [by·ct, by·ct + w), w = min(ct, c − by·ct)). `out` holds Σx,
// Σx², then one (2, c) partial row per block along x; `bar` holds one
// 8-byte aligned uint64 barrier word per tile (gridDim.y), its count zero
// on entry and left zero.
// BULK: the tile's rows stream through the shared-memory ring,
// rows_per_stage of them a stage; otherwise they are read with ordinary
// loads.
template <typename T, int VEC, bool BULK>
__global__ void __launch_bounds__(kSumBlock, 2) channel_sums_ring_kernel(
    const T* __restrict__ x, float* __restrict__ out,
    unsigned long long* __restrict__ bar, long long n, int c, int ct,
    int rows_per_stage) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const int tid = threadIdx.x;
  const int gx = gridDim.x;
  unsigned long long* tile_bar = bar + blockIdx.y;
  const unsigned int gen =
      tid == 0
          ? (unsigned int)(*(volatile unsigned long long*)tile_bar >> 32)
          : 0u;

  const long long r0 = (long long)blockIdx.x * n / gridDim.x;
  const long long r1 = (long long)(blockIdx.x + 1) * n / gridDim.x;
  const int c0 = blockIdx.y * ct;
  const int w = min(ct, c - c0);          // channels of this tile
  const int tv = (w + VEC - 1) / VEC;     // channel vectors of a row
  // Consumer tid owns vector v0 (+ k·256 for k < kv) of rows lane, lane +
  // rp, ...: rp rows a pass when a row has at most 256 vectors.
  const int rp = tv <= kSumThreads ? kSumThreads / tv : 1;
  const int kv = tv <= kSumThreads ? 1 : (tv + kSumThreads - 1) / kSumThreads;
  const int lane = tv <= kSumThreads ? tid / tv : 0;
  const int v0 = tv <= kSumThreads ? tid % tv : tid;
  const bool active = tid < kSumThreads && lane < rp;

  float a1[kMaxVecs][VEC], a2[kMaxVecs][VEC];
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) a1[k][i] = a2[k][i] = 0.f;

  auto add_row = [&](const T* row) {  // row: channel c0 of one row
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      const int v = v0 + k * kSumThreads;
      if (k < kv && v < tv) {
        float f[VEC];
        load_vec<T, VEC>(row + v * VEC, f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          a1[k][i] += f[i];
          a2[k][i] = fmaf(f[i], f[i], a2[k][i]);
        }
      }
    }
  };

  if (BULK) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kSumThreads / 32);
      }
      mbar_init_fence();
    }
    __syncthreads();
    const long long rows = r1 - r0;
    const int stages = (int)((rows + rows_per_stage - 1) / rows_per_stage);
    if (tid >= kSumThreads) {  // the producer warp
      // A stage holds nr rows of the tile, w channels each: one copy when
      // the tile is the whole row (the rows are contiguous), else one copy
      // a row, spread over the warp's lanes.
      const int pl = tid - kSumThreads;
      const uint32_t seg = (uint32_t)(w * sizeof(T));
      for (int i = 0; i < stages; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        const long long rr = r0 + (long long)i * rows_per_stage;
        const int nr = (int)min((long long)rows_per_stage, r1 - rr);
        unsigned char* dst = ring + s * kStageBytes;
        const T* src = x + rr * c + c0;
        if (pl == 0) mbar_arrive_tx(&full[s], nr * seg);
        __syncwarp();
        if (w == c) {
          if (pl == 0) bulk_load(dst, src, nr * seg, &full[s]);
        } else {
          for (int r = pl; r < nr; r += 32)
            bulk_load(dst + r * seg, src + (long long)r * c, seg, &full[s]);
        }
      }
    } else {
      for (int i = 0; i < stages; ++i) {
        const int s = i % kStages;
        mbar_wait(&full[s], (i / kStages) & 1);
        const long long rr = r0 + (long long)i * rows_per_stage;
        const int nr = (int)min((long long)rows_per_stage, r1 - rr);
        const T* stage = reinterpret_cast<const T*>(ring + s * kStageBytes);
        if (active) {
#pragma unroll 4
          for (int r = lane; r < nr; r += rp) add_row(stage + r * w);
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(&empty[s]);
      }
    }
  } else if (active) {
    const T* base = x + c0;
#pragma unroll 4
    for (long long r = r0 + lane; r < r1; r += rp) add_row(base + r * c);
  }
  __syncthreads();  // every stage consumed: the ring is free
#ifdef HVD_B1_CUT  // tools/bench_bn_sums.py --cuts: where the time goes
  if (HVD_B1_CUT == 1) return;
#endif

  // Item j of the tile's 2w (Σx of channel c0 + j for j < w, else Σx² of
  // channel c0 + j − w) lies at at(j) of a (2, c) row.
  const int w2 = 2 * w;
  auto at = [&](int j) { return (j >= w) * (long long)(c - w) + c0 + j; };
  const long long stride = 2LL * c;  // floats between partial rows
  float* red = reinterpret_cast<float*>(ring);

  // This block's partial row, its row lanes added in lane order.
  float* prow = out + stride * (1 + blockIdx.x);
  if (rp > 1) {
    if (active) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int ch = v0 * VEC + i;
        if (ch < w) {
          red[lane * w2 + ch] = a1[0][i];
          red[lane * w2 + w + ch] = a2[0][i];
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < w2; j += kSumBlock) {
      float s = 0.f;
#pragma unroll 8
      for (int l = 0; l < rp; ++l) s += red[l * w2 + j];
      prow[at(j)] = s;
    }
  } else if (active) {  // one row lane: each channel has one owner
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      const int v = v0 + k * kSumThreads;
      if (k < kv && v < tv) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int ch = v * VEC + i;
          if (ch < w) {
            prow[at(ch)] = a1[k][i];
            prow[at(w + ch)] = a2[k][i];
          }
        }
      }
    }
  }
  __syncthreads();
#ifdef HVD_B1_CUT
  if (HVD_B1_CUT == 2) return;
#endif
  if (tid == 0) grid_barrier(tile_bar, gx, gen);
  __syncthreads();
#ifdef HVD_B1_CUT
  if (HVD_B1_CUT == 3) return;
#endif

  // Slice [j0, j0 + m) of the tile's items, each summed by a group of L
  // lanes of one warp (L = 32, or the power of two at or above gx when gx
  // is smaller): lane l adds partial rows l, l + L, ... in order, then a
  // fixed butterfly of shuffles adds the group's lanes.
  const int j0 = (int)((long long)blockIdx.x * w2 / gx);
  const int m = (int)((long long)(blockIdx.x + 1) * w2 / gx) - j0;
  const int L = gx >= 32 ? 32 : 1 << (32 - __clz(gx - 1));
  const int gl = (tid % 32) % L;       // lane within its group
  const int per_warp = 32 / L;         // items a warp sums at once
  const float* part = out + stride;
  for (int kb = tid / 32 * per_warp; kb < m;
       kb += kSumBlock / 32 * per_warp) {
    const int k = kb + (tid % 32) / L;
    float s = 0.f;
    if (k < m) {
      const float* p = part + at(j0 + k);
      for (int q0 = gl; q0 < gx; q0 += L * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = q0 + L * u;
          v[u] = q < gx ? __ldcg(p + q * stride) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (q0 + L * u < gx) s += v[u];
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
    if (gl == 0 && k < m) out[at(j0 + k)] = s;
  }
}

template <typename T, int VEC, bool BULK>
struct Instance {
  // Allow the ring's dynamic shared memory (above the 48 KB default), once
  // per device.
  static cudaError_t configure(int device) {
    static bool done[kMaxDevices];
    if (device >= 0 && device < kMaxDevices && done[device])
      return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        channel_sums_ring_kernel<T, VEC, BULK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
      done[device] = true;
    return err;
  }

  // Blocks of this instance one SM keeps resident, or minus the error.
  static int per_sm(int device) {
    cudaError_t err = configure(device);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, channel_sums_ring_kernel<T, VEC, BULK>, kSumBlock,
          kRingBytes);
    return err == cudaSuccess ? blocks : -(int)err;
  }

  static int launch(const void* x, float* out, unsigned long long* bar,
                    long long n, int c, int gx, int gy, int ct,
                    int rows_per_stage, int device, cudaStream_t st) {
    cudaError_t err = configure(device);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(gx, gy);
    cfg.blockDim = dim3(kSumBlock);
    cfg.dynamicSmemBytes = kRingBytes;
    cfg.stream = st;
    cudaLaunchAttribute attr;  // every block resident: the grid barrier
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, channel_sums_ring_kernel<T, VEC, BULK>,
                             static_cast<const T*>(x), out, bar, n, c, ct,
                             rows_per_stage);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Blocks of the widest grid that every instance of B1 keeps resident on
// `device` at once, or minus the CUDA error.
int hvd_bn_sums_max_blocks(int device) {
  int prev = 0;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  int sms = 0;
  int most = -(int)cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (most == 0) {
    most = 1 << 30;
    for (const int b : {Instance<__nv_bfloat16, 8, true>::per_sm(device),
                        Instance<__nv_bfloat16, 8, false>::per_sm(device),
                        Instance<__nv_bfloat16, 1, false>::per_sm(device),
                        Instance<float, 4, true>::per_sm(device),
                        Instance<float, 4, false>::per_sm(device),
                        Instance<float, 1, false>::per_sm(device)})
      most = std::min(most, b <= 0 ? b : b * sms);
    if (most == 0) most = -(int)cudaErrorInvalidConfiguration;
  }
  if (prev != device) cudaSetDevice(prev);
  return most;
}

// B1: Σx into out[0:c], Σx² into out[c:2c], with out[2c:] the blocks'
// partial rows; `bar` holds gy 8-byte aligned uint64 owned by this stream,
// the counts zero. The plan (gx, gy, ct, rows_per_stage) comes from the
// wrapper's sums_plan.
int hvd_channel_sums(const void* x, void* out, void* bar, long long n, int c,
                     int dtype, int vec, int gx, int gy, int ct,
                     int rows_per_stage, int device, void* stream) {
  const int size = dtype == kBF16 ? 2 : 4;
  const int full_vec = 16 / size;
  const bool bulk = rows_per_stage > 0;
  if (c <= 0 || n < 0 || (dtype != kBF16 && dtype != kF32) ||
      (vec != 1 && vec != full_vec) || (vec > 1 && c % vec) || gx < 1 ||
      gy < 1 || gy > 65535 || ct < 1 || ct > kMaxVecs * kSumThreads * vec ||
      (long long)(gy - 1) * ct >= c || (long long)gy * ct < c ||
      (n > 0 && gx > n) || reinterpret_cast<uintptr_t>(bar) % 8)
    return (int)cudaErrorInvalidValue;
  if (bulk && (vec == 1 || ct % vec ||
               (long long)rows_per_stage * ct * size > kStageBytes ||
               reinterpret_cast<uintptr_t>(x) % 16))
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  unsigned long long* b = static_cast<unsigned long long*>(bar);
  int err;
  if (dtype == kBF16) {
    if (bulk)
      err = Instance<__nv_bfloat16, 8, true>::launch(
          x, o, b, n, c, gx, gy, ct, rows_per_stage, device, st);
    else if (vec == 8)
      err = Instance<__nv_bfloat16, 8, false>::launch(
          x, o, b, n, c, gx, gy, ct, 0, device, st);
    else
      err = Instance<__nv_bfloat16, 1, false>::launch(
          x, o, b, n, c, gx, gy, ct, 0, device, st);
  } else {
    if (bulk)
      err = Instance<float, 4, true>::launch(
          x, o, b, n, c, gx, gy, ct, rows_per_stage, device, st);
    else if (vec == 4)
      err = Instance<float, 4, false>::launch(
          x, o, b, n, c, gx, gy, ct, 0, device, st);
    else
      err = Instance<float, 1, false>::launch(
          x, o, b, n, c, gx, gy, ct, 0, device, st);
  }
  if (prev != device) cudaSetDevice(prev);
  return err;
}

}  // extern "C"
