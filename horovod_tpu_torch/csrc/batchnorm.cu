// BatchNorm channel sums for Hopper (sm_90a): kernels B1 and B2.
//
// Replaces the TPU's Pallas kernels in horovod_tpu/ops/batchnorm.py:
//   B1 channel_sums_kernel      <- _sums_kernel       (Σx and Σx² per channel)
//   B2 channel_grad_sums_kernel <- _grad_sums_kernel  (Σdy and Σdy·x̂ per channel,
//                                                      x̂ = (x - mean)·rstd)
// Both read a channels-last (N, C) matrix, bf16 or fp32, row-major with C
// contiguous, and produce two (C,) fp32 vectors.
//
// Bound. Each is a column reduction that does ~2-4 flops per element it
// reads, far below the card's ~295 flops/byte balance point, so device
// memory bounds it: B1 reads N·C·2 bytes (bf16), B2 reads 2·N·C·2 bytes. At
// 3.35 TB/s (H100 SXM data sheet) and ResNet-50's 53 BatchNorm layers at
// batch 128 (≈1.42e9 elements a step), that is ≈0.85 ms a step for B1 and
// ≈1.7 ms for B2 — data-sheet bounds, not measurements.
//
// Design against that bound.
//  * Threads run along C, the contiguous dim, each loading 16 bytes at a time
//    (8 bf16 or 4 fp32 channels); a warp covers up to 512 contiguous bytes of
//    a row. Rows are strided over threadIdx.y. Squares and x̂ are formed in
//    fp32 after the load (the TPU kernel squared in the input dtype; this
//    matches the JAX CPU path instead, see ROADMAP §C).
//  * The TPU kernel walks a sequential grid and carries its accumulator in
//    VMEM from step to step. Hopper's blocks run in parallel in no order, so
//    the rows are cut into slabs, one block column each, with enough blocks
//    (~4 per SM over 132 SMs) to keep the memory system busy. Each block
//    reduces its slab in shared memory in a fixed order and writes fp32
//    partials to a (slabs, 2, C) scratch buffer; a second small pass sums the
//    slabs in a fixed order. No atomics: the result is bit-reproducible.
//  * The ragged edge of N is masked by the row loop's bound; nothing is
//    padded or copied.
//
// Plain C interface for ctypes. Every entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it refuses); the Python wrapper raises
// on a non-zero result. Kernels run on the caller's stream and allocate
// nothing: the wrapper passes the scratch buffer and the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads per block of the main pass
constexpr int kMaxTx = 32;        // channel vectors per block
constexpr int kTargetBlocks = 528;  // ~4 blocks on each of 132 SMs
constexpr int kMinRowIters = 4;   // rows each thread walks, at least
constexpr int kFinalTx = 32;      // finalize: channels per block
constexpr int kFinalTy = 8;       // finalize: slab stripes per block

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    out[0] = __ldg(p);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    out[0] = __bfloat162float(*p);
  }
};

struct Plan {
  int tx;      // channel vectors per block (blockDim.x)
  int ty;      // row lanes per block (blockDim.y)
  int ctiles;  // blocks along C (gridDim.y)
};

Plan make_plan(int c, int vec) {
  Plan p;
  const int cvec = (c + vec - 1) / vec;
  p.tx = cvec < kMaxTx ? cvec : kMaxTx;
  p.ty = kThreads / p.tx;
  p.ctiles = (cvec + p.tx - 1) / p.tx;
  return p;
}

// Sum the block's per-row-lane accumulators over threadIdx.y in a fixed
// order and write this slab's partials: partial[(slab*2 + k)*c + ch].
template <int VEC>
__device__ __forceinline__ void block_reduce_store(const float* a1,
                                                   const float* a2,
                                                   float* __restrict__ partial,
                                                   int c) {
  __shared__ float smem[2 * kThreads * 8];
  const int tx = blockDim.x, ty = blockDim.y;
  const int w = tx * VEC;  // channels this block covers
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    smem[(0 * ty + threadIdx.y) * w + threadIdx.x * VEC + i] = a1[i];
    smem[(1 * ty + threadIdx.y) * w + threadIdx.x * VEC + i] = a2[i];
  }
  __syncthreads();
  const int tid = threadIdx.y * tx + threadIdx.x;
  const int c_base = blockIdx.y * w;
  for (int item = tid; item < 2 * w; item += tx * ty) {
    const int k = item / w, j = item - k * w;
    float s = 0.f;
    for (int y = 0; y < ty; ++y) s += smem[(k * ty + y) * w + j];
    if (c_base + j < c)
      partial[((long long)blockIdx.x * 2 + k) * c + c_base + j] = s;
  }
}

// B1: Σx and Σx² of one slab of rows, for one tile of channels.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
channel_sums_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    long long n, int c, long long rows_per_slab) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const long long r0 = (long long)blockIdx.x * rows_per_slab;
  const long long r1 = min(n, r0 + rows_per_slab);
  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;
  if (c0 < c) {
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      float v[VEC];
      Loader<T, VEC>::load(x + r * c + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a1[i] += v[i];
        a2[i] = fmaf(v[i], v[i], a2[i]);
      }
    }
  }
  block_reduce_store<VEC>(a1, a2, partial, c);
}

// B2: Σdy and Σdy·(x - mean)·rstd of one slab of rows, x̂ formed in fp32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
channel_grad_sums_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         float* __restrict__ partial, long long n, int c,
                         long long rows_per_slab) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const long long r0 = (long long)blockIdx.x * rows_per_slab;
  const long long r1 = min(n, r0 + rows_per_slab);
  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;
  if (c0 < c) {
    float m[VEC], rs[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      m[i] = mean[c0 + i];
      rs[i] = rstd[c0 + i];
    }
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      float g[VEC], v[VEC];
      Loader<T, VEC>::load(dy + r * c + c0, g);
      Loader<T, VEC>::load(x + r * c + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a1[i] += g[i];
        a2[i] = fmaf(g[i], (v[i] - m[i]) * rs[i], a2[i]);
      }
    }
  }
  block_reduce_store<VEC>(a1, a2, partial, c);
}

// Second pass: out_k[ch] = Σ_slab partial[slab][k][ch], in a fixed order
// (each row lane sums a fixed stripe of slabs, then the lanes are summed in
// lane order).
__global__ void __launch_bounds__(kFinalTx * kFinalTy)
finalize_kernel(const float* __restrict__ partial, float* __restrict__ out1,
                float* __restrict__ out2, int slabs, int c) {
  __shared__ float smem[kFinalTy][kFinalTx];
  const int item = blockIdx.x * kFinalTx + threadIdx.x;  // over 2*c
  float s = 0.f;
  if (item < 2 * c) {
    const int k = item / c, ch = item - k * c;
    for (int sl = threadIdx.y; sl < slabs; sl += kFinalTy)
      s += partial[((long long)sl * 2 + k) * c + ch];
  }
  smem[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && item < 2 * c) {
    float t = 0.f;
    for (int y = 0; y < kFinalTy; ++y) t += smem[y][threadIdx.x];
    const int k = item / c, ch = item - k * c;
    (k == 0 ? out1 : out2)[ch] = t;
  }
}

bool valid_vec(int dtype, int vec, int c) {
  if (vec == 1) return true;
  if (dtype == kBF16) return vec == 8 && c % 8 == 0;
  return vec == 4 && c % 4 == 0;
}

int finalize(const float* partial, float* out1, float* out2, int slabs, int c,
             cudaStream_t stream) {
  const dim3 block(kFinalTx, kFinalTy);
  const dim3 grid((2 * c + kFinalTx - 1) / kFinalTx);
  finalize_kernel<<<grid, block, 0, stream>>>(partial, out1, out2, slabs, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of row slabs (blocks along N) the two kernels use for an (n, c)
// input read `vec` channels at a time; the caller sizes the (slabs, 2, c)
// fp32 scratch buffer from it.
int hvd_bn_slabs(long long n, int c, int vec) {
  if (c <= 0 || vec <= 0) return 1;
  const Plan p = make_plan(c, vec);
  long long slabs = (kTargetBlocks + p.ctiles - 1) / p.ctiles;
  const long long most = n / ((long long)kMinRowIters * p.ty);
  if (slabs > most) slabs = most;
  if (slabs < 1) slabs = 1;
  return (int)slabs;
}

int hvd_channel_sums(const void* x, void* partial, void* s1, void* s2,
                     long long n, int c, int dtype, int vec, int slabs,
                     void* stream) {
  if (c <= 0 || n < 0 || slabs < 1 || !valid_vec(dtype, vec, c))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(c, vec);
  const dim3 block(p.tx, p.ty);
  const dim3 grid(slabs, p.ctiles);
  const long long rows = (n + slabs - 1) / slabs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == kBF16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    if (vec == 8)
      channel_sums_kernel<__nv_bfloat16, 8><<<grid, block, 0, st>>>(
          xp, part, n, c, rows);
    else
      channel_sums_kernel<__nv_bfloat16, 1><<<grid, block, 0, st>>>(
          xp, part, n, c, rows);
  } else if (dtype == kF32) {
    const float* xp = static_cast<const float*>(x);
    if (vec == 4)
      channel_sums_kernel<float, 4><<<grid, block, 0, st>>>(xp, part, n, c,
                                                            rows);
    else
      channel_sums_kernel<float, 1><<<grid, block, 0, st>>>(xp, part, n, c,
                                                            rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return finalize(part, static_cast<float*>(s1), static_cast<float*>(s2),
                  slabs, c, st);
}

int hvd_channel_grad_sums(const void* dy, const void* x, const void* mean,
                          const void* rstd, void* partial, void* sdy,
                          void* sdx, long long n, int c, int dtype, int vec,
                          int slabs, void* stream) {
  if (c <= 0 || n < 0 || slabs < 1 || !valid_vec(dtype, vec, c))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(c, vec);
  const dim3 block(p.tx, p.ty);
  const dim3 grid(slabs, p.ctiles);
  const long long rows = (n + slabs - 1) / slabs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const float* m = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  if (dtype == kBF16) {
    const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(dy);
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    if (vec == 8)
      channel_grad_sums_kernel<__nv_bfloat16, 8><<<grid, block, 0, st>>>(
          gp, xp, m, rs, part, n, c, rows);
    else
      channel_grad_sums_kernel<__nv_bfloat16, 1><<<grid, block, 0, st>>>(
          gp, xp, m, rs, part, n, c, rows);
  } else if (dtype == kF32) {
    const float* gp = static_cast<const float*>(dy);
    const float* xp = static_cast<const float*>(x);
    if (vec == 4)
      channel_grad_sums_kernel<float, 4><<<grid, block, 0, st>>>(
          gp, xp, m, rs, part, n, c, rows);
    else
      channel_grad_sums_kernel<float, 1><<<grid, block, 0, st>>>(
          gp, xp, m, rs, part, n, c, rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return finalize(part, static_cast<float*>(sdy), static_cast<float*>(sdx),
                  slabs, c, st);
}

}  // extern "C"
