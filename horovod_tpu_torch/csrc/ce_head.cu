// The fused cross-entropy head's work on each fp32 logit tile, for Hopper
// (sm_90a): kernel A2, one launch a vocabulary chunk in each direction.
//
// The port's own kernel: the JAX package's head (horovod_tpu/ops/losses.py)
// is plain XLA, which fuses each chunk's elementwise and reduction work into
// the passes around its matmuls. Eager PyTorch runs that work as separate
// kernels, each a full pass over the chunk's (N, W) fp32 logit tile: about
// six in the forward (amax, subtract, exp, sum, gather, where) and about
// twelve in the backward (subtract the LSE, exp, the one-hot and its cast,
// p − onehot, the scale, the cast to x's dtype). These two kernels are one
// pass each:
//
//   ce_chunk_fwd_kernel  reads the tile once; per row the chunk's max and
//                        sum of exp, merged into the running (m, s) and the
//                        target's logit picked into tl, in place:
//                        m' = max(m, max_c l), s' = s·exp(m − m') + Σ exp(l − m')
//   ce_chunk_bwd_kernel  reads the recomputed tile once and writes
//                        dlogits = (exp(l − lse[r]) − [c == target[r] − start])·scale
//                        in x's dtype (fp32, bf16 or fp16), rounded once from
//                        fp32, in the plain version's order of operations.
//
// Bound. A few flops per 4-byte logit, far below the card's balance point:
// device memory bounds both. At the LM's chunk (N = 16,382 rows, W = 8,192)
// the forward reads 537 MB (0.160 ms at 3.35 TB/s, H100 SXM data sheet) and
// the backward reads 537 MB and writes 268 MB of bf16 (0.240 ms) — data-sheet
// bounds, not measurements.
//
// Design against that bound.
//  * One block of kThreads threads a row. Each thread takes VEC consecutive
//    logits at a time: 16-byte loads (two for VEC = 8) and, in the backward,
//    one store of VEC elements, with streaming cache hints (the tile is
//    touched once and does not fit the 50 MB L2). The wrapper picks VEC
//    (8, 4, 2 or 1) from the width and the operands' bases
//    (ops/losses.py::vector_width), so a ragged remainder chunk takes the
//    same kernel with narrower accesses.
//  * The forward keeps an online max and sum of exp in registers (one exp a
//    logit, one more a vector when the max moves) and merges the threads'
//    pairs across the block in a fixed order — a butterfly within each warp,
//    then the warps in index order — with no atomics, so a rerun gives the
//    same bits. One thread then folds the chunk's pair into (m, s) and picks
//    the target's logit.
//  * The backward reads the LSE and the scale (g / N, a 0-dim device tensor)
//    through pointers, never as host floats: the launch can be captured in a
//    CUDA graph and the replay reads the step's own g.
//  * expf is the accurate one (no fast-math), as the plain version's exp.
//
// Plain C interface for ctypes. Each entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it refuses); the Python wrapper raises
// on a non-zero result. The kernels run on the caller's stream and allocate
// nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum OutType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// VEC consecutive fp32 values at p (aligned to min(4·VEC, 16) bytes).
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* o) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(p) + h);
      o[4 * h] = a.x; o[4 * h + 1] = a.y; o[4 * h + 2] = a.z;
      o[4 * h + 3] = a.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = __ldcs(p);
  }
}

// VEC values to p, rounded to nearest even once from fp32.
template <typename T, int VEC>
struct Store;

template <int VEC>
struct Store<float, VEC> {
  static __device__ __forceinline__ void run(float* p, const float* x) {
    if constexpr (VEC >= 4) {
#pragma unroll
      for (int h = 0; h < VEC / 4; ++h)
        __stcs(reinterpret_cast<float4*>(p) + h,
               make_float4(x[4 * h], x[4 * h + 1], x[4 * h + 2],
                           x[4 * h + 3]));
    } else if constexpr (VEC == 2) {
      __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
    } else {
      __stcs(p, x[0]);
    }
  }
};

template <typename H2>
__device__ __forceinline__ H2 pack2(float a, float b);
template <>
__device__ __forceinline__ __nv_bfloat162 pack2(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ __half2 pack2(float a, float b) {
  return __floats2half2_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 pack1(float a, __nv_bfloat16*) {
  return __float2bfloat16_rn(a);
}
__device__ __forceinline__ __half pack1(float a, __half*) {
  return __float2half_rn(a);
}

// 16-bit outputs: VEC = 8 one 16-byte store, 4 one 8-byte, 2 one 4-byte.
template <typename T, typename H2, int VEC>
struct Store16 {
  static __device__ __forceinline__ void run(T* p, const float* x) {
    if constexpr (VEC == 1) {
      *p = pack1(x[0], p);
    } else {
      H2 h[VEC / 2];
#pragma unroll
      for (int k = 0; k < VEC / 2; ++k) h[k] = pack2<H2>(x[2 * k], x[2 * k + 1]);
      if constexpr (VEC == 8) {
        __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<uint4*>(h));
      } else if constexpr (VEC == 4) {
        __stcs(reinterpret_cast<uint2*>(p), *reinterpret_cast<uint2*>(h));
      } else {
        __stcs(reinterpret_cast<unsigned int*>(p),
               *reinterpret_cast<unsigned int*>(h));
      }
    }
  }
};

template <int VEC>
struct Store<__nv_bfloat16, VEC> : Store16<__nv_bfloat16, __nv_bfloat162, VEC> {};
template <int VEC>
struct Store<__half, VEC> : Store16<__half, __half2, VEC> {};

// (m, s) with s a sum of exp(l − m), merged with (om, os). A pair with no
// logit yet is (−inf, 0); merging two such pairs keeps it.
__device__ __forceinline__ void merge(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;
  s = s * expf(m - nm) + os * expf(om - nm);
  m = nm;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    ce_chunk_fwd_kernel(const float* __restrict__ logits, long long width,
                        const long long* __restrict__ targets, long long start,
                        float* __restrict__ m, float* __restrict__ s,
                        float* __restrict__ tl) {
  __shared__ float sm[kWarps], ss[kWarps];
  const long long r = blockIdx.x;
  const float* row = logits + r * width;
  float tm = -INFINITY, ts = 0.0f;
  for (long long c = (long long)threadIdx.x * VEC; c < width;
       c += (long long)kThreads * VEC) {
    float v[VEC];
    load_f32<VEC>(row + c, v);
    float vm = v[0];
#pragma unroll
    for (int k = 1; k < VEC; ++k) vm = fmaxf(vm, v[k]);
    const float nm = fmaxf(tm, vm);
    if (nm == -INFINITY) continue;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc += expf(v[k] - nm);
    ts = (tm == nm ? ts : ts * expf(tm - nm)) + acc;
    tm = nm;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(tm, ts, __shfl_xor_sync(0xffffffffu, tm, off),
          __shfl_xor_sync(0xffffffffu, ts, off));
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    sm[warp] = tm;
    ss[warp] = ts;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float cm = sm[0], cs = ss[0];
  for (int w = 1; w < kWarps; ++w) merge(cm, cs, sm[w], ss[w]);
  // Fold the chunk into the running pair, as the plain version does:
  // s' = s·exp(m − m') + Σ exp(l − m'), the chunk's sum moved to m'.
  const float m0 = m[r];
  const float mn = fmaxf(m0, cm);
  s[r] = s[r] * expf(m0 - mn) + (cm == -INFINITY ? 0.0f : cs * expf(cm - mn));
  m[r] = mn;
  const long long local = targets[r] - start;
  if (local >= 0 && local < width) tl[r] = row[local];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ce_chunk_bwd_kernel(const float* __restrict__ logits, long long width,
                        const long long* __restrict__ targets, long long start,
                        const float* __restrict__ lse,
                        const float* __restrict__ scale,
                        T* __restrict__ dlogits) {
  const long long r = blockIdx.x;
  const float* row = logits + r * width;
  T* out = dlogits + r * width;
  const float l0 = lse[r];
  const float g = *scale;
  const long long local = targets[r] - start;
  for (long long c = (long long)threadIdx.x * VEC; c < width;
       c += (long long)kThreads * VEC) {
    float v[VEC];
    load_f32<VEC>(row + c, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float p = expf(__fsub_rn(v[k], l0));
      v[k] = __fmul_rn(__fsub_rn(p, c + k == local ? 1.0f : 0.0f), g);
    }
    Store<T, VEC>::run(out + c, v);
  }
}

template <int VEC>
int launch_fwd(const float* logits, long long n, long long width,
               const long long* targets, long long start, float* m, float* s,
               float* tl, cudaStream_t st) {
  ce_chunk_fwd_kernel<VEC><<<(unsigned)n, kThreads, 0, st>>>(
      logits, width, targets, start, m, s, tl);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd(const float* logits, long long n, long long width,
               const long long* targets, long long start, const float* lse,
               const float* scale, void* out, cudaStream_t st) {
  ce_chunk_bwd_kernel<T, VEC><<<(unsigned)n, kThreads, 0, st>>>(
      logits, width, targets, start, lse, scale, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_by_vec(int vec, const float* logits, long long n, long long width,
               const long long* targets, long long start, const float* lse,
               const float* scale, void* out, cudaStream_t st) {
  switch (vec) {
    case 8: return launch_bwd<T, 8>(logits, n, width, targets, start, lse, scale, out, st);
    case 4: return launch_bwd<T, 4>(logits, n, width, targets, start, lse, scale, out, st);
    case 2: return launch_bwd<T, 2>(logits, n, width, targets, start, lse, scale, out, st);
    default: return launch_bwd<T, 1>(logits, n, width, targets, start, lse, scale, out, st);
  }
}

bool valid(long long n, long long width, int vec) {
  return n >= 1 && n <= 0x7fffffffLL && width >= 1 &&
         (vec == 1 || vec == 2 || vec == 4 || vec == 8) && width % vec == 0;
}

}  // namespace

extern "C" {

// The forward's fold of one chunk: logits (n, width) fp32, row-major and
// contiguous; targets (n,) int64; m, s, tl (n,) fp32, updated in place.
int hvd_ce_chunk_fwd(const void* logits, long long n, long long width,
                     const void* targets, long long start, void* m, void* s,
                     void* tl, int vec, void* stream) {
  if (!valid(n, width, vec)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(logits);
  const long long* t = static_cast<const long long*>(targets);
  float *mp = static_cast<float*>(m), *sp = static_cast<float*>(s),
        *tp = static_cast<float*>(tl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8: return launch_fwd<8>(l, n, width, t, start, mp, sp, tp, st);
    case 4: return launch_fwd<4>(l, n, width, t, start, mp, sp, tp, st);
    case 2: return launch_fwd<2>(l, n, width, t, start, mp, sp, tp, st);
    default: return launch_fwd<1>(l, n, width, t, start, mp, sp, tp, st);
  }
}

// The backward's dlogits of one chunk: logits as above; lse (n,) fp32;
// scale one fp32 on the device, read by every block at run time; out
// (n, width), contiguous, of out_type (0 fp32, 1 bf16, 2 fp16).
int hvd_ce_chunk_bwd(const void* logits, long long n, long long width,
                     const void* targets, long long start, const void* lse,
                     const void* scale, void* out, int out_type, int vec,
                     void* stream) {
  if (!valid(n, width, vec) || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(logits);
  const long long* t = static_cast<const long long*>(targets);
  const float* ls = static_cast<const float*>(lse);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_type) {
    case kF32: return bwd_by_vec<float>(vec, l, n, width, t, start, ls, sc, out, st);
    case kBF16: return bwd_by_vec<__nv_bfloat16>(vec, l, n, width, t, start, ls, sc, out, st);
    case kF16: return bwd_by_vec<__half>(vec, l, n, width, t, start, ls, sc, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
