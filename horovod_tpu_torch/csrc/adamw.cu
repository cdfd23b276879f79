// AdamW update for Hopper (sm_90a): kernel A1, one launch for every
// parameter of a param group.
//
// The port's own kernel: the JAX package's update is not a Pallas kernel but
// the elementwise code of horovod_tpu/ops/optim.py:67-95, which XLA fuses
// into one pass a leaf (the "memory-lean fused AdamW" of optim.py:1-11).
// Eager PyTorch runs that code as ~20 kernels a tensor, each writing an fp32
// temporary; this kernel is the one pass. Per element it reads the gradient
// g, the moments m and v and the parameter p, and writes p, m and v:
//
//   m' = b1·m + (1 − b1)·g          v' = b2·v + (1 − b2)·g·g
//   p' = p + (−lr)·((m'/c1) / (√(v'/c2) + eps) + wd·p)
//   c1 = 1 − b1^t, c2 = 1 − b2^t, t = the tensor's step count after this step
//
// in fp32, with m', v' stored in the moment dtype (bf16 or fp32) and p' in
// the parameter's (fp32 or bf16; a bf16 parameter adds the update rounded to
// bf16, as `p.add_(upd.to(p.dtype))` does). Every operation is written with
// an _rn intrinsic, in the plain version's order, so nvcc contracts nothing
// into an FMA: on the card the kernel computes what the plain PyTorch version
// (ops/optim.py::adamw_update_plain) computes, operation for operation.
//
// Bound. A few flops per 20 bytes (fp32 p and g, bf16 m and v: read
// 4+4+2+2, write 4+2+2), far below the card's ~295 flops/byte balance
// point: device memory bounds it. The LM's 159.4 M parameters move 3.19 GB a
// step, 0.95 ms at 3.35 TB/s (H100 SXM data sheet) — a data-sheet bound, not
// a measurement.
//
// Design against that bound.
//  * One launch a param group. The caller passes a device table of records
//    (addresses, element count, first chunk, dtype and alignment flags; built
//    once per parameter list by ops/optim.py and rebuilt when it changes).
//    Each tensor is cut into chunks of kChunk elements; a persistent grid
//    walks the chunks of all tensors, and a block finds its chunk's tensor by
//    binary search over the records' first chunks.
//  * Each thread takes 8 elements at a time: 16-byte loads and stores for
//    bf16 (one uint4) and two for fp32, with streaming cache hints (every
//    byte is touched once, and 3 GB does not fit the 50 MB L2). A tensor
//    whose four bases are not 16-byte aligned, and the ragged end of every
//    tensor, take scalar loads.
//  * The step count stays on the device: one int32 a tensor. Every block
//    reads the count before it takes a chunk and computes c1, c2 from
//    count + 1 with powf; the block that finishes the tensor's last chunk
//    (a per-tensor arrival counter, reset by that block) writes count + 1.
//    No count is written before every chunk of its tensor has read it, so
//    the host never reads or writes the count: the update can be captured
//    in a CUDA graph.
//  * The learning rate is read from a device tensor, not passed by value,
//    so a captured update follows the LR a schedule writes there.
//
// Plain C interface for ctypes. hvd_adamw returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it refuses); the Python wrapper raises
// on a non-zero result. The kernel runs on the caller's stream and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // elements a thread takes at a time
constexpr long long kChunk = 8192;   // elements a block takes at a time
constexpr int kBlocksPerSM = 8;

enum Flags { kParamBF16 = 1, kMomentBF16 = 2, kAligned = 4 };

struct Rec {  // one parameter tensor; the layout ops/optim.py writes
  long long p, g, m, v, step;  // device addresses
  long long n;                 // elements
  long long chunk0;            // its first chunk in the launch
  long long flags;
};
static_assert(sizeof(Rec) == 64, "ops/optim.py writes 8 int64 a record");

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, neg_lr;  // neg_lr: set by the kernel
};

template <bool BF16>
struct Mem;

template <>
struct Mem<false> {  // fp32
  static __device__ __forceinline__ void load8(const void* base, long long i,
                                               float* o) {
    const float4* q =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    const float4 a = __ldcs(q), b = __ldcs(q + 1);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  static __device__ __forceinline__ void store8(void* base, long long i,
                                                const float* x) {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(base) + i);
    __stcs(q, make_float4(x[0], x[1], x[2], x[3]));
    __stcs(q + 1, make_float4(x[4], x[5], x[6], x[7]));
  }
  static __device__ __forceinline__ float load1(const void* base,
                                                long long i) {
    return static_cast<const float*>(base)[i];
  }
  static __device__ __forceinline__ void store1(void* base, long long i,
                                                float x) {
    static_cast<float*>(base)[i] = x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Mem<true> {  // bf16, rounded to nearest even on store
  static __device__ __forceinline__ void load8(const void* base, long long i,
                                               float* o) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store8(void* base, long long i,
                                                const float* x) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    __stcs(reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i),
           raw);
  }
  static __device__ __forceinline__ float load1(const void* base,
                                                long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  }
  static __device__ __forceinline__ void store1(void* base, long long i,
                                                float x) {
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// One element, in the plain version's order of fp32 operations. p is the
// parameter as fp32; returns the new parameter before its store rounds it.
template <bool PBF16>
__device__ __forceinline__ float update(float p, float g, float& m, float& v,
                                        const Hyper& h, float c1, float c2) {
  const float mf = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  const float vf =
      __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vf, c2)), h.eps);
  const float step = __fadd_rn(__fdiv_rn(__fdiv_rn(mf, c1), den),
                               __fmul_rn(h.wd, p));
  const float u = __fmul_rn(h.neg_lr, step);
  m = mf;
  v = vf;
  return __fadd_rn(p, Mem<PBF16>::round(u));
}

template <bool PBF16, bool MBF16>
__device__ __forceinline__ void run_chunk(const Rec& r, long long lo,
                                          long long hi, const Hyper& h,
                                          float c1, float c2) {
  using P = Mem<PBF16>;
  using M = Mem<MBF16>;
  const bool aligned = (r.flags & kAligned) != 0;
  void* pp = reinterpret_cast<void*>(r.p);
  const void* gp = reinterpret_cast<const void*>(r.g);
  void* mp = reinterpret_cast<void*>(r.m);
  void* vp = reinterpret_cast<void*>(r.v);
  for (long long i = lo + (long long)threadIdx.x * kVec; i < hi;
       i += (long long)kThreads * kVec) {
    if (aligned && i + kVec <= hi) {
      float p[kVec], g[kVec], m[kVec], v[kVec];
      P::load8(pp, i, p);
      P::load8(gp, i, g);
      M::load8(mp, i, m);
      M::load8(vp, i, v);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        p[k] = update<PBF16>(p[k], g[k], m[k], v[k], h, c1, c2);
      P::store8(pp, i, p);
      M::store8(mp, i, m);
      M::store8(vp, i, v);
    } else {
      const long long end = i + kVec < hi ? i + kVec : hi;
      for (long long j = i; j < end; ++j) {
        float m = M::load1(mp, j), v = M::load1(vp, j);
        const float p = update<PBF16>(P::load1(pp, j), P::load1(gp, j), m, v,
                                      h, c1, c2);
        P::store1(pp, j, p);
        M::store1(mp, j, m);
        M::store1(vp, j, v);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const Rec* __restrict__ recs, int* __restrict__ arrived,
                 int n_tensors, long long total_chunks, Hyper h,
                 const float* __restrict__ lr) {
  __shared__ int s_t;      // the tensor of this block's chunk
  __shared__ int s_count;  // its step count after this update
  h.neg_lr = -*lr;  // exact: the plain version's −lr
  for (long long c = blockIdx.x; c < total_chunks; c += gridDim.x) {
    if (threadIdx.x == 0) {
      int lo = 0, hi = n_tensors - 1;  // last record with chunk0 <= c
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (recs[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
      }
      s_t = lo;
      s_count = *reinterpret_cast<const int*>(recs[lo].step) + 1;
    }
    __syncthreads();
    const Rec r = recs[s_t];
    const float count = (float)s_count;
    const float c1 = __fsub_rn(1.0f, powf(h.b1, count));
    const float c2 = __fsub_rn(1.0f, powf(h.b2, count));
    const long long lo = (c - r.chunk0) * kChunk;
    const long long hi = lo + kChunk < r.n ? lo + kChunk : r.n;
    switch (r.flags & (kParamBF16 | kMomentBF16)) {
      case 0: run_chunk<false, false>(r, lo, hi, h, c1, c2); break;
      case kParamBF16: run_chunk<true, false>(r, lo, hi, h, c1, c2); break;
      case kMomentBF16: run_chunk<false, true>(r, lo, hi, h, c1, c2); break;
      default: run_chunk<true, true>(r, lo, hi, h, c1, c2); break;
    }
    __syncthreads();  // every thread is done with s_t and s_count
    if (threadIdx.x == 0) {
      const long long chunks = r.n > kChunk ? (r.n + kChunk - 1) / kChunk : 1;
      __threadfence();
      if (atomicAdd(&arrived[s_t], 1) + 1 == chunks) {
        *reinterpret_cast<int*>(r.step) = s_count;
        arrived[s_t] = 0;
      }
    }
  }
}

}  // namespace

extern "C" {

// Elements a block takes at a time: ops/optim.py cuts the tensors into
// chunks of this many to build the table.
long long hvd_adamw_chunk_elems() { return kChunk; }

// Blocks of the persistent grid on each multiprocessor.
int hvd_adamw_blocks_per_sm() { return kBlocksPerSM; }

// lr: the learning rate, one fp32 on the device, read by every block at
// run time (a CUDA graph that captures the launch keeps reading the same
// tensor, so an update of the tensor reaches every replay).
int hvd_adamw(const void* recs, void* arrived, int n_tensors,
              long long total_chunks, int grid, float b1, float omb1,
              float b2, float omb2, float eps, float wd, const void* lr,
              void* stream) {
  if (n_tensors < 1 || total_chunks < 1 || grid < 1 || lr == nullptr)
    return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd, 0.0f};
  adamw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Rec*>(recs), static_cast<int*>(arrived), n_tensors,
      total_chunks, h, static_cast<const float*>(lr));
  return (int)cudaGetLastError();
}

}  // extern "C"
