// Fused tensor statistics for the probe collector -- one read of the tensor
// gives sum, sum of squares, min and max over the finite elements and the
// NaN and Inf counts.
//
// Replaces the Pallas kernel src/repro/kernels/tensor_stats.py:25 `_kernel`
// (reached through `tensor_stats_pallas`, :68).
//
// Bound on an H100: bytes. Every element is read once and used for a
// handful of operations, far below the ~295 operations per byte at which
// the card stops being limited by its device memory (3.35 TB/s on the
// H100 SXM data sheet, at its 700 W power limit).
//
// Design: a fixed grid of blocks (a function of numel only), each looping
// over a strided share of the tensor with 16-byte loads (4 f32 or 8 bf16)
// when the pointer is aligned. Threads accumulate sum and sum of squares
// in double and the counts in 64-bit integers; each block reduces with warp
// shuffles in a fixed order and writes one partial record. A second
// single-thread kernel folds the partials in block order and derives
// mean/rms/min/max/absmax. No float atomics: repeated runs give identical
// rows. bf16 is widened to f32 inside the kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Acc {
  double s, ss;
  float mn, mx;
  unsigned long long nan, inf;
};

__device__ __forceinline__ void acc_init(Acc& a) {
  a.s = 0.0;
  a.ss = 0.0;
  a.mn = INFINITY;
  a.mx = -INFINITY;
  a.nan = 0ull;
  a.inf = 0ull;
}

__device__ __forceinline__ void acc_one(Acc& a, float v) {
  if (isnan(v)) {
    a.nan += 1ull;
  } else if (isinf(v)) {
    a.inf += 1ull;
  } else {
    double d = (double)v;
    a.s += d;
    a.ss += d * d;
    a.mn = fminf(a.mn, v);
    a.mx = fmaxf(a.mx, v);
  }
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void warp_reduce(Acc& a) {
  for (int o = 16; o > 0; o >>= 1) {
    a.s += __shfl_down_sync(kFull, a.s, o);
    a.ss += __shfl_down_sync(kFull, a.ss, o);
    a.mn = fminf(a.mn, __shfl_down_sync(kFull, a.mn, o));
    a.mx = fmaxf(a.mx, __shfl_down_sync(kFull, a.mx, o));
    a.nan += __shfl_down_sync(kFull, a.nan, o);
    a.inf += __shfl_down_sync(kFull, a.inf, o);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
stats_partial(const void* __restrict__ x, long long n, int aligned,
              double* __restrict__ part) {
  Acc a;
  acc_init(a);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;  // elements covered by the vector loop
  if (aligned) {
    if (kBf16) {
      const uint4* xv = reinterpret_cast<const uint4*>(x);
      const long long nv = n / 8;
      for (long long i = tid; i < nv; i += stride) {
        uint4 u = __ldg(xv + i);
        acc_one(a, bf16_lo(u.x));
        acc_one(a, bf16_hi(u.x));
        acc_one(a, bf16_lo(u.y));
        acc_one(a, bf16_hi(u.y));
        acc_one(a, bf16_lo(u.z));
        acc_one(a, bf16_hi(u.z));
        acc_one(a, bf16_lo(u.w));
        acc_one(a, bf16_hi(u.w));
      }
      done = nv * 8;
    } else {
      const float4* xv = reinterpret_cast<const float4*>(x);
      const long long nv = n / 4;
      for (long long i = tid; i < nv; i += stride) {
        float4 f = __ldg(xv + i);
        acc_one(a, f.x);
        acc_one(a, f.y);
        acc_one(a, f.z);
        acc_one(a, f.w);
      }
      done = nv * 4;
    }
  }
  for (long long i = done + tid; i < n; i += stride) {
    float v;
    if (kBf16) {
      unsigned short b = reinterpret_cast<const unsigned short*>(x)[i];
      v = __uint_as_float(((unsigned)b) << 16);
    } else {
      v = reinterpret_cast<const float*>(x)[i];
    }
    acc_one(a, v);
  }

  __shared__ Acc sh[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  warp_reduce(a);
  if (lane == 0) sh[wid] = a;
  __syncthreads();
  if (wid == 0) {
    if (lane < kWarps) {
      a = sh[lane];
    } else {
      acc_init(a);
    }
    warp_reduce(a);
    if (lane == 0) {
      double* p = part + 6 * (long long)blockIdx.x;
      p[0] = a.s;
      p[1] = a.ss;
      p[2] = (double)a.mn;
      p[3] = (double)a.mx;
      p[4] = (double)a.nan;
      p[5] = (double)a.inf;
    }
  }
}

__global__ void stats_final(const double* __restrict__ part, int grid,
                            long long n, float* __restrict__ out_f,
                            long long* __restrict__ out_i) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  double s = 0.0, ss = 0.0, nan = 0.0, inf = 0.0;
  float mn = INFINITY, mx = -INFINITY;
  for (int g = 0; g < grid; ++g) {
    const double* p = part + 6 * (long long)g;
    s += p[0];
    ss += p[1];
    mn = fminf(mn, (float)p[2]);
    mx = fmaxf(mx, (float)p[3]);
    nan += p[4];
    inf += p[5];
  }
  const long long nan_c = (long long)nan;
  const long long inf_c = (long long)inf;
  const long long ok = n - nan_c - inf_c;
  const double n_ok = (double)(ok > 0 ? ok : 1);
  if (ok <= 0) {
    mn = 0.0f;
    mx = 0.0f;
  }
  out_f[0] = (float)(s / n_ok);
  out_f[1] = (float)sqrt(ss / n_ok);
  out_f[2] = mn;
  out_f[3] = mx;
  out_f[4] = fmaxf(fabsf(mn), fabsf(mx));
  out_i[0] = nan_c;
  out_i[1] = inf_c;
}

}  // namespace

// x: f32 or bf16 (is_bf16), numel elements, contiguous. part: double[6 *
// grid] scratch. out_f: f32[5] = mean, rms, min, max, absmax. out_i: i64[2]
// = nan count, inf count. Returns the CUDA error of the launches (0 = ok).
extern "C" int repro_tensor_stats(const void* x, int is_bf16, long long numel,
                                  int aligned, int grid, double* part,
                                  float* out_f, long long* out_i,
                                  void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    stats_partial<true><<<grid, kThreads, 0, st>>>(x, numel, aligned, part);
  } else {
    stats_partial<false><<<grid, kThreads, 0, st>>>(x, numel, aligned, part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_final<<<1, 32, 0, st>>>(part, grid, numel, out_f, out_i);
  return (int)cudaGetLastError();
}
