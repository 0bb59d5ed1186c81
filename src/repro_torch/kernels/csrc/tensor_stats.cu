// Fused tensor statistics for the probe collector -- one read of the tensor
// gives sum, sum of squares, min and max over the finite elements and the
// NaN and Inf counts, and one launch turns them into the result.
//
// Replaces the Pallas kernel src/repro/kernels/tensor_stats.py:25 `_kernel`
// (reached through `tensor_stats_pallas`, :68), and with the row epilogue
// the collector's stats-to-row step (src/repro/core/events.py:188-203).
//
// Bound on an H100: bytes. Every element is read once and used for a
// handful of operations, far below the ~295 operations per byte at which
// the card stops being limited by its device memory (3.35 TB/s on the
// H100 SXM data sheet, at its 700 W power limit). For the collector's
// small tensors (a few KB) the bound is the launch itself, so each event
// is exactly one launch that writes the finished result.
//
// Design:
//  - One launch, a grid that is a function of numel only (the wrapper's
//    `grid_for`). Threads accumulate sum and sum of squares in double and
//    the counts in 64-bit integers; bf16 is widened to f32 in registers.
//    A 16-byte unit whose values are all finite is summed in f32 first and
//    enters the double sums once: per-element double work would bound the
//    kernel below the memory's rate (bf16 has 8 values per unit).
//  - Body of the tensor (the 16-byte aligned middle): unrolled 16-byte
//    loads, kUnroll in flight per thread. A ring of Hopper's bulk
//    asynchronous copies (cp.async.bulk into shared memory, mbarrier
//    completion) was measured against these loads on one H100 and was
//    never faster (PERF.md, PR 14), so it was not kept. The unaligned head
//    and the tail (< 16 bytes each) take plain loads in block 0.
//  - Each block reduces with warp shuffles in a fixed order. With one block
//    that is the result. With more, each block writes its partial record
//    and takes a ticket (an acquire-release atomic add) on a per-device
//    counter; the block that draws the last ticket folds all partials in
//    a fixed order
//    (thread t takes blocks t, t + 256, then the same shuffle tree) and
//    resets the counter. Which block folds varies, the order does not: no
//    float atomics, repeated runs give identical results. The counter and
//    the partials live in one per-device scratch buffer, which assumes one
//    stream at a time per device (the wrapper enforces it).
//  - Epilogue: f32 mean/rms/min/max/absmax and i64 counts (the dict entry
//    point), or the collector's whole 16-lane i64 event row (the row entry
//    point), with the stats in Q47.16 exactly as `ref.to_fx` computes them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;                 // 16-byte loads in flight
constexpr int kScratchHead = 16;           // ticket counter, then partials
constexpr float kFxOne = 65536.0f;
constexpr float kFxMax = 4611686018427387904.0f;  // 2^62 - 1 rounded to f32

struct Acc {          // 40 bytes, also the layout of a partial record
  double s, ss;
  float mn, mx;
  unsigned long long nan, inf;
};

struct Args {
  const unsigned char* x;   // the tensor
  long long n;              // elements
  int head;                 // elements before the first 16-byte boundary
  int tail;                 // elements after the last whole 16-byte unit
  long long units;          // 16-byte units of the aligned body
  unsigned* ticket;         // per-device counter, 0 between launches
  Acc* part;                // per-device partial records, one per block
  float* out_f;             // dict epilogue: f32[5]
  long long* out_i;         // dict epilogue: i64[2]
  long long* row;           // row epilogue: i64[16]
  long long site, kind, layer;
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
  const bool is_nan = v != v;
  const bool is_inf = fabsf(v) == INFINITY;
  const bool ok = !(is_nan || is_inf);
  const double d = ok ? (double)v : 0.0;
  a.s += d;
  a.ss += d * d;
  a.mn = fminf(a.mn, ok ? v : INFINITY);
  a.mx = fmaxf(a.mx, ok ? v : -INFINITY);
  a.nan += is_nan ? 1ull : 0ull;
  a.inf += is_inf ? 1ull : 0ull;
}

__device__ __forceinline__ void acc_merge(Acc& a, const Acc& b) {
  a.s += b.s;
  a.ss += b.ss;
  a.mn = fminf(a.mn, b.mn);
  a.mx = fmaxf(a.mx, b.mx);
  a.nan += b.nan;
  a.inf += b.inf;
}

template <bool kBf16>
__device__ __forceinline__ float elem(const unsigned char* x, long long i) {
  if (kBf16) {
    const unsigned short b = reinterpret_cast<const unsigned short*>(x)[i];
    return __uint_as_float(((unsigned)b) << 16);
  }
  return reinterpret_cast<const float*>(x)[i];
}

// One 16-byte unit (4 f32 or 8 bf16). When all its values are finite (the
// common case) their sum and sum of squares are taken in f32 and added to
// the double accumulators once per unit: the per-element double work
// (conversion, add, fma) is what bounds the kernel at size otherwise.
template <bool kBf16>
__device__ __forceinline__ void acc_unit(Acc& a, uint4 u) {
  constexpr int kPer = kBf16 ? 8 : 4;
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  float v[kPer];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (kBf16) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    } else {
      v[k] = __uint_as_float(w[k]);
    }
  }
  bool finite = true;
#pragma unroll
  for (int k = 0; k < kPer; ++k) finite = finite && fabsf(v[k]) < INFINITY;
  if (finite) {
    float s = v[0], ss = v[0] * v[0], mn = v[0], mx = v[0];
#pragma unroll
    for (int k = 1; k < kPer; ++k) {
      s += v[k];
      ss = fmaf(v[k], v[k], ss);
      mn = fminf(mn, v[k]);
      mx = fmaxf(mx, v[k]);
    }
    a.s += (double)s;
    a.ss += (double)ss;
    a.mn = fminf(a.mn, mn);
    a.mx = fmaxf(a.mx, mx);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc_one(a, v[k]);
  }
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

// The block's total, valid in thread 0; every thread must call it.
__device__ __forceinline__ void block_reduce(Acc& a, Acc* red) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  warp_reduce(a);
  if (lane == 0) red[wid] = a;
  __syncthreads();
  if (wid == 0) {
    if (lane < kWarps) {
      a = red[lane];
    } else {
      acc_init(a);
    }
    warp_reduce(a);
  }
  __syncthreads();   // red may be reused
}

// ---- the body: 16-byte units [0, units) from a 16-byte aligned pointer

// Unit u belongs to thread u % (grid * kThreads); kUnroll loads in flight.
template <bool kBf16>
__device__ __forceinline__ void body(Acc& a, const uint4* xv,
                                     long long units) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; u + (kUnroll - 1) * stride < units; u += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) r[k] = __ldg(xv + u + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc_unit<kBf16>(a, r[k]);
  }
  for (; u < units; u += stride) acc_unit<kBf16>(a, __ldg(xv + u));
}

// The ticket: a release of this thread's partial record and an acquire of
// every earlier block's, in one atomic (cheaper than a full fence).
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

__device__ __forceinline__ Acc load_part(const Acc* p) {
  Acc a;   // written by other blocks of this launch: read through L2
  a.s = __ldcg(&p->s);
  a.ss = __ldcg(&p->ss);
  a.mn = __ldcg(&p->mn);
  a.mx = __ldcg(&p->mx);
  a.nan = __ldcg(&p->nan);
  a.inf = __ldcg(&p->inf);
  return a;
}

// f32 -> saturating Q47.16, as ref.to_fx: NaN -> 0, times 2^16 in f32,
// clamped in f32 to +-2^62, truncated toward zero.
__device__ __forceinline__ long long to_fx(float x) {
  float v = (x != x) ? 0.0f : x;
  v = v * kFxOne;
  v = fminf(fmaxf(v, -kFxMax), kFxMax);
  return (long long)v;
}

template <bool kRow>
__device__ void epilogue(const Acc& a, const Args& p) {
  const long long nan_c = (long long)a.nan;
  const long long inf_c = (long long)a.inf;
  const long long ok = p.n - nan_c - inf_c;
  const double n_ok = (double)(ok > 0 ? ok : 1);
  const float mn = ok > 0 ? a.mn : 0.0f;
  const float mx = ok > 0 ? a.mx : 0.0f;
  float f[5];
  f[0] = (float)(a.s / n_ok);
  f[1] = (float)sqrt(a.ss / n_ok);
  f[2] = mn;
  f[3] = mx;
  f[4] = fmaxf(fabsf(mn), fabsf(mx));
  if (kRow) {
    long long* r = p.row;
    r[0] = p.site;
    r[1] = p.kind;
    r[2] = p.layer;
    r[3] = 0;          // the step, filled in by the caller
    r[4] = p.n;
    for (int k = 0; k < 5; ++k) r[5 + k] = to_fx(f[k]);
    r[10] = nan_c;
    r[11] = inf_c;
    for (int k = 12; k < 16; ++k) r[k] = 0;
  } else {
    for (int k = 0; k < 5; ++k) p.out_f[k] = f[k];
    p.out_i[0] = nan_c;
    p.out_i[1] = inf_c;
  }
}

template <bool kBf16, bool kRow>
__global__ void __launch_bounds__(kThreads) stats_kernel(Args p) {
  __shared__ Acc red[kWarps];
  __shared__ int last;
  constexpr int kPer = kBf16 ? 8 : 4;       // elements per 16-byte unit
  Acc a;
  acc_init(a);
  if (blockIdx.x == 0) {
    if ((int)threadIdx.x < p.head) acc_one(a, elem<kBf16>(p.x, threadIdx.x));
    if ((int)threadIdx.x < p.tail)
      acc_one(a, elem<kBf16>(p.x, p.head + p.units * kPer + threadIdx.x));
  }
  const uint4* xv =
      reinterpret_cast<const uint4*>(p.x + (long long)p.head * (16 / kPer));
  body<kBf16>(a, xv, p.units);
  block_reduce(a, red);
  if (gridDim.x > 1) {
    if (threadIdx.x == 0) {
      p.part[blockIdx.x] = a;
      last = take_ticket(p.ticket) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    acc_init(a);
    for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
      acc_merge(a, load_part(p.part + b));
    block_reduce(a, red);
    if (threadIdx.x == 0) *p.ticket = 0u;    // ready for the next launch
  }
  if (threadIdx.x == 0) epilogue<kRow>(a, p);
}

template <bool kBf16, bool kRow>
int launch(const Args& p, int grid, cudaStream_t st) {
  stats_kernel<kBf16, kRow><<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <bool kRow>
int dispatch(Args& p, int is_bf16, int grid, void* scratch, void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const int es = is_bf16 ? 2 : 4;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(p.x);
  if (addr % es) return (int)cudaErrorMisalignedAddress;
  long long head = (long long)((16 - addr % 16) % 16) / es;
  if (head > p.n) head = p.n;
  p.head = (int)head;
  p.units = (p.n - head) * es / 16;
  p.tail = (int)(p.n - head - p.units * (16 / es));
  p.ticket = reinterpret_cast<unsigned*>(scratch);
  p.part = reinterpret_cast<Acc*>(static_cast<unsigned char*>(scratch) +
                                  kScratchHead);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<true, kRow>(p, grid, st)
                 : launch<false, kRow>(p, grid, st);
}

}  // namespace

// Shared by both entry points: x is f32 or bf16 (is_bf16), numel elements,
// contiguous; grid blocks (1 skips the partials and the ticket); scratch:
// the per-device buffer of 16 + 40 * max grid bytes whose
// first 4 bytes are 0 between launches. Each returns the CUDA error of the
// launch (0 = ok).

// out_f: f32[5] = mean, rms, min, max, absmax; out_i: i64[2] = nan, inf.
extern "C" int repro_tensor_stats(const void* x, int is_bf16, long long numel,
                                  int grid, void* scratch,
                                  float* out_f, long long* out_i,
                                  void* stream) {
  Args p{};
  p.x = static_cast<const unsigned char*>(x);
  p.n = numel;
  p.out_f = out_f;
  p.out_i = out_i;
  return dispatch<false>(p, is_bf16, grid, scratch, stream);
}

// row: i64[16] = site, kind, layer, 0, numel, mean, rms, min, max, absmax
// (Q47.16), nan, inf, 0, 0, 0, 0 -- the collector's event row.
extern "C" int repro_tensor_stats_row(const void* x, int is_bf16,
                                      long long numel, int grid,
                                      void* scratch, long long site,
                                      long long kind, long long layer,
                                      long long* row, void* stream) {
  Args p{};
  p.x = static_cast<const unsigned char*>(x);
  p.n = numel;
  p.row = row;
  p.site = site;
  p.kind = kind;
  p.layer = layer;
  return dispatch<true>(p, is_bf16, grid, scratch, stream);
}
