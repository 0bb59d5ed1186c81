// Causal GQA flash attention, forward and backward, for the training path.
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
//   repro_flash_fwd  <- `_fwd_kernel` (:35, reached through `flash_fwd` :79)
//   repro_flash_bwd  <- `_dkv_kernel` (:130) and `_dq_kernel` (:172), both
//                       reached through `flash_bwd` (:212), plus the
//                       `delta = sum(do * o)` that `flash_bwd` takes in jnp
//                       (:219), here a small kernel of its own.
//
// Layout (the Pallas kernels'): q, o, do [BH, Sq, hd]; k, v [BKH, Skv, hd];
// lse and delta [BH, Sq] in f32; q head bh reads kv head bh / rep with
// rep = BH / BKH, which is the grouping [B, S, KH, R, hd] of the model code.
// o, dq, dk and dv are written in the inputs' type.
//
// Dispatch by type, in the C entry points below:
// - bf16 (the training path's type) launches the Hopper kernels of
//   flash_attention_sm90.cuh: wgmma on swizzled bf16 tiles, cp.async rings,
//   a balanced dkv grid; P and dS enter the tensor cores as two bf16 terms
//   each (that file's note). A launch that fails returns its error;
//   nothing gives way to the kernels below.
// - f32 launches the FMA kernels below, which keep every product in f32 on
//   the CUDA cores: TF32 tensor cores would not hold test_flash_kernel.py's
//   f32 tolerances (2e-4 / 5e-4), and the smoke-width f32 training step runs
//   through them. These are not a fallback for bf16.
//
// The FMA kernels (f32): 64-row tiles of q and kv live in shared memory,
// and 256 threads each own a 4 x 4 patch of the 64 x 64 score tile (rows
// ty + 16 i, columns tx + 16 j) and 4 x (hd / 16) outputs. Bound by the
// f32 rate (67 TFLOP/s) and shared-memory bandwidth.
//   forward: one block per (q tile, bh); loops over the kv tiles up to the
//            diagonal (the causal skip of :48), online softmax in f32
//            registers; masked scores are -1e30 as in the Pallas kernel.
//            Heavy (late) q tiles are scheduled first.
//   dkv:     one block per (kv tile, bkh); loops over the rep q heads of
//            its group and over the q tiles from the diagonal on, so the
//            rep-group sum of :250-251 happens in registers.
//   dq:      one block per (q tile, bh); loops over the kv tiles.
// No atomics anywhere, in either family: repeated runs are bit-identical.
// Ragged edges (S not a multiple of 64) are masked: rows past Sq are
// neither stored nor counted, keys past Skv score -1e30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kT = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 256;   // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr int kSP = kT + 1;     // pitch of a 64 x 64 score tile in smem
constexpr float kNeg = -1e30f;  // NEG of the Pallas kernels
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// Sum or max over the 16 lanes that share ty (one half of a warp).
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Rows [row0, row0 + kT) of a [S, HD] matrix into an f32 tile of pitch
// HD + 1; rows past S are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0,
                                          int S) {
  for (int i = threadIdx.x; i < kT * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, g = row0 + r;
    dst[r * (HD + 1) + c] = g < S ? ld(src, (long long)g * HD + c) : 0.f;
  }
}

// Number of kv tiles a q tile starting at q0 visits.
__device__ __forceinline__ int kv_tiles(int q0, int Skv, int causal) {
  int nk = (Skv + kT - 1) / kT;
  if (causal) nk = min(nk, (q0 + kT - 1) / kT + 1);   // ki*kT <= q0+kT-1
  return nk;
}

// s[i][j] = sum_d A[ty+16i][d] * B[tx+16j][d] over two smem tiles.
template <int HD>
__device__ __forceinline__ void tile_abt(float (&s)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int P = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// -------------------------------------------------------------- forward

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int rep,
                 int causal, float scale) {
  constexpr int P = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kT * P;
  float* Vs = Ks + kT * P;
  float* Ps = Vs + kT * P;          // [kT][kSP]
  const int nq = (Sq + kT - 1) / kT;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qi * kT;
  const long long kvoff = (long long)(bh / rep) * Skv * HD;
  load_tile<HD>(Qs, q + (long long)bh * Sq * HD, q0, Sq);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }
  const int nk = kv_tiles(q0, Skv, causal);
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kT;
    __syncthreads();                 // the previous tile's readers are done
    load_tile<HD>(Ks, k + kvoff, k0, Skv);
    load_tile<HD>(Vs, v + kvoff, k0, Skv);
    __syncthreads();
    float s[4][4];
    tile_abt<HD>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= Skv || (causal && qpos < kpos)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kSP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kT; ++kk) {
      float vv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) vv[c] = Vs[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * kSP + kk];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float lv = fmaxf(l[i], 1e-30f);
    const long long base = ((long long)bh * Sq + row) * HD;
#pragma unroll
    for (int c = 0; c < ND; ++c) o[base + tx + 16 * c] = acc[i][c] / lv;
    if (tx == 0) lse[(long long)bh * Sq + row] = m[i] + logf(lv);
  }
}

// ------------------------------------------------------------- backward

// delta[r] = sum_d do[r, d] * o[r, d] in f32, one warp per row.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, long long rows) {
  const long long r = (long long)blockIdx.x * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float s = 0.f;
  for (int c = lane; c < HD; c += 32)
    s = fmaf(ld(dout, r * HD + c), ld(o, r * HD + c), s);
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(kFull, s, w);
  if (lane == 0) delta[r] = s;
}

// Scores and their gradient for one (q tile, kv tile) pair, written to
// smem as P[q][k] (when Ps is given) and dS[q][k]:
//   p  = exp(s * scale - lse)       (0 where masked or past Sq)
//   ds = p * (do . v - delta) * scale
template <int HD>
__device__ __forceinline__ void tile_p_ds(
    float* Ps, float* dSs, const float* Qs, const float* Ks, const float* dOs,
    const float* Vs, const float* Ls, const float* Ds, int q0, int k0, int Sq,
    int Skv, int causal, float scale, int ty, int tx) {
  float s[4][4], dp[4][4];
  tile_abt<HD>(s, Qs, Ks, ty, tx);
  tile_abt<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      float x = s[i][j] * scale;
      if (kpos >= Skv || (causal && qpos < kpos)) x = kNeg;
      const float p = qpos < Sq ? expf(x - Ls[r]) : 0.f;
      if (Ps != nullptr) Ps[r * kSP + c] = p;
      dSs[r * kSP + c] = p * (dp[i][j] - Ds[r]) * scale;
    }
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  if (threadIdx.x < kT) {
    const int g = row0 + threadIdx.x;
    dst[threadIdx.x] = g < S ? src[g] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Sq, int Skv, int rep, int causal,
                 float scale) {
  constexpr int P = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kT * P;
  float* Qs = Vs + kT * P;
  float* dOs = Qs + kT * P;
  float* Ps = dOs + kT * P;         // [kT][kSP]
  float* dSs = Ps + kT * kSP;       // [kT][kSP]
  float* Ls = dSs + kT * kSP;       // [kT]
  float* Ds = Ls + kT;              // [kT]
  const int ki = blockIdx.x;        // low kv tiles see the most q tiles
  const int bkh = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = ki * kT;
  const long long kvoff = (long long)bkh * Skv * HD;
  load_tile<HD>(Ks, k + kvoff, k0, Skv);
  load_tile<HD>(Vs, v + kvoff, k0, Skv);

  float gk[4][ND], gv[4][ND];       // rows ty + 16 i of the kv tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) gk[i][c] = gv[i][c] = 0.f;

  const int nq = (Sq + kT - 1) / kT;
  const int q_first = causal ? min(nq, k0 / kT) : 0;
  for (int r = 0; r < rep; ++r) {
    const int bh = bkh * rep + r;
    const long long qoff = (long long)bh * Sq * HD;
    for (int qi = q_first; qi < nq; ++qi) {
      const int q0 = qi * kT;
      __syncthreads();
      load_tile<HD>(Qs, q + qoff, q0, Sq);
      load_tile<HD>(dOs, dout + qoff, q0, Sq);
      load_rows(Ls, lse + (long long)bh * Sq, q0, Sq);
      load_rows(Ds, delta + (long long)bh * Sq, q0, Sq);
      __syncthreads();
      tile_p_ds<HD>(Ps, dSs, Qs, Ks, dOs, Vs, Ls, Ds, q0, k0, Sq, Skv,
                    causal, scale, ty, tx);
      __syncthreads();
      // dv += p^T do, dk += ds^T q
#pragma unroll 4
      for (int qq = 0; qq < kT; ++qq) {
        float a[ND], b[ND];
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          a[c] = dOs[qq * P + tx + 16 * c];
          b[c] = Qs[qq * P + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[qq * kSP + ty + 16 * i];
          const float ds = dSs[qq * kSP + ty + 16 * i];
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            gv[i][c] = fmaf(p, a[c], gv[i][c]);
            gk[i][c] = fmaf(ds, b[c], gk[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Skv) continue;
    const long long base = kvoff + (long long)row * HD;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      dk[base + tx + 16 * c] = gk[i][c];
      dv[base + tx + 16 * c] = gv[i][c];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int Sq,
                int Skv, int rep, int causal, float scale) {
  constexpr int P = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kT * P;
  float* Ks = dOs + kT * P;
  float* Vs = Ks + kT * P;
  float* dSs = Vs + kT * P;         // [kT][kSP]
  float* Ls = dSs + kT * kSP;
  float* Ds = Ls + kT;
  const int nq = (Sq + kT - 1) / kT;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qi * kT;
  const long long qoff = (long long)bh * Sq * HD;
  const long long kvoff = (long long)(bh / rep) * Skv * HD;
  load_tile<HD>(Qs, q + qoff, q0, Sq);
  load_tile<HD>(dOs, dout + qoff, q0, Sq);
  load_rows(Ls, lse + (long long)bh * Sq, q0, Sq);
  load_rows(Ds, delta + (long long)bh * Sq, q0, Sq);

  float g[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) g[i][c] = 0.f;
  const int nk = kv_tiles(q0, Skv, causal);
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kT;
    __syncthreads();
    load_tile<HD>(Ks, k + kvoff, k0, Skv);
    load_tile<HD>(Vs, v + kvoff, k0, Skv);
    __syncthreads();
    tile_p_ds<HD>(nullptr, dSs, Qs, Ks, dOs, Vs, Ls, Ds, q0, k0, Sq, Skv,
                  causal, scale, ty, tx);
    __syncthreads();
    // dq += ds k
#pragma unroll 4
    for (int kk = 0; kk < kT; ++kk) {
      float b[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) b[c] = Ks[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * kSP + kk];
#pragma unroll
        for (int c = 0; c < ND; ++c) g[i][c] = fmaf(ds, b[c], g[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const long long base = qoff + (long long)row * HD;
#pragma unroll
    for (int c = 0; c < ND; ++c) dq[base + tx + 16 * c] = g[i][c];
  }
}

// -------------------------------------------------------------- launch

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kT * (HD + 1) + kT * kSP);
}
template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kT * (HD + 1) + 2 * kT * kSP + 2 * kT);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kT * (HD + 1) + kT * kSP + 2 * kT);
}

// The softmax scale: the caller's, or 1/sqrt(hd) where it passes 0.
template <int HD>
float softmax_scale(float scale) {
  return scale > 0.f ? scale : 1.0f / sqrtf((float)HD);
}

template <int HD>
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse,
        int BH, int BKH, int Sq, int Skv, int causal, float scale,
        cudaStream_t st) {
  auto kern = flash_fwd_kernel<HD>;
  const size_t sm = fwd_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kT - 1) / kT, BH);
  kern<<<grid, kThreads, sm, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq, Skv, BH / BKH,
      causal, softmax_scale<HD>(scale));
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_f32(const void* q, const void* k, const void* v, const void* o,
        const float* lse, const void* dout, float* delta, void* dq, void* dk,
        void* dv, int BH, int BKH, int Sq, int Skv, int causal, float sc,
        cudaStream_t st) {
  const int rep = BH / BKH;
  const float scale = softmax_scale<HD>(sc);
  const long long rows = (long long)BH * Sq;
  flash_delta_kernel<float, HD><<<(unsigned)((rows + kThreads / 32 - 1) /
                                         (kThreads / 32)),
                              kThreads, 0, st>>>((const float*)o, (const float*)dout,
                                                 delta, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kdkv = flash_dkv_kernel<HD>;
  e = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  kdkv<<<dim3((Skv + kT - 1) / kT, BKH), kThreads, dkv_smem<HD>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, Sq, Skv, rep, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kdq = flash_dq_kernel<HD>;
  e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dq_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  kdq<<<dim3((Sq + kT - 1) / kT, BH), kThreads, dq_smem<HD>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, Sq, Skv, rep, causal, scale);
  return (int)cudaGetLastError();
}

// bf16: the Hopper kernels.
bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int HD>
int fwd_bf16(const void* q, const void* k, const void* v, void* o,
             float* lse, int BH, int BKH, int Sq, int Skv, int causal,
             float scale, cudaStream_t st) {
  if (!aligned16({q, k, v, o})) return (int)cudaErrorMisalignedAddress;
  auto kern = sm90::fwd_kernel<HD>;
  constexpr int sm = sm90::fwd_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((Sq + kT - 1) / kT, BH), sm90::kWG, sm, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, Sq, Skv, BH / BKH,
      causal, softmax_scale<HD>(scale));
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_bf16(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, float* delta, void* dq,
             void* dk, void* dv, int BH, int BKH, int Sq, int Skv,
             int causal, float sc, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (!aligned16({q, k, v, dout, dq, dk, dv}))
    return (int)cudaErrorMisalignedAddress;
  const int rep = BH / BKH;
  const float scale = softmax_scale<HD>(sc);
  const long long rows = (long long)BH * Sq;
  flash_delta_kernel<bf, HD><<<(unsigned)((rows + kThreads / 32 - 1) /
                                          (kThreads / 32)),
                               kThreads, 0, st>>>((const bf*)o,
                                                  (const bf*)dout, delta,
                                                  rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kdkv = sm90::dkv_kernel<HD>;
  constexpr int sdkv = sm90::dkv_smem<HD>();
  e = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sdkv);
  if (e != cudaSuccess) return (int)e;
  const int nk = (Skv + kT - 1) / kT;
  kdkv<<<dim3((nk + 1) / 2, BKH), sm90::kWG * sm90::kDkvWG, sdkv, st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, delta,
      (bf*)dk, (bf*)dv, Sq, Skv, rep, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kdq = sm90::dq_kernel<HD>;
  constexpr int sdq = sm90::dq_smem<HD>();
  e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sdq);
  if (e != cudaSuccess) return (int)e;
  kdq<<<dim3((Sq + kT - 1) / kT, BH), sm90::kWG, sdq, st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, delta,
      (bf*)dq, Sq, Skv, rep, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 -> the Hopper kernels, f32 -> the FMA kernels, by the `bf16` flag.
#define REPRO_FLASH_DISPATCH(F32, BF16)                   \
  switch (hd) {                                           \
    case 16: return bf16 ? BF16(16) : F32(16);            \
    case 32: return bf16 ? BF16(32) : F32(32);            \
    case 64: return bf16 ? BF16(64) : F32(64);            \
    case 128: return bf16 ? BF16(128) : F32(128);         \
    default: return (int)cudaErrorInvalidValue;           \
  }

// q [BH, Sq, hd], k/v [BKH, Skv, hd] -> o [BH, Sq, hd], lse f32 [BH, Sq].
// hd in {16, 32, 64, 128}; BH a multiple of BKH; bf16 pointers 16-byte
// aligned; scale the softmax's (0: 1/sqrt(hd)). Returns a cudaError_t.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int bf16, int BH,
                               int BKH, int Sq, int Skv, int hd, int causal,
                               float scale, void* stream) {
  if (BKH <= 0 || BH % BKH != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_FWD(HD) \
  fwd_f32<HD>(q, k, v, o, lse, BH, BKH, Sq, Skv, causal, scale, st)
#define REPRO_FWD_BF16(HD) \
  fwd_bf16<HD>(q, k, v, o, lse, BH, BKH, Sq, Skv, causal, scale, st)
  REPRO_FLASH_DISPATCH(REPRO_FWD, REPRO_FWD_BF16)
#undef REPRO_FWD
#undef REPRO_FWD_BF16
}

// Gradients of o = attention(q, k, v) for the output gradient `dout`, from
// the forward's o and lse; delta is f32 scratch [BH, Sq]. dq has q's shape,
// dk and dv k's. Returns a cudaError_t.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* o, const float* lse,
                               const void* dout, float* delta, void* dq,
                               void* dk, void* dv, int bf16, int BH, int BKH,
                               int Sq, int Skv, int hd, int causal,
                               float scale, void* stream) {
  if (BKH <= 0 || BH % BKH != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_BWD(HD)                                                       \
  bwd_f32<HD>(q, k, v, o, lse, dout, delta, dq, dk, dv, BH, BKH, Sq, Skv,   \
              causal, scale, st)
#define REPRO_BWD_BF16(HD)                                                  \
  bwd_bf16<HD>(q, k, v, o, lse, dout, delta, dq, dk, dv, BH, BKH, Sq, Skv,  \
               causal, scale, st)
  REPRO_FLASH_DISPATCH(REPRO_BWD, REPRO_BWD_BF16)
#undef REPRO_BWD
#undef REPRO_BWD_BF16
}
