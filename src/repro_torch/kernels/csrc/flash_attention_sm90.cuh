// Flash attention forward and backward for bf16 on Hopper (sm_90a): the
// kernels that `repro_flash_fwd` and `repro_flash_bwd` in
// flash_attention.cu launch for bf16 inputs. f32 inputs keep the FMA
// kernels of that file (see its note).
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
//   fwd_kernel <- `_fwd_kernel` (:35)
//   dkv_kernel <- `_dkv_kernel` (:130) and the rep-group sum of :250-251
//   dq_kernel  <- `_dq_kernel` (:172)
// (delta = sum(do * o), :219, stays the small `flash_delta_kernel`.)
//
// Bound on an H100: operations. At the training path's shape (B 2, S 4096,
// 14 q / 2 kv heads, hd 64, causal) the forward does 60 GFLOP on 19 MB
// (0.061 ms at 989 TFLOP/s) and the least backward 150 GFLOP (0.152 ms),
// far above the ~295 operations per byte where the card stops being bound
// by its memory. So every product runs on the tensor cores.
//
// Design.
// - Tiles of 64 rows (q and kv) live in shared memory as bf16, in the
//   swizzled layout that wgmma's shared-memory descriptors read: a row of
//   hd bf16 is 2 hd bytes, stored with the 128-byte swizzle for hd 64, as
//   two 128-byte-swizzled halves (columns 0-63, 64-127) for hd 128, and
//   with the 64- and 32-byte swizzles for hd 32 and 16. One physical tile
//   serves both descriptor kinds: K-major (hd is the reduction, as in
//   Q K^T) and MN-major (hd is the output width, as V in P V).
// - Copies are cp.async (16 bytes a thread, rows past S zero-filled) into
//   a ring of two stages: the next tile's copy overlaps this tile's
//   products. cp.async with the swizzle written by hand was taken over TMA
//   because the C interface gets raw pointers per call, so TMA would need
//   a tensor map encoded on the host at every call (cuTensorMapEncodeTiled,
//   looked up at run time by an entry-point query whose signature differs
//   between CUDA releases); the layout is the one TMA writes, so a later
//   version can swap the producer.
// - One warpgroup (128 threads) computes 64 rows with
//   wgmma.mma_async m64nNk16 (f32 += bf16 x bf16). S = Q K^T takes both
//   operands from shared memory; the online softmax (forward) or
//   P = exp(S scale - lse) and dS = P (dP - delta) scale (backward) run on
//   the f32 accumulator fragments in registers, where each row lives on
//   the four lanes of a quad; then P or dS is split into two bf16 terms
//   (below) and fed back as the register A operand of the second product
//   (P V, P^T dO, dS^T Q, dS K), with the other operand MN-major from
//   shared memory.
// - fwd: one block per (q tile, q head), heavy (late) q tiles first; loops
//   over the kv tiles up to the diagonal; masked scores are -1e30 as in
//   the Pallas kernel; lse = m + log(l) in natural log, f32.
// - dkv: computes S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T land
//   in the accumulator layout of the kv rows. The grid is balanced by
//   scheme (b): one block per (pair of kv tiles, kv head) walks kv tile ki
//   and then nk - 1 - ki, so under the causal mask every block walks
//   rep (nq + 1) q tiles. Scheme (a), a block per (kv tile, q head) with
//   f32 partials summed by a second pass, needs 2 BH Skv hd f32 of scratch
//   that the fixed C interface does not pass, and kernels allocate nothing.
//   The block's two warpgroups take alternate (q head, q tile) steps of
//   the walk, each with its own ring, and their f32 dk and dv sums are
//   added in a fixed order through shared memory and rounded once. No
//   atomics: repeated runs are bit-identical.
// - dq: one block per (q tile, q head), loops over the kv tiles; each block
//   writes its own rows.
//
// Arithmetic against the Pallas kernels and the plain versions, which keep
// P and dS in f32: here P (forward and backward) and dS enter the tensor
// cores as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), whose
// products are summed in the f32 accumulator, so each carries about 16
// significant bits. One bf16 term, as SDPA rounds P, puts o up to 1.15x
// outside its bf16 tolerance on inputs of the path's heads at S 1024
// (tests/test_torch_flash.py), and the tolerances stay as they were; the
// lo term costs one more product for each of P V, P^T dO, dS^T Q and
// dS K. The row sums l, and dS itself, are taken from the f32 P. Every
// accumulator is f32, the rep-group sum is f32 and rounded once, delta
// comes from the stored o.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;            // rows of every q and kv tile
constexpr int kWG = 128;             // threads of a warpgroup
constexpr float kMasked = -1e30f;    // NEG of the Pallas kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------ the tiles

// A [64, HD] bf16 tile in shared memory, swizzled as wgmma reads it.
template <int HD>
struct Tile {
  static constexpr int kRowB = HD * 2 < 128 ? HD * 2 : 128;  // swizzle row
  static constexpr int kPartB = kRows * kRowB;     // one 64-column half
  static constexpr int kBytes = kRows * HD * 2;
  static constexpr int kChunks = kRows * HD / 8;   // of 16 bytes
  // wgmma's layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kRowB == 128 ? 1 : kRowB == 64 ? 2 : 3;
  static constexpr uint32_t kSwz = kRowB / 16 - 1;

  // Byte offset of the 16-byte chunk c (columns 8c..8c+7) of row r: the
  // chunk index within each 128-byte line is XORed with the line's index
  // (mod 8, 4 or 2), the pattern the swizzle modes name.
  __device__ static __forceinline__ uint32_t off(int r, int c) {
    const uint32_t byte = c * 16;
    const uint32_t o = (byte / kRowB) * kPartB + r * kRowB + byte % kRowB;
    return o ^ (((o >> 7) & kSwz) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all >> 4), layout type in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | layout << 62;
}

// The tile as a K-major operand (hd is the reduction): columns
// 16 kk..16 kk+15 of all 64 rows. Eight-row groups lie 8 swizzle rows
// apart; a step along hd moves the start within the swizzle row.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using T = Tile<HD>;
  const uint32_t byte = kk * 32;
  return make_desc(tile + (byte / T::kRowB) * T::kPartB + byte % T::kRowB,
                   16, 8 * T::kRowB, T::kLayout);
}

// The tile as an MN-major operand (hd is the output width, the 64 rows the
// reduction): rows 16 kk..16 kk+15. Eight-row groups along the reduction
// are 8 swizzle rows apart (stride offset), the two halves of hd 128 a
// half apart (leading offset).
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using T = Tile<HD>;
  return make_desc(tile + kk * 16 * T::kRowB, T::kPartB, 8 * T::kRowB,
                   T::kLayout);
}

// ------------------------------------------------- asynchronous copies

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// This thread's shared-memory writes become visible to wgmma's (async
// proxy) reads; then a barrier publishes them to the warpgroup.
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1 + warpgroup) over the 128 threads of one warpgroup.
__device__ __forceinline__ void bar_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Rows [row0, row0 + 64) of a [S, HD] bf16 matrix into a tile, copied by
// threads tid = 0..n-1; rows past S are zero.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int row0, int S, int tid, int n) {
  for (int i = tid; i < Tile<HD>::kChunks; i += n) {
    const int r = i / (HD / 8), c = i % (HD / 8), g = row0 + r;
    const bool ok = g < S;
    cp16(dst + Tile<HD>::off(r, c), src + (size_t)(ok ? g : 0) * HD + c * 8,
         ok);
  }
}

// Entries [row0, row0 + 64) of an f32 vector (one a thread, tid < 64);
// past S they are zero.
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src,
                                         int row0, int S, int tid) {
  const int g = row0 + tid;
  cp4(dst + tid * 4, src + (g < S ? g : 0), g < S);
}

// --------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that wgmma reads or writes in program order around the
// fence and the wait, so the compiler moves no access across them.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N]: A and B from shared memory, both
// K-major (mma_ss), or A from registers and B MN-major (mma_rs). `acc` 0
// overwrites D. Accumulator fragment of thread tid of the warpgroup
// (warp w = tid / 32, g = lane / 4, t = lane % 4): d[i] is row
// 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
template <int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <int N>
__device__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                       int acc);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a,
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// S (+)= A B^T over the hd columns of two tiles: a 64 x 64 product.
template <int HD>
__device__ __forceinline__ void tile_abt(float (&s)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma_ss<64>(s, desc_k<HD>(a, kk), desc_k<HD>(b, kk), kk);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // round to nearest
  return *reinterpret_cast<uint32_t*>(&h);
}

// A 64 x 64 f32 accumulator d as two terms of bf16 A fragments, hi =
// bf16(d) and lo = bf16(d - hi), one fragment per k-step of 16 columns:
// the accumulator of columns 16 kk..16 kk+15 is already laid out as
// wgmma's register A operand of that k-step.
struct Frags {
  uint32_t hi[4][4], lo[4][4];
};
__device__ __forceinline__ void to_frags(Frags& f, const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = d[8 * kk + 2 * j], x1 = d[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      f.hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      f.lo[kk][j] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
    }
}

// D += F V for a split 64 x 64 matrix F and a tile V read MN-major: the
// lo term's products first, then the hi term's.
template <int HD>
__device__ __forceinline__ void tile_fv(float (&d)[HD / 2], const Frags& f,
                                        uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<HD>(d, f.lo[kk], desc_mn<HD>(v, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<HD>(d, f.hi[kk], desc_mn<HD>(v, kk), 1);
}

// 2^x on the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t align1024(const void* p) {
  return (smem_addr(p) + 1023u) & ~1023u;
}

// Store rows r0 and r0 + 8 of a 64 x HD accumulator fragment, times
// (f0, f1), as bf16 into dst [S, HD]; rows past S are skipped.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&d)[HD / 2],
                                           int r0, int S, float f0, float f1,
                                           int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r0 * HD + c) =
          pack_bf16(d[4 * j] * f0, d[4 * j + 1] * f0);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + 8) * HD + c) =
          pack_bf16(d[4 * j + 2] * f1, d[4 * j + 3] * f1);
  }
}

// -------------------------------------------------------------- forward

template <int HD>
constexpr int fwd_smem() {
  return 5 * Tile<HD>::kBytes + 1024;   // Q, two stages of K and V
}

template <int HD>
__global__ void __launch_bounds__(kWG)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int Sq, int Skv, int rep, int causal,
           float scale) {
  constexpr int B = Tile<HD>::kBytes;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = align1024(smem);
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2,
            t = tid & 3;
  const int nq = (Sq + kRows - 1) / kRows;
  const int qi = nq - 1 - (int)blockIdx.x, bh = blockIdx.y;
  const int q0 = qi * kRows, r0 = q0 + 16 * w + g;   // rows r0, r0 + 8
  const bf16* kp = k + (size_t)(bh / rep) * Skv * HD;
  const bf16* vp = v + (size_t)(bh / rep) * Skv * HD;
  int nk = (Skv + kRows - 1) / kRows;
  if (causal) nk = min(nk, (q0 + kRows - 1) / kRows + 1);

  load_tile<HD>(sQ, q + (size_t)bh * Sq * HD, q0, Sq, tid, kWG);
  load_tile<HD>(sQ + B, kp, 0, Skv, tid, kWG);
  load_tile<HD>(sQ + 2 * B, vp, 0, Skv, tid, kWG);
  cp_commit();

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;   // scores in log2 units
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kRows;
    const uint32_t sK = sQ + (1 + 2 * (ki & 1)) * B, sV = sK + B;
    if (ki + 1 < nk) {   // the next stage was last read in step ki - 1
      const uint32_t nK = sQ + (1 + 2 * ((ki + 1) & 1)) * B;
      load_tile<HD>(nK, kp, k0 + kRows, Skv, tid, kWG);
      load_tile<HD>(nK + B, vp, k0 + kRows, Skv, tid, kWG);
    }
    cp_commit();
    cp_wait<1>();
    fence_proxy();
    __syncthreads();

    float s[32];
    wg_fence();
    tile_abt<HD>(s, sQ, sK);
    wg_commit();
    wg_wait<0>();
    pin(s);
    const bool edge = k0 + kRows > Skv || (causal && k0 + kRows - 1 > q0);
    float mx[2] = {kMasked, kMasked};   // row maxima of the raw scores
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      if (edge) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (kpos >= Skv || (causal && r0 + 8 * h < kpos)) s[i] = kMasked;
      }
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // m in log2 units: scale is positive
      const float mn = fmaxf(m[h], quad_max(mx[h]) * sl2);
      corr[h] = ex2(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], sl2, -m[h]));
      rs[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(rs[h]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    Frags pf;
    to_frags(pf, s);   // P as two bf16 terms
    pin(acc);
    pin(pf.hi);
    pin(pf.lo);
    wg_fence();
    tile_fv<HD>(acc, pf, sV);
    wg_commit();
    wg_wait<0>();
    pin(acc);
    __syncthreads();   // every reader of this stage is done
  }

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  store_rows<HD>(o + (size_t)bh * Sq * HD, acc, r0, Sq, 1.f / l0, 1.f / l1,
                 t);
  if (t == 0) {
    float* lp = lse + (size_t)bh * Sq;
    if (r0 < Sq) lp[r0] = m[0] * kLn2 + logf(l0);
    if (r0 + 8 < Sq) lp[r0 + 8] = m[1] * kLn2 + logf(l1);
  }
}

// ------------------------------------------------------------------- dq

template <int HD>
constexpr int dq_smem() {
  return 6 * Tile<HD>::kBytes + 1024;   // Q, dO, two stages of K and V
}

template <int HD>
__global__ void __launch_bounds__(kWG)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int Sq, int Skv, int rep, int causal,
          float scale) {
  constexpr int B = Tile<HD>::kBytes;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = align1024(smem), sdO = sQ + B;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2,
            t = tid & 3;
  const int nq = (Sq + kRows - 1) / kRows;
  const int qi = nq - 1 - (int)blockIdx.x, bh = blockIdx.y;
  const int q0 = qi * kRows, r0 = q0 + 16 * w + g;
  const size_t qo = (size_t)bh * Sq * HD;
  const bf16* kp = k + (size_t)(bh / rep) * Skv * HD;
  const bf16* vp = v + (size_t)(bh / rep) * Skv * HD;
  int nk = (Skv + kRows - 1) / kRows;
  if (causal) nk = min(nk, (q0 + kRows - 1) / kRows + 1);

  load_tile<HD>(sQ, q + qo, q0, Sq, tid, kWG);
  load_tile<HD>(sdO, dout + qo, q0, Sq, tid, kWG);
  load_tile<HD>(sQ + 2 * B, kp, 0, Skv, tid, kWG);
  load_tile<HD>(sQ + 3 * B, vp, 0, Skv, tid, kWG);
  cp_commit();
  float L[2], D[2];   // lse (log2 units) and delta of rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    L[h] = r < Sq ? lse[(size_t)bh * Sq + r] * kLog2e : 0.f;
    D[h] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const float sl2 = scale * kLog2e;
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kRows;
    const uint32_t sK = sQ + (2 + 2 * (ki & 1)) * B, sV = sK + B;
    if (ki + 1 < nk) {
      const uint32_t nK = sQ + (2 + 2 * ((ki + 1) & 1)) * B;
      load_tile<HD>(nK, kp, k0 + kRows, Skv, tid, kWG);
      load_tile<HD>(nK + B, vp, k0 + kRows, Skv, tid, kWG);
    }
    cp_commit();
    cp_wait<1>();
    fence_proxy();
    __syncthreads();

    float s[32], dp[32];
    wg_fence();
    tile_abt<HD>(s, sQ, sK);
    tile_abt<HD>(dp, sdO, sV);
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    const bool edge = k0 + kRows > Skv || q0 + kRows > Sq ||
                      (causal && k0 + kRows - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, qpos = r0 + 8 * h;
      const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      float p = ex2(fmaf(s[i], sl2, -L[h]));
      if (edge && (kpos >= Skv || qpos >= Sq || (causal && qpos < kpos)))
        p = 0.f;
      s[i] = p * (dp[i] - D[h]) * scale;   // dS, f32
    }
    Frags df;
    to_frags(df, s);   // dS as two bf16 terms
    pin(acc);
    pin(df.hi);
    pin(df.lo);
    wg_fence();
    tile_fv<HD>(acc, df, sK);   // dQ += dS K
    wg_commit();
    wg_wait<0>();
    pin(acc);
    __syncthreads();
  }
  store_rows<HD>(dq + qo, acc, r0, Sq, 1.f, 1.f, t);
}

// ------------------------------------------------------------------ dkv

constexpr int kDkvWG = 2;   // warpgroups of a dkv block
static_assert(kDkvWG == 2, "the rep-group sum adds warpgroup 1 to 0");

template <int HD>
constexpr int dkv_smem() {
  // K, V; per warpgroup two stages of Q and dO; per warpgroup and stage
  // 64 lse and 64 delta values
  return (2 + 4 * kDkvWG) * Tile<HD>::kBytes + kDkvWG * 2 * 512 + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kWG * kDkvWG, 1)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
           int rep, int causal, float scale) {
  constexpr int B = Tile<HD>::kBytes;
  extern __shared__ uint8_t smem[];
  const uint32_t sK = align1024(smem), sV = sK + B;
  uint8_t* gbase = smem + (sK - smem_addr(smem));   // generic view of sK
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  // this warpgroup's ring: Q and dO of stage s, then lse and delta
  const uint32_t ring = sK + (2 + 4 * wg) * B;
  const int vec_off = (2 + 4 * kDkvWG) * B + wg * 1024;
  const int nq = (Sq + kRows - 1) / kRows, nk = (Skv + kRows - 1) / kRows;
  const int bkh = blockIdx.y;
  const size_t kvo = (size_t)bkh * Skv * HD;
  const float sl2 = scale * kLog2e;

  for (int pass = 0; pass < 2; ++pass) {
    // kv tiles ki and nk - 1 - ki: rep (nq + 1) q-tile steps in all
    const int ki = pass == 0 ? (int)blockIdx.x : nk - 1 - (int)blockIdx.x;
    if (pass == 1 && ki <= (int)blockIdx.x) break;
    const int k0 = ki * kRows, kr0 = k0 + 16 * w + g;   // rows kr0, kr0 + 8
    const int qf = causal ? min(nq, ki) : 0;   // first q tile that sees it
    const int nqt = nq - qf, T = rep * nqt;    // steps (q head, q tile)
    __syncthreads();   // the previous pass's readers are done
    load_tile<HD>(sK, k + kvo, k0, Skv, threadIdx.x, kWG * kDkvWG);
    load_tile<HD>(sV, v + kvo, k0, Skv, threadIdx.x, kWG * kDkvWG);
    cp_commit();
    auto fetch = [&](int s, int stage) {
      const int bh = bkh * rep + s / nqt, q0 = (qf + s % nqt) * kRows;
      const size_t qo = (size_t)bh * Sq * HD;
      const uint32_t sQ = ring + 2 * stage * B;
      load_tile<HD>(sQ, q + qo, q0, Sq, tid, kWG);
      load_tile<HD>(sQ + B, dout + qo, q0, Sq, tid, kWG);
      const uint32_t vec = sK + vec_off + stage * 512;
      if (tid < kRows)
        load_vec(vec, lse + (size_t)bh * Sq, q0, Sq, tid);
      else
        load_vec(vec + 256, delta + (size_t)bh * Sq, q0, Sq, tid - kRows);
    };
    if (wg < T) fetch(wg, 0);
    cp_commit();
    cp_wait<0>();
    fence_proxy();
    __syncthreads();

    float ak[HD / 2], av[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) ak[i] = av[i] = 0.f;
    int j = 0;
    for (int s = wg; s < T; s += kDkvWG, ++j) {
      const int stage = j & 1;
      if (s + kDkvWG < T) fetch(s + kDkvWG, stage ^ 1);
      cp_commit();
      cp_wait<1>();
      fence_proxy();
      bar_wg(1 + wg);
      const int q0 = (qf + s % nqt) * kRows;
      const uint32_t sQ = ring + 2 * stage * B, sdO = sQ + B;
      const float* Ls =
          reinterpret_cast<const float*>(gbase + vec_off + stage * 512);
      const float* Ds = Ls + kRows;

      float st[32], dpt[32];   // S^T and dP^T: rows kv, columns q
      wg_fence();
      tile_abt<HD>(st, sK, sQ);
      tile_abt<HD>(dpt, sV, sdO);
      wg_commit();
      wg_wait<0>();
      pin(st);
      pin(dpt);
      const bool edge = q0 + kRows > Sq || k0 + kRows > Skv ||
                        (causal && q0 < k0 + kRows - 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
        const int kpos = kr0 + 8 * ((i >> 1) & 1), qpos = q0 + qc;
        float p = ex2(fmaf(st[i], sl2, -Ls[qc] * kLog2e));
        if (edge && (qpos >= Sq || kpos >= Skv || (causal && qpos < kpos)))
          p = 0.f;
        dpt[i] = p * (dpt[i] - Ds[qc]) * scale;   // dS^T, f32
        st[i] = p;
      }
      Frags pf, df;
      to_frags(pf, st);    // P^T as two bf16 terms
      to_frags(df, dpt);   // dS^T as two bf16 terms
      pin(av);
      pin(ak);
      pin(pf.hi);
      pin(pf.lo);
      pin(df.hi);
      pin(df.lo);
      wg_fence();
      tile_fv<HD>(av, pf, sdO);   // dV += P^T dO
      tile_fv<HD>(ak, df, sQ);    // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      pin(av);
      pin(ak);
      bar_wg(1 + wg);   // this stage may be refilled
    }

    // the rep-group sum: warpgroup 1's f32 sums added to warpgroup 0's in
    // a fixed order, through warpgroup 1's ring, then rounded once
    __syncthreads();
    float* buf = reinterpret_cast<float*>(gbase + (2 + 4 * 1) * B);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        buf[i * kWG + tid] = ak[i];
        buf[(HD / 2 + i) * kWG + tid] = av[i];
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        ak[i] += buf[i * kWG + tid];
        av[i] += buf[(HD / 2 + i) * kWG + tid];
      }
      store_rows<HD>(dk + kvo, ak, kr0, Skv, 1.f, 1.f, t);
      store_rows<HD>(dv + kvo, av, kr0, Skv, 1.f, 1.f, t);
    }
  }
}

}  // namespace sm90
