// Batched ring-buffer emit -- the RINGBUF apply of the fused probe lane.
//
// Replaces the Pallas kernel src/repro/kernels/ringbuf_emit.py:17 `_kernel`
// (reached through `ringbuf_emit_batch_pallas`, :34). The valid rows of an
// i64[B, W] batch land at (head + rank) % cap, where rank is the row's
// position among the valid rows; head advances by the number of valid rows.
//
// Bound on an H100: neither bytes nor operations -- the ring and the batch
// are kilobytes, so the time is one launch. One block of 1024 threads does
// everything, so no step needs a grid-wide barrier:
//   1. copy the ring in -> out;
//   2. exclusive scan of `valid` in chunks of 1024 (warp shuffles, then a
//      scan of the 32 warp totals), carrying the running count;
//   3. scatter row i, lane by lane, to slot (head + rank_i) % cap.
// When the batch holds more than `cap` valid rows, only ranks >= count -
// cap write: parallel writes to one slot would have no defined winner, and
// those are exactly the rows the sequential loop leaves in the ring.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
ringbuf_emit(const long long* __restrict__ data_in,
             const long long* __restrict__ head_in,
             const long long* __restrict__ rows,
             const unsigned char* __restrict__ valid, int cap, int width,
             int batch, long long* __restrict__ data_out,
             long long* __restrict__ head_out, long long* rank) {
  __shared__ long long warp_base[kWarps];
  __shared__ long long carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const long long ring = (long long)cap * width;
  for (long long e = tid; e < ring; e += kThreads) data_out[e] = data_in[e];
  if (tid == 0) carry = 0;
  __syncthreads();

  for (int base = 0; base < batch; base += kThreads) {
    const int i = base + tid;
    const int f = (i < batch && valid[i]) ? 1 : 0;
    int x = f;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_base[wid] = x;
    __syncthreads();
    if (wid == 0) {
      const long long t = warp_base[lane];
      long long inc = t;
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      warp_base[lane] = inc - t;  // exclusive prefix of the warp totals
    }
    __syncthreads();
    const long long excl = carry + warp_base[wid] + (x - f);
    if (i < batch) rank[i] = excl;
    __syncthreads();
    if (tid == kThreads - 1) carry = excl + f;
    __syncthreads();
  }

  const long long count = carry;
  const long long head = head_in[0];
  const long long lo = count - cap;  // ranks below lo are overwritten
  const long long total = (long long)batch * width;
  for (long long e = tid; e < total; e += kThreads) {
    const long long i = e / width;
    if (!valid[i]) continue;
    const long long r = rank[i];
    if (r < lo) continue;
    const long long slot = (head + r) % cap;
    data_out[slot * width + (e - i * width)] = rows[e];
  }
  if (tid == 0) head_out[0] = head + count;
}

}  // namespace

// data_in: i64[cap, width]; head_in: i64[1]; rows: i64[batch, width];
// valid: bool[batch]; data_out/head_out: outputs; rank: i64[batch]
// scratch. Returns the CUDA error of the launch (0 = ok).
extern "C" int repro_ringbuf_emit_batch(const long long* data_in,
                                        const long long* head_in,
                                        const long long* rows,
                                        const unsigned char* valid, int cap,
                                        int width, int batch,
                                        long long* data_out,
                                        long long* head_out, long long* rank,
                                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ringbuf_emit<<<1, kThreads, 0, st>>>(data_in, head_in, rows, valid, cap,
                                       width, batch, data_out, head_out,
                                       rank);
  return (int)cudaGetLastError();
}
