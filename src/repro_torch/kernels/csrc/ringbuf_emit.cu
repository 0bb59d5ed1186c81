// Batched ring-buffer emit -- the whole RINGBUF apply of the fused probe
// lane in one launch: data, head and the `dropped` lap counter.
//
// Replaces the Pallas kernel src/repro/kernels/ringbuf_emit.py:17 `_kernel`
// (reached through `ringbuf_emit_batch_pallas`, :34), and the dropped
// accounting around it (src/repro/core/vectorized.py:238-252). The valid
// rows of an i64[B, W] batch land at (head + rank) % cap, where rank is the
// row's position among the valid rows; head advances by the number of valid
// rows, and `dropped` by the rows whose monotonic position head + rank is
// at or past cap (each of those overwrote an unread record).
//
// Bound on an H100: neither bytes nor operations -- the ring and the batch
// are kilobytes, so the time is one launch. One block of 1024 threads does
// everything, so no step needs a grid-wide barrier, and nothing is written
// to scratch:
//   1. copy the ring in -> out and count the valid rows
//      (__syncthreads_count over chunks of 1024);
//   2. chunk by chunk, each valid row's rank from a warp ballot and the
//      warp totals' exclusive prefix, carried across chunks; the row goes
//      to slot (head + rank) % cap;
//   3. the lap count in closed form: the ranks are 0..count-1, and a rank
//      laps iff rank >= cap - head, so dropped += count - clamp(cap - head,
//      0, count).
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
             const long long* __restrict__ dropped_in,
             const long long* __restrict__ rows,
             const unsigned char* __restrict__ valid, int cap, int width,
             int batch, long long* __restrict__ data_out,
             long long* __restrict__ head_out,
             long long* __restrict__ dropped_out) {
  __shared__ int warp_pre[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const long long ring = (long long)cap * width;
  for (long long e = tid; e < ring; e += kThreads) data_out[e] = data_in[e];
  long long count = 0;
  for (int base = 0; base < batch; base += kThreads) {
    const int i = base + tid;
    count += __syncthreads_count(i < batch && valid[i]);
  }
  __syncthreads();  // the copy lands before any row overwrites it

  const long long head = head_in[0];
  const long long lo = count - cap;  // ranks below lo are overwritten
  long long carry = 0;
  for (int base = 0; base < batch; base += kThreads) {
    const int i = base + tid;
    const int f = (i < batch && valid[i]) ? 1 : 0;
    const unsigned ballot = __ballot_sync(kFull, f);
    const int within = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_pre[wid] = __popc(ballot);
    __syncthreads();
    if (wid == 0) {  // exclusive prefix of the 32 warp totals
      const int tot = warp_pre[lane];
      int inc = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      warp_pre[lane] = inc - tot;
    }
    __syncthreads();
    if (f) {
      const long long r = carry + warp_pre[wid] + within;
      if (r >= lo) {
        const long long slot = (head + r) % cap;
        const long long* src = rows + (long long)i * width;
        long long* dst = data_out + slot * width;
        for (int c = 0; c < width; ++c) dst[c] = src[c];
      }
    }
    // the chunk's count, and the barrier before warp_pre is written again
    carry += __syncthreads_count(f);
  }
  if (tid == 0) {
    long long first_lap = (long long)cap - head;  // first rank that laps
    if (first_lap < 0) first_lap = 0;
    if (first_lap > count) first_lap = count;
    head_out[0] = head + count;
    dropped_out[0] = dropped_in[0] + (count - first_lap);
  }
}

}  // namespace

// data_in: i64[cap, width]; head_in, dropped_in: i64[1]; rows:
// i64[batch, width]; valid: bool[batch]; data_out, head_out, dropped_out:
// outputs of the same shapes. Returns the CUDA error of the launch (0 = ok).
extern "C" int repro_ringbuf_emit_batch(const long long* data_in,
                                        const long long* head_in,
                                        const long long* dropped_in,
                                        const long long* rows,
                                        const unsigned char* valid, int cap,
                                        int width, int batch,
                                        long long* data_out,
                                        long long* head_out,
                                        long long* dropped_out,
                                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ringbuf_emit<<<1, kThreads, 0, st>>>(data_in, head_in, dropped_in, rows,
                                       valid, cap, width, batch, data_out,
                                       head_out, dropped_out);
  return (int)cudaGetLastError();
}
