// Batched fetch-add into an i64 open-addressing hash table -- the HASH
// apply of the fused probe lane.
//
// Replaces the Pallas kernel src/repro/kernels/hash_update.py:24 `_kernel`
// (reached through `hash_fetch_add_batch_pallas`, :70). Its end state is
// bit-identical to applying the fetch-adds one by one in batch order.
//
// Bound on an H100: neither bytes nor operations -- the batch and the
// table are kilobytes, so the time is launch latency plus the serial
// insert chain. The Pallas kernel walks all B events in one serial loop;
// this design keeps the serial part to the keys that are new:
//
//   phase 1  one thread per event looks its key up in the table as it
//            stood on entry (home slot ((k * 0x9E3779B97F4A7C15) >> 33) % n,
//            linear probing, a match counts only before the first EMPTY
//            slot, tombstones keep the chain). A resident key adds its
//            delta with a 64-bit atomicAdd: integer adds commute, so the
//            sum is exact whatever the order.
//   phase 1b one thread per pending (valid, not resident) event finds the
//            first pending event with the same key (its leader) and adds
//            its delta into the leader's group total (integer atomics).
//   phase 2  one warp walks the leaders in batch order -- the order of
//            first occurrence -- and inserts each key with its group total
//            at the first free (empty or tombstone) slot of its probe
//            chain, 32 slots per step by ballot; a full table drops it.
//
// No slot is claimed through CAS races, so the slot each key gets equals
// the sequential twin's. Within a fetch-add batch the table's structure
// changes only at each key's first valid event, in first-occurrence order
// in both formulations, which is why phase 1 may see the entry table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kMult = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ long long home_slot(long long k, long long n) {
  unsigned long long h = (unsigned long long)k * kMult;
  return (long long)((h >> 33) % (unsigned long long)n);
}

__global__ void hash_lookup_add(const long long* __restrict__ kt,
                                const long long* __restrict__ ut,
                                unsigned long long* vt, int n,
                                const long long* __restrict__ keys,
                                const long long* __restrict__ deltas,
                                const unsigned char* __restrict__ valid,
                                int batch, int* __restrict__ pending) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  int pend = 0;
  if (valid[i]) {
    const long long k = keys[i];
    long long s = home_slot(k, n);
    long long slot = -1;
    for (int j = 0; j < n; ++j) {
      const long long u = ut[s];
      if (u == 1 && kt[s] == k) {
        slot = s;
        break;
      }
      if (u == 0) break;  // chain ends at the first empty slot
      s = (s + 1 == n) ? 0 : s + 1;
    }
    if (slot >= 0) {
      atomicAdd(vt + slot, (unsigned long long)deltas[i]);
    } else {
      pend = 1;
    }
  }
  pending[i] = pend;
}

__global__ void hash_group(const long long* __restrict__ keys,
                           const long long* __restrict__ deltas,
                           const int* __restrict__ pending, int batch,
                           int* __restrict__ leader,
                           unsigned long long* gsum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  if (!pending[i]) {
    leader[i] = 0;
    return;
  }
  const long long k = keys[i];
  int lead = i;
  for (int j = 0; j < i; ++j) {
    if (pending[j] && keys[j] == k) {
      lead = j;
      break;
    }
  }
  leader[i] = (lead == i) ? 1 : 0;
  atomicAdd(gsum + lead, (unsigned long long)deltas[i]);
}

// One warp. The table is read through volatile pointers so that every lane
// sees the inserts lane 0 made for earlier leaders.
__global__ void hash_insert(volatile long long* kt, volatile long long* ut,
                            volatile long long* vt, int n,
                            const long long* __restrict__ keys,
                            const int* __restrict__ leader,
                            const unsigned long long* __restrict__ gsum,
                            int batch) {
  const int lane = threadIdx.x;
  for (int base = 0; base < batch; base += 32) {
    const int i = base + lane;
    unsigned todo = __ballot_sync(kFull, i < batch && leader[i] != 0);
    while (todo) {
      const int li = base + __ffs(todo) - 1;
      todo &= todo - 1;
      const long long k = keys[li];
      const long long d = (long long)gsum[li];
      const long long s0 = home_slot(k, n);
      int first_match = n, first_free = n, first_empty = n;
      for (int off = 0; off < n; off += 32) {
        const int j = off + lane;
        bool match = false, fr = false, em = false;
        if (j < n) {
          const long long s = (s0 + j) % n;
          const long long u = ut[s];
          match = (u == 1) && (kt[s] == k);
          fr = (u != 1);
          em = (u == 0);
        }
        const unsigned bm = __ballot_sync(kFull, match);
        const unsigned bf = __ballot_sync(kFull, fr);
        const unsigned be = __ballot_sync(kFull, em);
        if (first_match == n && bm) first_match = off + __ffs(bm) - 1;
        if (first_free == n && bf) first_free = off + __ffs(bf) - 1;
        if (first_empty == n && be) first_empty = off + __ffs(be) - 1;
        if (first_empty < n || first_match < n) break;
      }
      if (lane == 0) {
        if (first_match < first_empty) {
          const long long t = (s0 + first_match) % n;
          vt[t] = (long long)((unsigned long long)vt[t] +
                              (unsigned long long)d);
        } else if (first_free < n) {
          const long long t = (s0 + first_free) % n;
          kt[t] = k;
          ut[t] = 1;
          vt[t] = d;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Tables *_in (i64[n]) are copied to *_out, which the phases then update.
// keys/deltas: i64[batch]; valid: bool[batch]; pending/leader: i32[batch]
// and gsum: i64[batch] are scratch. Returns the CUDA error (0 = ok).
extern "C" int repro_hash_fetch_add_batch(
    const long long* kt_in, const long long* ut_in, const long long* vt_in,
    long long* kt, long long* ut, long long* vt, int n,
    const long long* keys, const long long* deltas,
    const unsigned char* valid, int batch, int* pending, int* leader,
    long long* gsum, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t tb = sizeof(long long) * (size_t)n;
  cudaError_t e;
  if ((e = cudaMemcpyAsync(kt, kt_in, tb, cudaMemcpyDeviceToDevice, st)) ||
      (e = cudaMemcpyAsync(ut, ut_in, tb, cudaMemcpyDeviceToDevice, st)) ||
      (e = cudaMemcpyAsync(vt, vt_in, tb, cudaMemcpyDeviceToDevice, st)))
    return (int)e;
  if (batch == 0) return 0;
  if ((e = cudaMemsetAsync(gsum, 0, sizeof(long long) * (size_t)batch, st)))
    return (int)e;
  const int threads = 256;
  const int blocks = (batch + threads - 1) / threads;
  hash_lookup_add<<<blocks, threads, 0, st>>>(
      kt, ut, reinterpret_cast<unsigned long long*>(vt), n, keys, deltas,
      valid, batch, pending);
  if ((e = cudaGetLastError())) return (int)e;
  hash_group<<<blocks, threads, 0, st>>>(
      keys, deltas, pending, batch, leader,
      reinterpret_cast<unsigned long long*>(gsum));
  if ((e = cudaGetLastError())) return (int)e;
  hash_insert<<<1, 32, 0, st>>>(kt, ut, vt, n, keys, leader,
                                reinterpret_cast<unsigned long long*>(gsum),
                                batch);
  return (int)cudaGetLastError();
}
