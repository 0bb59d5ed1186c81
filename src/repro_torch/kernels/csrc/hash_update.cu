// Batched fetch-add into an i64 open-addressing hash table -- the HASH
// apply of the fused probe lane.
//
// Replaces the Pallas kernel src/repro/kernels/hash_update.py:24 `_kernel`
// (reached through `hash_fetch_add_batch_pallas`, :70). Its end state is
// bit-identical to applying the fetch-adds one by one in batch order.
//
// Bound on an H100: neither bytes nor operations -- the batch and the
// table are kilobytes (the least time, reading both once and writing the
// table once, is nanoseconds), so the time is one launch plus the serial
// insert chain. The Pallas kernel walks all B events in one serial loop;
// this design keeps the serial part to the keys that are new, and keeps it
// in shared memory:
//
//   phase 0  the tables come into shared memory (shared route), or are
//            copied in -> out by every block of the grid (global route).
//   phase 1  one thread per event looks its key up in the table as it
//            stood on entry (home slot ((k * 0x9E3779B97F4A7C15) >> 33) % n,
//            linear probing, a match counts only before the first EMPTY
//            slot, tombstones keep the chain). A resident key adds its
//            delta with a 64-bit atomicAdd: integer adds commute, so the
//            sum is exact whatever the order.
//   phase 2  the other (pending) events group by key in O(B): a batch-local
//            open-addressing table of m >= 2B slots, claimed by CAS on the
//            key, holds each key's least event index (atomicMin: the
//            leader, the key's first occurrence) and its delta sum
//            (integer atomicAdd). The key INT64_MIN, the empty marker of
//            that table, has its own slot m. CAS races decide only where a
//            key sits in this scratch table, never in the map's.
//   phase 3  warp 0 walks the events in batch order and, for each leader,
//            looks its key up in the table as it now stands: a match
//            before the first empty slot adds the group's sum (an earlier
//            insert may have filled the empty slot that hid the key in
//            phase 1); else the key goes into the first free (empty or
//            tombstone) slot of its chain with the group's sum, 4 x 32
//            slots per step by ballot; a full table drops it. With phase 0
//            the launch counts the free slots and checks whether any
//            resident key is hidden behind an empty slot of its own chain.
//            When none is (the usual case), a key phase 1 did not find is
//            nowhere in the table, so a leader needs only the first free
//            slot, and once none is left the rest drop without a probe.
//   phase 4  the tables go out (shared route).
//
// No slot of the map is claimed through CAS races, so the slot each key
// gets equals the sequential twin's. Within a fetch-add batch the table's
// structure changes only at each key's first valid event, in
// first-occurrence order in both formulations, and an insert never hides a
// resident key (it fills a free slot; tombstones and occupied slots both
// continue a chain), which is why phase 1 may see the entry table.
//
// Routes (the wrapper picks one from n and B alone):
//   shared  the three tables and the batch table fit in one block's
//           dynamic shared memory (up to 227 KB): one block of up to 1024
//           threads runs phases 0-4 in shared memory -- one launch, no
//           copy, no memset, the inputs read once and the outputs written
//           once.
//   global  larger tables stay in device memory. Phase 0 is spread over a
//           grid of up to 132 blocks (one block would copy a large table
//           slowly), with the free-slot count and the hidden-key check of
//           its share; each block fences and takes a ticket of a per-device
//           counter, and the block that draws the last one runs phases 1-3
//           on the output tables and resets the counters. Still one launch.
//           The batch table lives in that block's shared memory when it
//           fits there, else in a scratch buffer from the wrapper, which
//           the block initialises itself.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kMult = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long kNoKey = 0x8000000000000000ull;
constexpr int kNoLeader = 0x7fffffff;
constexpr int kSmemMax = 227 * 1024 - 1024;   // dynamic, with room for the
                                              // kernel's static bytes
constexpr int kMaxCopyBlocks = 132;           // SMs of an H100 SXM

__device__ __forceinline__ unsigned long long mix(long long k) {
  return (unsigned long long)k * kMult;
}

__device__ __forceinline__ long long home_slot(long long k, long long n) {
  const unsigned long long h = mix(k) >> 33;   // < 2^31
  if (n <= 0xffffffffll) return (long long)((unsigned)h % (unsigned)n);
  return (long long)(h % (unsigned long long)n);
}

// The global route's per-device counters (16 bytes of scratch).
struct Counters {
  unsigned ticket;              // blocks done with phase 0
  unsigned hidden;              // a resident key is hidden (see scan_slots)
  unsigned long long nfree;     // free (empty or tombstone) slots
};

struct Args {
  const long long *kt_in, *ut_in, *vt_in;
  long long *kt, *ut, *vt;
  long long n;
  const long long* keys;
  const long long* deltas;
  const unsigned char* valid;
  int batch;
  int m;                        // batch-table slots, a power of two
  unsigned char* scratch;       // the batch table when not in shared memory
  Counters* cnt;                // per-device, all 0 between launches
};

// The batch table: m keys, then m + 1 sums and m + 1 leaders (slot m is
// INT64_MIN's), then each event's slot (-1: resident or invalid).
struct Batch {
  unsigned long long* key;
  unsigned long long* sum;
  int* lead;
  int* slot_of;
};

__host__ __device__ inline long long batch_bytes(int m, int batch) {
  return 8ll * m + 8ll * (m + 1) + 4ll * (m + 1) + 4ll * batch;
}

__device__ __forceinline__ Batch batch_at(unsigned char* p, int m) {
  Batch b;
  b.key = reinterpret_cast<unsigned long long*>(p);
  b.sum = b.key + m;
  b.lead = reinterpret_cast<int*>(b.sum + m + 1);
  b.slot_of = b.lead + m + 1;
  return b;
}

__device__ __forceinline__ int batch_slot(const Batch& b, int m,
                                          long long k) {
  const unsigned long long uk = (unsigned long long)k;
  if (uk == kNoKey) return m;
  int s = (int)((mix(k) >> 33) & (unsigned long long)(m - 1));
  while (true) {
    const unsigned long long old = atomicCAS(b.key + s, kNoKey, uk);
    if (old == kNoKey || old == uk) return s;
    s = (s + 1) & (m - 1);
  }
}

// Table reads in phase 1: through L2 when the tables are in device memory
// (written by other blocks of this launch), plain in shared memory.
template <bool kShared>
__device__ __forceinline__ long long tload(const long long* p) {
  return kShared ? *p : __ldcg(p);
}

// Phase 3 for one leader: the whole warp probes kWindows windows of 32
// slots per step, their loads issued together (a single warp has no other
// work to hide its latency behind). Windows past the first empty slot or
// match change nothing: only the first of each kind counts.
constexpr int kWindows = 4;

__device__ __forceinline__ bool insert_one(volatile long long* kt,
                                           volatile long long* ut,
                                           volatile long long* vt,
                                           long long n, long long k,
                                           unsigned long long d, int lane) {
  const long long s0 = home_slot(k, n);
  long long first_match = n, first_free = n, first_empty = n;
  for (long long off = 0; off < n; off += 32 * kWindows) {
    long long u[kWindows], key[kWindows];
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      const long long j = off + 32 * w + lane;
      u[w] = 1;               // past the table: occupied by another key
      key[w] = ~k;
      if (j < n) {
        long long s = s0 + j;
        if (s >= n) s -= n;
        u[w] = ut[s];
        key[w] = kt[s];
      }
    }
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      const long long base = off + 32 * w;
      const unsigned bm = __ballot_sync(kFull, u[w] == 1 && key[w] == k);
      const unsigned bf = __ballot_sync(kFull, u[w] != 1);
      const unsigned be = __ballot_sync(kFull, u[w] == 0);
      if (first_match == n && bm) first_match = base + __ffs(bm) - 1;
      if (first_free == n && bf) first_free = base + __ffs(bf) - 1;
      if (first_empty == n && be) first_empty = base + __ffs(be) - 1;
    }
    if (first_empty < n || first_match < n) break;
  }
  const bool matched = first_match < first_empty;
  if (lane == 0) {
    if (matched) {
      long long t = s0 + first_match;
      if (t >= n) t -= n;
      vt[t] = (long long)((unsigned long long)vt[t] + d);
    } else if (first_free < n) {
      long long t = s0 + first_free;
      if (t >= n) t -= n;
      kt[t] = k;
      ut[t] = 1;
      vt[t] = (long long)d;
    }
  }
  __syncwarp();
  return !matched && first_free < n;
}

// Phase 3 for a leader whose key cannot match (see apply_batch): the first
// free slot of its chain, kWindows windows of 32 per step, if any is left.
__device__ __forceinline__ void insert_new(volatile long long* kt,
                                           volatile long long* ut,
                                           volatile long long* vt,
                                           long long n, long long k,
                                           unsigned long long d, int lane) {
  const long long s0 = home_slot(k, n);
  for (long long off = 0; off < n; off += 32 * kWindows) {
    unsigned bf[kWindows];
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      const long long j = off + 32 * w + lane;
      long long u = 1;
      if (j < n) {
        long long s = s0 + j;
        if (s >= n) s -= n;
        u = ut[s];
      }
      bf[w] = __ballot_sync(kFull, u != 1);
    }
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      if (bf[w]) {
        if (lane == 0) {
          long long t = s0 + off + 32 * w + __ffs(bf[w]) - 1;
          if (t >= n) t -= n;
          kt[t] = k;
          ut[t] = 1;
          vt[t] = (long long)d;
        }
        __syncwarp();
        return;
      }
    }
  }
}

// Over slots first, first + stride, ... of the entry table: this thread's
// count of free slots (a warp's sum in lane 0), and whether a resident key
// there is hidden -- an empty slot lies between its home slot and its own.
// With none hidden, a key that phase 1 does not find is nowhere in the
// table, so in phase 3 it can only be inserted, at the first free slot
// while one is left.
__device__ __forceinline__ void scan_slots(const long long* kt,
                                           const long long* ut, long long n,
                                           long long first, long long stride,
                                           unsigned long long& nfree,
                                           int& hidden) {
  nfree = 0;
  hidden = 0;
  for (long long s = first; s < n; s += stride) {
    if (ut[s] != 1) {
      ++nfree;
      continue;
    }
    for (long long t = home_slot(kt[s], n); t != s;
         t = (t + 1 == n) ? 0 : t + 1) {
      if (ut[t] == 0) {
        hidden = 1;
        break;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    nfree += __shfl_down_sync(kFull, nfree, o);
}

// Phases 1-3 over tables kt/ut/vt (shared or device memory) by one block,
// given the entry table's free slots and hidden flag (scan_slots).
template <bool kShared>
__device__ void apply_batch(const Args& p, long long* kt, long long* ut,
                            long long* vt, Batch b, long long nfree,
                            int hidden) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < p.m; i += nt) b.key[i] = kNoKey;
  for (int i = tid; i <= p.m; i += nt) {
    b.sum[i] = 0ull;
    b.lead[i] = kNoLeader;
  }
  __syncthreads();
  const long long n = p.n;
  // phases 1 and 2
  for (int i = tid; i < p.batch; i += nt) {
    int slot = -1;
    if (p.valid[i]) {
      const long long k = p.keys[i];
      const unsigned long long d = (unsigned long long)p.deltas[i];
      long long s = home_slot(k, n), found = -1;
      // four slots a step, their loads together; checked in chain order
      for (long long j = 0; j < n && found < 0; j += 4) {
        long long u[4], key[4], at[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          at[q] = s;
          u[q] = tload<kShared>(ut + s);
          key[q] = tload<kShared>(kt + s);
          s = (s + 1 == n) ? 0 : s + 1;
        }
        bool end = false;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (end || found >= 0 || j + q >= n) continue;
          if (u[q] == 1 && key[q] == k) found = at[q];
          else if (u[q] == 0) end = true;   // the chain ends here
        }
        if (end) break;
      }
      if (found >= 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(vt) + found, d);
      } else {
        slot = batch_slot(b, p.m, k);
        atomicMin(b.lead + slot, i);
        atomicAdd(b.sum + slot, d);
      }
    }
    b.slot_of[i] = slot;
  }
  __syncthreads();
  // phase 3
  if (tid < 32) {
    long long nfree_left = nfree;
    const volatile int* lead = b.lead;
    const volatile unsigned long long* sum = b.sum;
    const volatile unsigned long long* bkey = b.key;
    // with no key hidden and no free slot left, every later leader drops
    for (int base = 0; base < p.batch && (hidden || nfree_left > 0);
         base += 32) {
      const int i = base + tid;
      int s = -1;
      if (i < p.batch) s = b.slot_of[i];
      unsigned todo = __ballot_sync(kFull, s >= 0 && lead[s] == i);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int ls = __shfl_sync(kFull, s, src);
        // the key from the batch table (slot m is INT64_MIN's)
        const long long k = ls == p.m ? (long long)kNoKey : (long long)bkey[ls];
        if (hidden) {
          nfree_left -= insert_one(kt, ut, vt, n, k, sum[ls], tid);
        } else if (nfree_left > 0) {     // else the full table drops it
          insert_new(kt, ut, vt, n, k, sum[ls], tid);
          --nfree_left;
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024) hash_shared(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long nfree_sh;
  long long* kt = reinterpret_cast<long long*>(smem);
  long long* ut = kt + p.n;
  long long* vt = ut + p.n;
  if (threadIdx.x == 0) nfree_sh = 0;
  for (long long i = threadIdx.x; i < p.n; i += blockDim.x) {
    kt[i] = p.kt_in[i];
    ut[i] = p.ut_in[i];
    vt[i] = p.vt_in[i];
  }
  __syncthreads();
  unsigned long long nfree;
  int hidden;
  scan_slots(kt, ut, p.n, threadIdx.x, blockDim.x, nfree, hidden);
  if ((threadIdx.x & 31) == 0) atomicAdd(&nfree_sh, nfree);
  hidden = __syncthreads_or(hidden);
  apply_batch<true>(p, kt, ut, vt,
                    batch_at(reinterpret_cast<unsigned char*>(vt + p.n), p.m),
                    (long long)nfree_sh, hidden);
  for (long long i = threadIdx.x; i < p.n; i += blockDim.x) {
    p.kt[i] = kt[i];
    p.ut[i] = ut[i];
    p.vt[i] = vt[i];
  }
}

// Every block copies its share of the tables and scans the same share of
// the (never written) input tables for free slots and hidden keys into the
// counters; the block that draws the last ticket applies the batch.
__global__ void __launch_bounds__(1024) hash_global(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = first; i < p.n; i += stride) {
    p.kt[i] = p.kt_in[i];
    p.ut[i] = p.ut_in[i];
    p.vt[i] = p.vt_in[i];
  }
  unsigned long long nfree;
  int hidden;
  scan_slots(p.kt_in, p.ut_in, p.n, first, stride, nfree, hidden);
  if ((threadIdx.x & 31) == 0 && nfree) atomicAdd(&p.cnt->nfree, nfree);
  if (hidden) atomicOr(&p.cnt->hidden, 1u);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&p.cnt->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long total = (long long)atomicAdd(&p.cnt->nfree, 0ull);
  const int any_hidden = atomicAdd(&p.cnt->hidden, 0u) != 0;
  apply_batch<false>(p, p.kt, p.ut, p.vt,
                     batch_at(p.scratch ? p.scratch : smem, p.m), total,
                     any_hidden);
  if (threadIdx.x == 0) *p.cnt = Counters{0u, 0u, 0ull};   // for the next launch
}

// done: one bit per device, kept by the caller for this kernel alone
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned& done) {
  // above 48 KB of dynamic shared memory only after this opt-in, which
  // holds for the function on the current device; once per device
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (done & (1u << dev))) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

}  // namespace

// Tables *_in (i64[n]) are read, never written; kt/ut/vt (i64[n]) get the
// result. keys/deltas: i64[batch]; valid: bool[batch]. m: the batch-table
// slots (a power of two >= 2 * batch). shared = 1 takes the shared route
// (the caller checked 24 n + batch table <= 227 KB - 1 KB); else the global
// route, with the batch table in shared memory when scratch is null, else
// in scratch (batch table bytes, uninitialised). counters: 16 bytes per
// device, 0 between launches (the global route leaves them so). Returns the
// CUDA error of the launch (0 = ok).
extern "C" int repro_hash_fetch_add_batch(
    const long long* kt_in, const long long* ut_in, const long long* vt_in,
    long long* kt, long long* ut, long long* vt, long long n,
    const long long* keys, const long long* deltas,
    const unsigned char* valid, int batch, int m, int shared, void* scratch,
    void* counters, void* stream) {
  if (n < 1 || batch < 0 || m < 1 || (m & (m - 1)) || m < 2ll * batch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Args p{kt_in, ut_in, vt_in, kt, ut, vt, n, keys, deltas, valid, batch, m,
         static_cast<unsigned char*>(scratch),
         static_cast<Counters*>(counters)};
  const long long bb = batch_bytes(m, batch);
  const int threads = (batch > 256 || n > 1024) ? 1024 : 256;
  cudaError_t e;
  if (shared) {
    const long long smem = 24 * n + bb;
    if (smem > kSmemMax || scratch) return (int)cudaErrorInvalidValue;
    static unsigned done = 0;
    if ((e = allow_smem(hash_shared, (int)smem, done))) return (int)e;
    hash_shared<<<1, threads, (int)smem, st>>>(p);
  } else {
    const long long smem = scratch ? 0 : bb;
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    static unsigned done = 0;
    if ((e = allow_smem(hash_global, (int)smem, done))) return (int)e;
    long long grid = (n + 8ll * threads - 1) / (8ll * threads);
    if (grid > kMaxCopyBlocks) grid = kMaxCopyBlocks;
    hash_global<<<(int)grid, threads, (int)smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}
