// The live lane's eBPF program-table interpreter -- one launch per probe
// stage, whatever the table holds.
//
// No Pallas kernel: in the JAX package the interpreter is jnp/lax inside
// the compiled step (src/repro/core/table_interp.py: the sequential core
// `_build_core` :88-407, a while_loop per event and slot, and the batched
// lockstep machine `_build_batched_core` :573-829; `LiveTable.run`
// :1021-1067 orders them). Eager PyTorch has no device loop, so the
// interpreter is this kernel: it reads the verified bytecode from the packed
// table in device memory, and its launch arguments never depend on which
// programs are attached (attach and detach are writes to the table).
//
// Semantics, bit for bit those of the plain version
// (src/repro_torch/core/table_interp.py run_plain) and of the JAX package:
//   1. copy every map state and the aux block in -> out (the step keeps the
//      states it started from);
//   2. the sequential sub-lane: thread 0 walks the tape event by event and,
//      within an event, the active slots with vec == 0 in slot order --
//      fuel-bounded pc loop, the 14 helpers, the map switch, a 512-byte
//      stack in shared memory;
//   3. the vec sub-lane: for each active slot with vec == 1, in slot order,
//      the lockstep machine over the whole tape -- one machine step moves
//      every live lane by one instruction (the block's threads share the
//      lanes), ARRAY / PERCPU / LOG2HIST adds are exact 64-bit atomics (they
//      commute), and HASH fetch-adds, whose first inserts shape the table,
//      are applied by thread 0 in lane order after each machine step -- the
//      insert order of the JAX machine's j_hash_fetch_add_batch.
//
// Bound on an H100: neither bytes nor operations -- the table, the tape and
// the maps are kilobytes; the time is the instruction walk, serial in the
// sequential sub-lane. Right and simple first: one block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef long long i64;

constexpr int kThreads = 512;
constexpr int kMaxMaps = 24;
constexpr int kFields = 10;      // isa.TABLE_FIELDS
constexpr int kLaneWords = 32;   // per-lane scratch of the vec sub-lane
constexpr int kNarrow = 8;       // words of the vec machine's narrow stack
constexpr int kStackWords = 64;  // 512-byte frame

constexpr i64 kStackBase = 0x100000000LL;   // isa.STACK_BASE
constexpr i64 kStackSize = 512;
constexpr i64 kCtxBase = 0x200000000LL;     // isa.CTX_BASE
constexpr u64 kHashMult = 0x9E3779B97F4A7C15ULL;
constexpr i64 kMask32 = 0xFFFFFFFFLL;

// table field order (isa.TABLE_FIELDS)
enum { F_HCLS, F_DST, F_SRC, F_OFF, F_IMM, F_ALUOP, F_USE_IMM, F_SIZE,
       F_TGT, F_HID };
// meta rows after the fields (table_interp.META_FIELDS)
enum { M_ACTIVE, M_SITE, M_KIND, M_NINSNS, M_FUEL, M_VEC };
// handler classes (isa.TH_*)
enum { TH_ALU64, TH_ALU32, TH_LDDW, TH_LDX, TH_ST, TH_STX, TH_JA,
       TH_JCOND64, TH_JCOND32, TH_CALL, TH_EXIT };
// helper branch index = position in sorted(HELPERS)
enum { H_LOOKUP, H_UPDATE, H_DELETE, H_KTIME, H_PRINTK, H_PRANDOM, H_CPU,
       H_PID, H_RINGBUF, H_FETCH_ADD, H_LOG2, H_OVERRIDE, H_HIST,
       H_PERCPU_FETCH_ADD, H_COUNT };
// map kinds (the wrapper's codes)
enum { K_ARRAY, K_HASH, K_PERCPU, K_HIST, K_RINGBUF };
// lane scratch layout
enum { L_REGS = 0, L_STACK = 11, L_PC = 19, L_FUEL = 20, L_DONE = 21,
       L_HREQ = 22, L_HFD = 23, L_HKEY = 24, L_HDELTA = 25 };
// packed aux out: time, cpu, pid, rand, override set/val, printk_n, buf
enum { A_TIME, A_CPU, A_PID, A_RAND, A_OVSET, A_OVVAL, A_PRINTK_N,
       A_PRINTK_BUF, A_WORDS = A_PRINTK_BUF + 16 };

struct MapDesc {
  i64 kind, n, width, shards;
  i64 len[3];            // words of each state field (0 = none)
  const i64* in[3];      // ARRAY/PERCPU: values; HASH: keys, used, values;
  i64* out[3];           // LOG2HIST: bins; RINGBUF: data, head, dropped
};

// Every field is 8 bytes, so the wrapper fills the launch's parameters as
// one i64 array (kernels/table_interp.py, HEAD_WORDS / DESC_WORDS).
struct Params {
  const i64* table;      // packed: fields [P, N], meta [P], gen
  const i64* rows;       // tape i64[E, ctx_words]
  const i64* aux_in[8];  // time, cpu, pid, rand, ov_set, ov_val, buf, n
  i64* aux_out;          // A_WORDS
  i64* r0;               // i64[P, E] or null
  i64* lanes;            // i64[E, kLaneWords] scratch (vec sub-lane)
  i64 P, N, E, ctx_words, nmaps, match_all;
  MapDesc maps[kMaxMaps];
};

// ------------------------------------------------------------ arithmetic

__device__ __forceinline__ i64 clampi(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ i64 s32view(i64 x) {
  const i64 lo = x & kMask32;
  return (lo >> 31) ? lo - (1LL << 32) : lo;
}

// jit._alu: 32-bit ops work on the low 32 bits and zero-extend
__device__ i64 alu(i64 op, i64 d, i64 s, bool is64) {
  if (!is64) {
    d &= kMask32;
    s &= kMask32;
  }
  const u64 bits = is64 ? 63 : 31;
  const u64 ud = (u64)d, us = (u64)s;
  u64 r;
  switch (clampi(op, 0, 12)) {
    case 0: r = ud + us; break;                         // add
    case 1: r = ud - us; break;                         // sub
    case 2: r = ud * us; break;                         // mul
    case 3: r = us == 0 ? 0 : ud / us; break;           // div
    case 4: r = ud | us; break;                         // or
    case 5: r = ud & us; break;                         // and
    case 6: r = ud << (us & bits); break;               // lsh
    case 7: r = ud >> (us & bits); break;               // rsh
    case 8: r = (u64)0 - ud; break;                     // neg
    case 9: r = us == 0 ? ud : ud % us; break;          // mod
    case 10: r = ud ^ us; break;                        // xor
    case 11: r = us; break;                             // mov
    default:                                            // arsh
      r = (u64)((is64 ? d : s32view(d)) >> (us & bits));
  }
  if (!is64) r &= (u64)kMask32;
  return (i64)r;
}

// jit._jmp_cond, indexed by (op & OP_MASK) >> 4; ja/call/exit slots false
__device__ bool jcond(i64 op, i64 lhs, i64 rhs, bool is64) {
  u64 ul, ur;
  i64 sl, sr;
  if (is64) {
    ul = (u64)lhs; ur = (u64)rhs; sl = lhs; sr = rhs;
  } else {
    ul = (u64)(lhs & kMask32); ur = (u64)(rhs & kMask32);
    sl = s32view(lhs); sr = s32view(rhs);
  }
  switch (clampi(op, 0, 13)) {
    case 1: return ul == ur;         // jeq
    case 2: return ul > ur;          // jgt
    case 3: return ul >= ur;         // jge
    case 4: return (ul & ur) != 0;   // jset
    case 5: return ul != ur;         // jne
    case 6: return sl > sr;          // jsgt
    case 7: return sl >= sr;         // jsge
    case 10: return ul < ur;         // jlt
    case 11: return ul <= ur;        // jle
    case 12: return sl < sr;         // jslt
    case 13: return sl <= sr;        // jsle
    default: return false;
  }
}

__device__ __forceinline__ u64 low_mask(i64 nbytes) {
  return nbytes >= 8 ? ~0ULL : ((1ULL << ((8 * nbytes) & 63)) - 1ULL);
}

// jit.dyn_word_load: little-endian `size` bytes at byte offset `off`,
// word indices clipped as the plain version clips them
__device__ i64 word_load(const i64* w, i64 nwords, i64 off, i64 size) {
  const i64 w0 = clampi(off >> 3, 0, nwords - 1);
  const i64 w1 = w0 + 1 < nwords ? w0 + 1 : nwords - 1;
  const i64 rb = off & 7;
  const u64 lo = (u64)w[w0] >> (8 * rb);
  const u64 hi = rb == 0 ? 0ULL : (u64)w[w1] << ((64 - 8 * rb) & 63);
  return (i64)((lo | hi) & low_mask(size));
}

// jit.dyn_word_store: read-modify-write of the one or two covering words;
// word1 first, so a clipped w1 == w0 cannot clobber the word0 write
__device__ void word_store(i64* w, i64 nwords, i64 off, i64 size, i64 val) {
  const i64 w0 = clampi(off >> 3, 0, nwords - 1);
  const i64 w1 = w0 + 1 < nwords ? w0 + 1 : nwords - 1;
  const i64 rb = off & 7;
  const u64 v = (u64)val & low_mask(size);
  const i64 nb0 = size < 8 - rb ? size : 8 - rb;
  const u64 m0 = low_mask(nb0) << (8 * rb);
  const u64 old0 = (u64)w[w0], old1 = (u64)w[w1];
  const u64 new0 = (old0 & ~m0) | ((v << (8 * rb)) & m0);
  const bool spans = rb + size > 8;
  const i64 nb1 = clampi(rb + size - 8, 0, 7);
  const u64 m1 = (1ULL << (8 * nb1)) - 1ULL;
  const u64 new1 = (old1 & ~m1) | ((v >> ((8 * (8 - rb)) & 63)) & m1);
  w[w1] = (i64)(spans ? new1 : old1);
  w[w0] = (i64)new0;
}

__device__ __forceinline__ i64 log2_bin(i64 v) {
  if (v <= 0) return 0;
  const i64 b = 64 - __clzll(v);
  return b < 63 ? b : 63;
}

// ------------------------------------------------------------ map twins

// maps._t_hash_find: probe from the home slot; a match counts only before
// the first EMPTY slot (tombstones keep chains); inserts take the first
// tombstone-or-empty slot.
struct Find {
  i64 slot, free_slot;
  bool found, has_free;
};

__device__ Find hash_find(const MapDesc& m, i64 key) {
  const i64 n = m.n;
  const i64* keys = m.out[0];
  const i64* used = m.out[1];
  const i64 start = (i64)((((u64)key * kHashMult) >> 33) % (u64)n);
  i64 fm = n, ff = n, fe = n;
  for (i64 i = 0; i < n; ++i) {
    i64 s = start + i;
    if (s >= n) s -= n;
    const i64 u = used[s];
    if (u == 1) {
      if (fm == n && keys[s] == key) fm = i;
    } else {
      if (ff == n) ff = i;
      if (u == 0) {
        fe = i;
        break;
      }
    }
  }
  Find f;
  f.found = fm < n && fm < fe;
  f.has_free = ff < n;
  i64 a = start + (fm < n ? fm : n - 1), b = start + (ff < n ? ff : n - 1);
  f.slot = a >= n ? a - n : a;
  f.free_slot = b >= n ? b - n : b;
  return f;
}

// maps.t_hash_fetch_add with pred = True; returns the old value
__device__ i64 hash_fetch_add(const MapDesc& m, i64 key, i64 delta) {
  const Find f = hash_find(m, key);
  i64* vals = m.out[2];
  const i64 old = f.found ? vals[f.slot] : 0;
  if (f.found || f.has_free) {
    const i64 t = f.found ? f.slot : f.free_slot;
    m.out[0][t] = key;
    m.out[1][t] = 1;
    vals[t] = f.found ? (i64)((u64)vals[f.slot] + (u64)delta) : delta;
  }
  return old;
}

// ------------------------------------------------------------ the kernel

struct Shared {
  MapDesc maps[kMaxMaps];
  i64 stack[kStackWords];  // the sequential sub-lane's frame
  int hash_pending;
};

__device__ __forceinline__ i64 field(const i64* T, int P, int N, int f, int p,
                                     i64 i) {
  return T[((i64)f * P + p) * N + i];
}

__device__ __forceinline__ i64 meta(const i64* T, int P, int N, int f,
                                    int p) {
  return T[(i64)kFields * P * N + (i64)f * P + p];
}

__global__ void __launch_bounds__(kThreads)
table_interp(const __grid_constant__ Params prm) {
  extern __shared__ i64 T[];  // the packed table
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int P = (int)prm.P, N = (int)prm.N, E = (int)prm.E;
  const int cw = (int)prm.ctx_words, nmaps = (int)prm.nmaps;
  const i64 twords = (i64)kFields * P * N + 6LL * P + 1;
  for (i64 i = tid; i < twords; i += kThreads) T[i] = prm.table[i];
  for (int i = tid; i < nmaps; i += kThreads) sh.maps[i] = prm.maps[i];
  __syncthreads();
  // 1. copy the map states and the aux block in -> out
  for (int m = 0; m < nmaps; ++m)
    for (int f = 0; f < 3; ++f) {
      const MapDesc& d = sh.maps[m];
      for (i64 i = tid; i < d.len[f]; i += kThreads) d.out[f][i] = d.in[f][i];
    }
  if (tid == 0) {
    i64* a = prm.aux_out;
    a[A_TIME] = *prm.aux_in[0];
    a[A_CPU] = *prm.aux_in[1];
    a[A_PID] = *prm.aux_in[2];
    a[A_RAND] = *prm.aux_in[3];
    a[A_OVSET] = *prm.aux_in[4];
    a[A_OVVAL] = *prm.aux_in[5];
    for (int i = 0; i < 16; ++i) a[A_PRINTK_BUF + i] = prm.aux_in[6][i];
    a[A_PRINTK_N] = *prm.aux_in[7];
    sh.hash_pending = 0;
  }
  __syncthreads();
  const i64 time_ns = prm.aux_out[A_TIME], cpu = prm.aux_out[A_CPU],
            pid = prm.aux_out[A_PID];

  // 2. the sequential sub-lane, thread 0
  if (tid == 0) {
    i64* a = prm.aux_out;
    i64* stk = sh.stack;
    for (int e = 0; e < E; ++e) {
      const i64* ctx = prm.rows + (i64)e * cw;
      for (int p = 0; p < P; ++p) {
        if (!meta(T, P, N, M_ACTIVE, p) || meta(T, P, N, M_VEC, p)) continue;
        if (!prm.match_all && (ctx[0] != meta(T, P, N, M_SITE, p) ||
                               ctx[1] != meta(T, P, N, M_KIND, p)))
          continue;
        i64 regs[11];
        for (int r = 0; r < 11; ++r) regs[r] = 0;
        regs[1] = kCtxBase;
        regs[10] = kStackBase + kStackSize;
        for (int w = 0; w < kStackWords; ++w) stk[w] = 0;
        i64 pc = 0, fuel = meta(T, P, N, M_FUEL, p);
        bool done = false;
        while (!done && fuel > 0) {
          const i64 i = clampi(pc, 0, N - 1);
          const i64 hcls = clampi(field(T, P, N, F_HCLS, p, i), 0, TH_EXIT);
          // verified programs name r0-r10; the clamp keeps a corrupt row
          // inside the register file
          const i64 dst = clampi(field(T, P, N, F_DST, p, i), 0, 10);
          const i64 src = clampi(field(T, P, N, F_SRC, p, i), 0, 10);
          const i64 off = field(T, P, N, F_OFF, p, i);
          const i64 imm = field(T, P, N, F_IMM, p, i);
          const i64 aluop = field(T, P, N, F_ALUOP, p, i);
          const bool use_imm = field(T, P, N, F_USE_IMM, p, i) != 0;
          const i64 size = field(T, P, N, F_SIZE, p, i);
          bool taken = true;
          switch (hcls) {
            case TH_ALU64:
            case TH_ALU32:
              regs[dst] = alu(aluop, regs[dst], use_imm ? imm : regs[src],
                              hcls == TH_ALU64);
              break;
            case TH_LDDW:
              regs[dst] = imm;
              break;
            case TH_LDX: {
              const i64 addr = regs[src] + off;
              regs[dst] = addr >= kCtxBase
                              ? word_load(ctx, cw, addr - kCtxBase, size)
                              : word_load(stk, kStackWords,
                                          addr - kStackBase, size);
              break;
            }
            case TH_ST:
            case TH_STX:
              word_store(stk, kStackWords, regs[dst] + off - kStackBase,
                         size, hcls == TH_STX ? regs[src] : imm);
              break;
            case TH_JCOND64:
            case TH_JCOND32:
              taken = jcond(aluop, regs[dst], use_imm ? imm : regs[src],
                            hcls == TH_JCOND64);
              break;
            case TH_CALL: {
              const i64 hid =
                  clampi(field(T, P, N, F_HID, p, i), 0, H_COUNT - 1);
              const bool mapped = hid == H_LOOKUP || hid == H_UPDATE ||
                                  hid == H_DELETE || hid == H_FETCH_ADD ||
                                  hid == H_PERCPU_FETCH_ADD || hid == H_HIST ||
                                  hid == H_RINGBUF;
              i64 r0 = 0;
              if (mapped && nmaps > 0) {
                const MapDesc& m = sh.maps[clampi(regs[1], 0, nmaps - 1)];
                const i64 key =
                    word_load(stk, kStackWords, regs[2] - kStackBase, 8);
                const i64 n = m.n;
                const bool inb = key >= 0 && key < n;
                const i64 shard = clampi(cpu, 0, m.shards - 1);
                switch (hid) {
                  case H_LOOKUP:
                    if (m.kind == K_ARRAY)
                      r0 = inb ? m.out[0][key] : 0;
                    else if (m.kind == K_PERCPU)
                      r0 = inb ? m.out[0][shard * n + key] : 0;
                    else if (m.kind == K_HASH) {
                      const Find f = hash_find(m, key);
                      r0 = f.found ? m.out[2][f.slot] : 0;
                    }
                    break;
                  case H_UPDATE: {
                    const i64 val =
                        word_load(stk, kStackWords, regs[3] - kStackBase, 8);
                    if (m.kind == K_ARRAY) {
                      if (inb) m.out[0][key] = val;
                    } else if (m.kind == K_HASH) {
                      const Find f = hash_find(m, key);
                      if (f.found || f.has_free) {
                        const i64 t = f.found ? f.slot : f.free_slot;
                        m.out[0][t] = key;
                        m.out[1][t] = 1;
                        m.out[2][t] = val;
                      } else {
                        r0 = -7;
                      }
                    }
                    break;
                  }
                  case H_DELETE:
                    if (m.kind == K_HASH) {
                      const Find f = hash_find(m, key);
                      if (f.found)
                        m.out[1][f.slot] = 2;
                      else
                        r0 = -2;
                    }
                    break;
                  case H_FETCH_ADD:
                    if (m.kind == K_ARRAY) {
                      if (inb) {
                        r0 = m.out[0][key];
                        m.out[0][key] = (i64)((u64)r0 + (u64)regs[3]);
                      }
                    } else if (m.kind == K_HASH) {
                      r0 = hash_fetch_add(m, key, regs[3]);
                    }
                    break;
                  case H_PERCPU_FETCH_ADD:
                    if (m.kind == K_PERCPU && inb) {
                      i64* v = m.out[0] + shard * n + key;
                      r0 = *v;
                      *v = (i64)((u64)r0 + (u64)regs[3]);
                    }
                    break;
                  case H_HIST:
                    if (m.kind == K_HIST) m.out[0][log2_bin(regs[2])] += 1;
                    break;
                  default: {  // H_RINGBUF
                    if (m.kind != K_RINGBUF) break;
                    const i64 head = m.out[1][0];
                    i64* row = m.out[0] + (head % n) * m.width;
                    for (i64 c = 0; c < m.width; ++c)
                      row[c] = 8 * c < regs[3]
                                   ? word_load(stk, kStackWords,
                                               regs[2] - kStackBase + 8 * c,
                                               8)
                                   : 0;
                    m.out[1][0] = head + 1;
                    if (head >= n) m.out[2][0] += 1;
                  }
                }
              } else if (hid == H_KTIME) {
                r0 = time_ns;
              } else if (hid == H_CPU) {
                r0 = cpu;
              } else if (hid == H_PID) {
                r0 = pid;
              } else if (hid == H_LOG2) {
                r0 = log2_bin(regs[1]);
              } else if (hid == H_PRANDOM) {
                i64 x = a[A_RAND] & kMask32;
                if (x == 0) x = 1;
                x = (x ^ (x << 13)) & kMask32;
                x = x ^ (x >> 17);
                x = (x ^ (x << 5)) & kMask32;
                a[A_RAND] = x;
                r0 = x;
              } else if (hid == H_PRINTK) {
                const i64 slot = clampi(a[A_PRINTK_N], 0, 7);
                a[A_PRINTK_BUF + 2 * slot] = regs[1];
                a[A_PRINTK_BUF + 2 * slot + 1] = regs[2];
                a[A_PRINTK_N] += 1;
              } else if (hid == H_OVERRIDE) {
                a[A_OVSET] = 1;
                a[A_OVVAL] = regs[1];
              }
              regs[0] = r0;
              for (int r = 1; r <= 5; ++r) regs[r] = 0;
              break;
            }
            default:  // TH_JA (target pre-resolved in tgt), TH_EXIT
              break;
          }
          pc = taken ? field(T, P, N, F_TGT, p, i) : pc + 1;
          fuel -= 1;
          done = hcls == TH_EXIT;
        }
        if (prm.r0 != nullptr) prm.r0[(i64)p * E + e] = regs[0];
      }
    }
  }
  __syncthreads();

  // 3. the vec sub-lane: the lockstep machine, one slot at a time
  const i64 sbase = kStackBase + kStackSize - 8 * kNarrow;
  for (int p = 0; p < P; ++p) {
    if (!meta(T, P, N, M_ACTIVE, p) || !meta(T, P, N, M_VEC, p)) continue;
    const i64 site = meta(T, P, N, M_SITE, p), kind = meta(T, P, N, M_KIND, p);
    for (int b = tid; b < E; b += kThreads) {
      i64* L = prm.lanes + (i64)b * kLaneWords;
      const i64* ctx = prm.rows + (i64)b * cw;
      for (int w = 0; w < kLaneWords; ++w) L[w] = 0;
      L[L_REGS + 1] = kCtxBase;
      L[L_REGS + 10] = kStackBase + kStackSize;
      L[L_FUEL] = meta(T, P, N, M_FUEL, p);
      L[L_DONE] = !(prm.match_all || (ctx[0] == site && ctx[1] == kind));
    }
    __syncthreads();
    while (true) {
      int mine = 0;
      for (int b = tid; b < E; b += kThreads) {
        const i64* L = prm.lanes + (i64)b * kLaneWords;
        mine |= (!L[L_DONE] && L[L_FUEL] > 0);
      }
      if (!__syncthreads_or(mine)) break;
      for (int b = tid; b < E; b += kThreads) {
        i64* L = prm.lanes + (i64)b * kLaneWords;
        if (L[L_DONE] || L[L_FUEL] <= 0) continue;
        i64* regs = L + L_REGS;
        i64* stk = L + L_STACK;
        const i64* ctx = prm.rows + (i64)b * cw;
        const i64 pc = L[L_PC];
        const i64 i = clampi(pc, 0, N - 1);
        const i64 hcls = field(T, P, N, F_HCLS, p, i);
        const i64 dst = clampi(field(T, P, N, F_DST, p, i), 0, 10);
        const i64 src = clampi(field(T, P, N, F_SRC, p, i), 0, 10);
        const i64 off = field(T, P, N, F_OFF, p, i);
        const i64 imm = field(T, P, N, F_IMM, p, i);
        const i64 aluop = field(T, P, N, F_ALUOP, p, i);
        const i64 size = field(T, P, N, F_SIZE, p, i);
        const i64 d = regs[dst], sreg = regs[src];
        const i64 s = field(T, P, N, F_USE_IMM, p, i) != 0 ? imm : sreg;
        bool taken = true;
        if (hcls == TH_ALU64 || hcls == TH_ALU32) {
          regs[dst] = alu(aluop, d, s, hcls == TH_ALU64);
        } else if (hcls == TH_LDDW) {
          regs[dst] = imm;
        } else if (hcls == TH_LDX) {
          const i64 addr = sreg + off;
          regs[dst] = addr >= kCtxBase
                          ? word_load(ctx, cw, addr - kCtxBase, size)
                          : word_load(stk, kNarrow, addr - sbase, size);
        } else if (hcls == TH_ST || hcls == TH_STX) {
          word_store(stk, kNarrow, d + off - sbase, size,
                     hcls == TH_STX ? sreg : imm);
        } else if (hcls == TH_JCOND64 || hcls == TH_JCOND32) {
          taken = jcond(aluop, d, s, hcls == TH_JCOND64);
        } else if (hcls == TH_CALL) {
          // only pure and commutative helpers reach a vec slot
          // (batched_encodable); fetch-add results are dead, so r0 = 0
          const i64 hid = field(T, P, N, F_HID, p, i);
          const i64 r1 = regs[1], r2 = regs[2], r3 = regs[3];
          i64 r0 = 0;
          if (hid == H_KTIME) {
            r0 = time_ns;
          } else if (hid == H_CPU) {
            r0 = cpu;
          } else if (hid == H_PID) {
            r0 = pid;
          } else if (hid == H_LOG2) {
            r0 = log2_bin(r1);
          } else if (nmaps > 0 && (hid == H_FETCH_ADD ||
                                   hid == H_PERCPU_FETCH_ADD ||
                                   hid == H_HIST)) {
            const int fd = (int)clampi(r1, 0, nmaps - 1);
            const MapDesc& m = sh.maps[fd];
            const i64 key = word_load(stk, kNarrow, r2 - sbase, 8);
            const bool inb = key >= 0 && key < m.n;
            if (hid == H_FETCH_ADD && m.kind == K_ARRAY && inb) {
              atomicAdd((u64*)(m.out[0] + key), (u64)r3);
            } else if (hid == H_FETCH_ADD && m.kind == K_HASH) {
              L[L_HREQ] = 1;
              L[L_HFD] = fd;
              L[L_HKEY] = key;
              L[L_HDELTA] = r3;
              sh.hash_pending = 1;
            } else if (hid == H_PERCPU_FETCH_ADD && m.kind == K_PERCPU &&
                       inb) {
              const i64 shard = clampi(cpu, 0, m.shards - 1);
              atomicAdd((u64*)(m.out[0] + shard * m.n + key), (u64)r3);
            } else if (hid == H_HIST && m.kind == K_HIST) {
              atomicAdd((u64*)(m.out[0] + log2_bin(r2)), 1ULL);
            }
          }
          regs[0] = r0;
          for (int r = 1; r <= 5; ++r) regs[r] = 0;
        }
        L[L_PC] = taken ? field(T, P, N, F_TGT, p, i) : pc + 1;
        L[L_FUEL] -= 1;
        if (hcls == TH_EXIT) L[L_DONE] = 1;
      }
      __syncthreads();
      if (tid == 0 && sh.hash_pending) {
        // this machine step's HASH fetch-adds, in lane (= event) order
        for (int b = 0; b < E; ++b) {
          i64* L = prm.lanes + (i64)b * kLaneWords;
          if (!L[L_HREQ]) continue;
          L[L_HREQ] = 0;
          hash_fetch_add(sh.maps[L[L_HFD]], L[L_HKEY], L[L_HDELTA]);
        }
        sh.hash_pending = 0;
      }
      __syncthreads();
    }
    if (prm.r0 != nullptr)
      for (int b = tid; b < E; b += kThreads)
        prm.r0[(i64)p * E + b] = prm.lanes[(i64)b * kLaneWords + L_REGS];
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_table_interp_sizes(int* params_bytes, int* max_maps,
                                        int* lane_words, int* aux_words) {
  *params_bytes = (int)sizeof(Params);
  *max_maps = kMaxMaps;
  *lane_words = kLaneWords;
  *aux_words = A_WORDS;
  return 0;
}

// prm: the launch's parameters in host memory (copied into the launch);
// smem_bytes: the packed table's bytes. Returns the CUDA error of the
// launch (0 = ok).
extern "C" int repro_table_interp(const void* params, int smem_bytes,
                                  void* stream) {
  const Params* prm = static_cast<const Params*>(params);
  static int attr_bytes = 48 * 1024;
  if (smem_bytes > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        table_interp, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem_bytes;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  table_interp<<<1, kThreads, smem_bytes, st>>>(*prm);
  return (int)cudaGetLastError();
}
