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
//   1. the map states and the aux block go in -> out (the step keeps the
//      states it started from);
//   2. the sequential sub-lane: the tape event by event and, within an
//      event, the active slots with vec == 0 in slot order -- fuel-bounded
//      pc loop, the 14 helpers, the map switch, a 512-byte stack;
//   3. the vec sub-lane: for each active slot with vec == 1, in slot order,
//      the lockstep machine over the whole tape, in which lane b runs its
//      own t-th instruction at machine step t. Lanes never read a map
//      (fetch-add results are dead, only pure or commutative helpers reach
//      a vec slot), so the machine's end state is fixed by exact 64-bit
//      adds, which commute, and by the order of the HASH fetch-adds, whose
//      first inserts shape the table: ascending (t, b).
//
// Bound on an H100: latency. The table, the tape and the maps are
// kilobytes; the time is the instruction walk, serial in the sequential
// sub-lane. The design keeps that walk out of device memory:
//   * copy-in decodes the packed table (ten strided fields) into one
//     32-byte record per instruction in shared memory (imm, off, tgt and
//     one word of small fields, the clamps applied once), read with two
//     16-byte loads; one switch on its opcode (class, width and op)
//     dispatches it, the source form is a select; the register file and
//     frame of the sequential sub-lane sit at fixed offsets before the
//     records; the map states and the aux block are loaded into
//     shared memory when they fit beside the records and the lanes (the
//     shared route, `maps_shared`), else they stay in device memory (the
//     global route); the tape is loaded into shared memory when it fits,
//     else thread 0 stages each row ahead of its walk with cp.async into a
//     ring of kRing rows;
//   * thread 0 walks the sequential sub-lane, following the pc as a
//     record index and fetching tgt's record (where every instruction but
//     a JCOND not taken goes next) while it executes an instruction; what
//     bounds it then is the walk's chain of dependent instructions on one
//     thread (nvcc compiles the opcode switch to a compare tree);
//   * each vec lane runs free on its own thread, its registers and narrow
//     stack in shared memory, with no barrier per instruction. A lane pauses
//     only at a HASH fetch-add, at machine step t; when every lane has
//     paused or ended, the block takes the smallest pending t, warp 0
//     applies the requests of that t in lane order (its 32 lanes probe a
//     key's chain 32 slots at a time), and those lanes resume.
//     One barrier round per distinct HASH step; a slot with no HASH call
//     runs every lane to its exit and meets one barrier. With more lanes
//     than threads, a paused lane's state goes to the scratch `lanes` only
//     at those rounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef long long i64;

constexpr int kThreads = 512;
constexpr int kMaxMaps = 24;
constexpr int kFields = 10;      // isa.TABLE_FIELDS
constexpr int kMeta = 6;         // table_interp.META_FIELDS
constexpr int kRecWords = 4;     // a decoded instruction record
constexpr int kLaneWords = 32;   // per-lane scratch of the vec sub-lane
constexpr int kNarrow = 8;       // words of the vec machine's narrow stack
constexpr int kVecWords = 11 + kNarrow;  // a running lane's shared state
constexpr int kStackWords = 64;  // 512-byte frame
constexpr int kRing = 8;         // tape rows staged ahead of the walk
// dynamic shared memory starts with the sequential sub-lane's register
// file (16 words, r0-r10 used) and its frame, then the records
constexpr int kFrameWord = 16;
constexpr int kSeqWords = kFrameWord + kStackWords;

constexpr i64 kStackBase = 0x100000000LL;   // isa.STACK_BASE
constexpr i64 kStackSize = 512;
constexpr i64 kCtxBase = 0x200000000LL;     // isa.CTX_BASE
constexpr u64 kHashMult = 0x9E3779B97F4A7C15ULL;
constexpr i64 kMask32 = 0xFFFFFFFFLL;
constexpr u64 kNone = ~0ULL;                // no pending HASH step

// table field order (isa.TABLE_FIELDS)
enum { F_HCLS, F_DST, F_SRC, F_OFF, F_IMM, F_ALUOP, F_USE_IMM, F_SIZE,
       F_TGT, F_HID };
// meta rows after the fields (table_interp.META_FIELDS)
enum { M_ACTIVE, M_SITE, M_KIND, M_NINSNS, M_FUEL, M_VEC };
// handler classes (isa.TH_*)
enum { TH_ALU64, TH_ALU32, TH_LDDW, TH_LDX, TH_ST, TH_STX, TH_JA,
       TH_JCOND64, TH_JCOND32, TH_CALL, TH_EXIT };
// helper branch index = position in sorted(HELPERS); H_NONE: a vec lane's
// index out of range (no helper)
enum { H_LOOKUP, H_UPDATE, H_DELETE, H_KTIME, H_PRINTK, H_PRANDOM, H_CPU,
       H_PID, H_RINGBUF, H_FETCH_ADD, H_LOG2, H_OVERRIDE, H_HIST,
       H_PERCPU_FETCH_ADD, H_COUNT, H_NONE = 15 };
// map kinds (the wrapper's codes)
enum { K_ARRAY, K_HASH, K_PERCPU, K_HIST, K_RINGBUF };
// lane scratch layout: a paused lane's state, its HASH request, its state
enum { L_REGS = 0, L_STACK = 11, L_PC = 19, L_FUEL = 20, L_STATE = 21,
       L_T = 22, L_FD = 23, L_KEY = 24, L_DELTA = 25 };
// a vec lane's state
enum { S_DONE, S_READY, S_PAUSED, S_FRESH };
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
  i64* lanes;            // i64[E, kLaneWords], then ceil(E / 64) mask words
  i64 P, N, E, ctx_words, nmaps, match_all;
  i64 maps_shared;       // 1: map states in shared memory during the launch
  i64 tape_shared;       // 1: the whole tape in shared memory, 0: a ring
  // word offsets in dynamic shared memory (the records start at kSeqWords)
  i64 sm_meta, sm_slots, sm_lanes, lane_stride, sm_maps, sm_tape;
  MapDesc maps[kMaxMaps];
};

// A decoded instruction: 16-byte aligned, two 16-byte loads.
struct __align__(16) Rec {
  i64 imm, off;
  i64 tgt;
  u64 bits;  // see decode()
};

// ------------------------------------------------------------ arithmetic

__device__ __forceinline__ i64 clampi(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ i64 add64(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}

__device__ __forceinline__ i64 s32view(i64 x) {
  const i64 lo = x & kMask32;
  return (lo >> 31) ? lo - (1LL << 32) : lo;
}

// jit._alu, one op: 32-bit ops work on the low 32 bits and zero-extend
template <int OP, bool IS64>
__device__ __forceinline__ i64 alu(i64 d, i64 s) {
  if (!IS64) {
    d &= kMask32;
    s &= kMask32;
  }
  constexpr u64 bits = IS64 ? 63 : 31;
  const u64 ud = (u64)d, us = (u64)s;
  u64 r;
  if constexpr (OP == 0) r = ud + us;                         // add
  else if constexpr (OP == 1) r = ud - us;                    // sub
  else if constexpr (OP == 2) r = ud * us;                    // mul
  else if constexpr (OP == 3) r = us == 0 ? 0 : ud / us;      // div
  else if constexpr (OP == 4) r = ud | us;                    // or
  else if constexpr (OP == 5) r = ud & us;                    // and
  else if constexpr (OP == 6) r = ud << (us & bits);          // lsh
  else if constexpr (OP == 7) r = ud >> (us & bits);          // rsh
  else if constexpr (OP == 8) r = (u64)0 - ud;                // neg
  else if constexpr (OP == 9) r = us == 0 ? ud : ud % us;     // mod
  else if constexpr (OP == 10) r = ud ^ us;                   // xor
  else if constexpr (OP == 11) r = us;                        // mov
  else r = (u64)((IS64 ? d : s32view(d)) >> (us & bits));     // arsh
  if (!IS64) r &= (u64)kMask32;
  return (i64)r;
}

// jit._jmp_cond, one op, indexed by (op & OP_MASK) >> 4; the ja, call and
// exit slots (0, 8, 9) are never taken
template <int OP, bool IS64>
__device__ __forceinline__ bool jcond(i64 lhs, i64 rhs) {
  const u64 ul = IS64 ? (u64)lhs : (u64)(lhs & kMask32);
  const u64 ur = IS64 ? (u64)rhs : (u64)(rhs & kMask32);
  const i64 sl = IS64 ? lhs : s32view(lhs), sr = IS64 ? rhs : s32view(rhs);
  if constexpr (OP == 1) return ul == ur;         // jeq
  else if constexpr (OP == 2) return ul > ur;     // jgt
  else if constexpr (OP == 3) return ul >= ur;    // jge
  else if constexpr (OP == 4) return (ul & ur) != 0;  // jset
  else if constexpr (OP == 5) return ul != ur;    // jne
  else if constexpr (OP == 6) return sl > sr;     // jsgt
  else if constexpr (OP == 7) return sl >= sr;    // jsge
  else if constexpr (OP == 10) return ul < ur;    // jlt
  else if constexpr (OP == 11) return ul <= ur;   // jle
  else if constexpr (OP == 12) return sl < sr;    // jslt
  else if constexpr (OP == 13) return sl <= sr;   // jsle
  else return false;
}

__device__ __forceinline__ u64 low_mask(i64 nbytes) {
  return nbytes >= 8 ? ~0ULL : ((1ULL << ((8 * nbytes) & 63)) - 1ULL);
}

// jit.dyn_word_load: little-endian `size` bytes at byte offset `off` of
// nwords words `st` apart, word indices clipped as the plain version clips
__device__ __forceinline__ i64 word_load(const i64* w, int st, i64 nwords,
                                         i64 off, i64 size) {
  const i64 w0 = clampi(off >> 3, 0, nwords - 1);
  const i64 w1 = w0 + 1 < nwords ? w0 + 1 : nwords - 1;
  const i64 rb = off & 7;
  const u64 lo = (u64)w[w0 * st] >> (8 * rb);
  const u64 hi = rb == 0 ? 0ULL : (u64)w[w1 * st] << ((64 - 8 * rb) & 63);
  return (i64)((lo | hi) & low_mask(size));
}

// jit.dyn_word_store: read-modify-write of the one or two covering words;
// word1 first, so a clipped w1 == w0 cannot clobber the word0 write
__device__ __forceinline__ void word_store(i64* w, int st, i64 nwords,
                                           i64 off, i64 size, i64 val) {
  const i64 w0 = clampi(off >> 3, 0, nwords - 1);
  const i64 w1 = w0 + 1 < nwords ? w0 + 1 : nwords - 1;
  const i64 rb = off & 7;
  const u64 v = (u64)val & low_mask(size);
  const i64 nb0 = size < 8 - rb ? size : 8 - rb;
  const u64 m0 = low_mask(nb0) << (8 * rb);
  const u64 old0 = (u64)w[w0 * st], old1 = (u64)w[w1 * st];
  const u64 new0 = (old0 & ~m0) | ((v << (8 * rb)) & m0);
  const bool spans = rb + size > 8;
  const i64 nb1 = clampi(rb + size - 8, 0, 7);
  const u64 m1 = (1ULL << (8 * nb1)) - 1ULL;
  const u64 new1 = (old1 & ~m1) | ((v >> ((8 * (8 - rb)) & 63)) & m1);
  w[w1 * st] = (i64)(spans ? new1 : old1);
  w[w0 * st] = (i64)new0;
}

__device__ __forceinline__ i64 log2_bin(i64 v) {
  if (v <= 0) return 0;
  const i64 b = 64 - __clzll(v);
  return b < 63 ? b : 63;
}

// ------------------------------------------------------------ decoding

// Dense opcodes, one switch: ALU and JCOND carry the width and the op,
// base + 16 * (32-bit) + op index; bit 7 of the opcode byte says the
// source is the immediate (K), not src (X).
enum { OP_ALU = 0, OP_JCOND = 32, OP_LDDW = 64, OP_LDX, OP_ST, OP_STX,
       OP_JA, OP_CALL, OP_EXIT, OP_NOP, OP_K = 0x80 };

// Rec.bits: the sequential core's opcode byte (its class clamped), dst and
// src as byte offsets into a register file, the access size code, whether
// tgt is negative, the vec machine's opcode byte (its class matched raw:
// out of range is OP_NOP), the helper index clamped (sequential core) and
// raw, out of range H_NONE (vec machine), and tgt's record index (tgt
// clamped).
enum { B_SOP = 0, B_DST8 = 8, B_SRC8 = 16, B_SIZE = 24, B_TNEG = 29,
       B_VOP = 32, B_HID = 40, B_VHID = 44, B_TGT = 48 };

__device__ __forceinline__ int bf(u64 bits, int at, int width) {
  return (int)((bits >> at) & ((1ULL << width) - 1));
}

__device__ __forceinline__ int opcode(i64 cls, i64 aluop, bool k) {
  const int kb = k ? OP_K : 0;
  switch (cls) {
    case TH_ALU64: return OP_ALU + (int)clampi(aluop, 0, 12) + kb;
    case TH_ALU32: return OP_ALU + 16 + (int)clampi(aluop, 0, 12) + kb;
    case TH_JCOND64: return OP_JCOND + (int)clampi(aluop, 0, 13) + kb;
    case TH_JCOND32: return OP_JCOND + 16 + (int)clampi(aluop, 0, 13) + kb;
    case TH_LDDW: return OP_LDDW;
    case TH_LDX: return OP_LDX;
    case TH_ST: return OP_ST;
    case TH_STX: return OP_STX;
    case TH_JA: return OP_JA;
    case TH_CALL: return OP_CALL;
    case TH_EXIT: return OP_EXIT;
    default: return OP_NOP;
  }
}

// The access size as word_load / word_store read it: they depend only on
// size >= 8, size & 7, and on rb + size against 8 and 15, so sizes from 15
// up act as 15, and negative ones as (size & 7) - 8. Stored + 8 in 5 bits.
__device__ __forceinline__ u64 size_code(i64 size) {
  const i64 c = size >= 15 ? 15 : (size < 0 ? (size & 7) - 8 : size);
  return (u64)(c + 8);
}

__device__ __forceinline__ i64 rec_size(u64 bits) {
  return (i64)bf(bits, B_SIZE, 5) - 8;
}

// instruction idx = p * N + i of the packed table T (field f of it at
// f * P * N + idx)
__device__ __forceinline__ Rec decode(const i64* T, i64 PN, i64 N, i64 idx) {
  const i64 hcls = T[F_HCLS * PN + idx], aluop = T[F_ALUOP * PN + idx];
  const i64 hid = T[F_HID * PN + idx];
  const bool k = T[F_USE_IMM * PN + idx] != 0;
  Rec r;
  r.imm = T[F_IMM * PN + idx];
  r.off = T[F_OFF * PN + idx];
  r.tgt = T[F_TGT * PN + idx];
  r.bits = (u64)opcode(clampi(hcls, 0, TH_EXIT), aluop, k) << B_SOP |
           (u64)(8 * clampi(T[F_DST * PN + idx], 0, 10)) << B_DST8 |
           (u64)(8 * clampi(T[F_SRC * PN + idx], 0, 10)) << B_SRC8 |
           size_code(T[F_SIZE * PN + idx]) << B_SIZE |
           (u64)(r.tgt < 0) << B_TNEG |
           (u64)opcode(hcls, aluop, k) << B_VOP |
           (u64)clampi(r.tgt, 0, N - 1) << B_TGT |
           (u64)clampi(hid, 0, H_COUNT - 1) << B_HID |
           (u64)(hid >= 0 && hid < H_COUNT ? hid : H_NONE) << B_VHID;
  return r;
}

__device__ __forceinline__ Rec fetch_at(const Rec* prog, i64 i) {
  const longlong2* q = reinterpret_cast<const longlong2*>(prog + i);
  const longlong2 a = q[0], b = q[1];
  Rec r;
  r.imm = a.x;
  r.off = a.y;
  r.tgt = b.x;
  r.bits = (u64)b.y;
  return r;
}

__device__ __forceinline__ Rec fetch(const Rec* prog, i64 N, i64 pc) {
  return fetch_at(prog, clampi(pc, 0, N - 1));
}

// The ALU and JCOND cases of a dense opcode switch on the opcode without
// its K bit, for registers written as REG(byte offset) and the operands d
// (dst) and s (the immediate or src); `taken` is set by the JCOND cases.
#define ALU_CASES(REG, n)                                                 \
  case OP_ALU + (n): REG(dst8) = alu<(n), true>(d, s); break;             \
  case OP_ALU + 16 + (n): REG(dst8) = alu<(n), false>(d, s); break;
#define JCOND_CASES(n)                                                    \
  case OP_JCOND + (n): taken = jcond<(n), true>(d, s); break;             \
  case OP_JCOND + 16 + (n): taken = jcond<(n), false>(d, s); break;
#define COMMON_CASES(REG)                                                 \
  ALU_CASES(REG, 0) ALU_CASES(REG, 1) ALU_CASES(REG, 2)                   \
  ALU_CASES(REG, 3) ALU_CASES(REG, 4) ALU_CASES(REG, 5)                   \
  ALU_CASES(REG, 6) ALU_CASES(REG, 7) ALU_CASES(REG, 8)                   \
  ALU_CASES(REG, 9) ALU_CASES(REG, 10) ALU_CASES(REG, 11)                 \
  ALU_CASES(REG, 12)                                                      \
  JCOND_CASES(0) JCOND_CASES(1) JCOND_CASES(2) JCOND_CASES(3)             \
  JCOND_CASES(4) JCOND_CASES(5) JCOND_CASES(6) JCOND_CASES(7)             \
  JCOND_CASES(8) JCOND_CASES(9) JCOND_CASES(10) JCOND_CASES(11)           \
  JCOND_CASES(12) JCOND_CASES(13)                                         \
  case OP_LDDW: REG(dst8) = imm; break;

// ------------------------------------------------------------ map twins

// maps._t_hash_find: probe from the home slot; a match counts only before
// the first EMPTY slot (tombstones keep chains); inserts take the first
// tombstone-or-empty slot.
struct Find {
  i64 slot, free_slot;
  bool found, has_free;
};

__device__ __forceinline__ i64 home_slot(i64 key, i64 n) {
  const u64 h = ((u64)key * kHashMult) >> 33;   // < 2^31
  return n <= kMask32 ? (i64)((unsigned)h % (unsigned)n) : (i64)(h % (u64)n);
}

__device__ __forceinline__ Find hash_find(const MapDesc& m, i64 key) {
  const i64 n = m.n;
  const i64* keys = m.out[0];
  const i64* used = m.out[1];
  const i64 start = home_slot(key, n);
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
__device__ __forceinline__ i64 hash_fetch_add(const MapDesc& m, i64 key,
                                              i64 delta) {
  const Find f = hash_find(m, key);
  i64* vals = m.out[2];
  const i64 old = f.found ? vals[f.slot] : 0;
  if (f.found || f.has_free) {
    const i64 t = f.found ? f.slot : f.free_slot;
    m.out[0][t] = key;
    m.out[1][t] = 1;
    vals[t] = f.found ? add64(vals[f.slot], delta) : delta;
  }
  return old;
}

// ------------------------------------------------------------ the kernel

struct Shared {
  MapDesc maps[kMaxMaps];   // out[] point at shared memory on that route
  i64 aux[A_WORDS];
  u64 tmin[2];              // the smallest pending HASH step, by round
  int nseq;                 // sequential slots, listed at sm_slots
};

// The sequential core on one (event, slot): returns r0. Its register file
// and frame are the first kSeqWords words of dynamic shared memory, read
// at the byte offsets the records carry. The pc is followed as its record
// index: every instruction but a JCOND not taken continues at tgt's
// record, fetched while the instruction executes; a JCOND not taken at the
// next record. Only a negative tgt (a corrupt table) makes the raw pc
// matter, which the slow path then follows until it is 0 again.
__device__ __forceinline__ i64 seq_run(i64* smem, Shared& sh,
                                       const Rec* prog, i64 N, i64 fuel,
                                       const i64* ctx, i64 cw, i64 nmaps) {
  i64* regs = smem;
  i64* frame = smem + kFrameWord;
  char* file = reinterpret_cast<char*>(smem);
  i64* a = sh.aux;
  longlong2* z = reinterpret_cast<longlong2*>(smem);
  for (int i = 0; i < kSeqWords / 2; ++i) z[i] = make_longlong2(0, 0);
  regs[1] = kCtxBase;
  regs[10] = kStackBase + kStackSize;
  const int last = (int)N - 1;
  int idx = 0;        // clamp(pc, 0, N - 1)
  i64 pc = 0;         // the raw pc, followed while it is negative
  bool slow = false;
  Rec cur = fetch_at(prog, 0);
#define SEQ_REG(o) (*reinterpret_cast<i64*>(file + (o)))
  while (fuel > 0) {
    const u64 bits = cur.bits;
    const unsigned lo = (unsigned)bits;
    const int op = lo & 0x7f;
    const int dst8 = (lo >> B_DST8) & 0xff, src8 = (lo >> B_SRC8) & 0xff;
    const Rec taken_rec = fetch_at(prog, (int)(bits >> B_TGT));
    const i64 d = SEQ_REG(dst8), sreg = SEQ_REG(src8), imm = cur.imm;
    const i64 s = (lo & OP_K) ? imm : sreg;
    bool taken = true;
    fuel -= 1;
    switch (op) {
      COMMON_CASES(SEQ_REG)
      case OP_LDX: {
        const i64 addr = add64(sreg, cur.off);
        SEQ_REG(dst8) = addr >= kCtxBase
                            ? word_load(ctx, 1, cw, addr - kCtxBase,
                                        rec_size(bits))
                            : word_load(frame, 1, kStackWords,
                                        addr - kStackBase, rec_size(bits));
        break;
      }
      case OP_ST:
      case OP_STX:
        word_store(frame, 1, kStackWords, add64(d, cur.off) - kStackBase,
                   rec_size(bits), op == OP_STX ? sreg : imm);
        break;
      case OP_CALL: {
        const int hid = bf(bits, B_HID, 4);
        const bool mapped = hid == H_LOOKUP || hid == H_UPDATE ||
                            hid == H_DELETE || hid == H_FETCH_ADD ||
                            hid == H_PERCPU_FETCH_ADD || hid == H_HIST ||
                            hid == H_RINGBUF;
        i64 r0 = 0;
        if (mapped && nmaps > 0) {
          const MapDesc& m = sh.maps[clampi(regs[1], 0, nmaps - 1)];
          const i64 key =
              word_load(frame, 1, kStackWords, regs[2] - kStackBase, 8);
          const i64 n = m.n;
          const bool inb = key >= 0 && key < n;
          const i64 shard = clampi(a[A_CPU], 0, m.shards - 1);
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
                  word_load(frame, 1, kStackWords, regs[3] - kStackBase, 8);
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
                  m.out[0][key] = add64(r0, regs[3]);
                }
              } else if (m.kind == K_HASH) {
                r0 = hash_fetch_add(m, key, regs[3]);
              }
              break;
            case H_PERCPU_FETCH_ADD:
              if (m.kind == K_PERCPU && inb) {
                i64* v = m.out[0] + shard * n + key;
                r0 = *v;
                *v = add64(r0, regs[3]);
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
                             ? word_load(frame, 1, kStackWords,
                                         regs[2] - kStackBase + 8 * c, 8)
                             : 0;
              m.out[1][0] = head + 1;
              if (head >= n) m.out[2][0] += 1;
            }
          }
        } else if (hid == H_KTIME) {
          r0 = a[A_TIME];
        } else if (hid == H_CPU) {
          r0 = a[A_CPU];
        } else if (hid == H_PID) {
          r0 = a[A_PID];
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
      case OP_EXIT:
        return regs[0];
      default:  // OP_JA (target pre-resolved in tgt)
        break;
    }
    if (taken) {
      idx = (int)(bits >> B_TGT);
      slow = (lo >> B_TNEG) & 1;
      if (slow) pc = cur.tgt;
      cur = taken_rec;
    } else {
      if (slow) {
        pc += 1;              // negative: clamp(pc + 1) is 0
        slow = pc < 0;
        idx = 0;
      } else {
        idx = idx < last ? idx + 1 : last;
      }
      cur = fetch_at(prog, idx);
    }
  }
#undef SEQ_REG
  return regs[0];
}

struct VecEnv {
  const Rec* prog;
  i64 N, fuel0, cw, nmaps, time_ns, cpu, pid;
  int st;  // words between one lane word and the next (lane_stride)
};

// One vec lane from (pc, fuel) until it exits, runs out of fuel (returns
// S_DONE) or makes a HASH fetch-add (returns S_PAUSED with the request and
// its machine step in L; the call itself has completed). R: the lane's
// registers R[r * st], then its narrow stack.
__device__ __forceinline__ int vec_run(const VecEnv& v, Shared& sh, i64* R,
                                       const i64* ctx, i64& pc, i64& fuel,
                                       i64* L) {
  const int st = v.st;
  i64* K = R + 11 * st;
  const i64 sbase = kStackBase + kStackSize - 8 * kNarrow;
#define VEC_REG(o) R[((o) >> 3) * st]
  while (fuel > 0) {
    const Rec cur = fetch(v.prog, v.N, pc);
    const u64 bits = cur.bits;
    const int vop = bf(bits, B_VOP, 8), op = vop & 0x7f;
    const int dst8 = bf(bits, B_DST8, 8), src8 = bf(bits, B_SRC8, 8);
    const i64 d = VEC_REG(dst8), sreg = VEC_REG(src8), imm = cur.imm;
    const i64 s = (vop & OP_K) ? imm : sreg;
    bool taken = true, pause = false;
    switch (op) {
      COMMON_CASES(VEC_REG)
      case OP_LDX: {
        const i64 addr = add64(sreg, cur.off);
        VEC_REG(dst8) = addr >= kCtxBase
                            ? word_load(ctx, 1, v.cw, addr - kCtxBase,
                                        rec_size(bits))
                            : word_load(K, st, kNarrow, addr - sbase,
                                        rec_size(bits));
        break;
      }
      case OP_ST:
      case OP_STX:
        word_store(K, st, kNarrow, add64(d, cur.off) - sbase,
                   rec_size(bits), op == OP_STX ? sreg : imm);
        break;
      case OP_CALL: {
        // only pure and commutative helpers reach a vec slot
        // (batched_encodable); fetch-add results are dead, so r0 = 0
        const int hid = bf(bits, B_VHID, 4);
        const i64 r1 = R[1 * st], r2 = R[2 * st], r3 = R[3 * st];
        i64 r0 = 0;
        if (hid == H_KTIME) {
          r0 = v.time_ns;
        } else if (hid == H_CPU) {
          r0 = v.cpu;
        } else if (hid == H_PID) {
          r0 = v.pid;
        } else if (hid == H_LOG2) {
          r0 = log2_bin(r1);
        } else if (v.nmaps > 0 && (hid == H_FETCH_ADD ||
                                   hid == H_PERCPU_FETCH_ADD ||
                                   hid == H_HIST)) {
          const int fd = (int)clampi(r1, 0, v.nmaps - 1);
          const MapDesc& m = sh.maps[fd];
          const i64 key = word_load(K, st, kNarrow, r2 - sbase, 8);
          const bool inb = key >= 0 && key < m.n;
          if (hid == H_FETCH_ADD && m.kind == K_ARRAY && inb) {
            atomicAdd((u64*)(m.out[0] + key), (u64)r3);
          } else if (hid == H_FETCH_ADD && m.kind == K_HASH) {
            L[L_T] = v.fuel0 - fuel;
            L[L_FD] = fd;
            L[L_KEY] = key;
            L[L_DELTA] = r3;
            pause = true;
          } else if (hid == H_PERCPU_FETCH_ADD && m.kind == K_PERCPU &&
                     inb) {
            const i64 shard = clampi(v.cpu, 0, m.shards - 1);
            atomicAdd((u64*)(m.out[0] + shard * m.n + key), (u64)r3);
          } else if (hid == H_HIST && m.kind == K_HIST) {
            atomicAdd((u64*)(m.out[0] + log2_bin(r2)), 1ULL);
          }
        }
        R[0] = r0;
        for (int r = 1; r <= 5; ++r) R[r * st] = 0;
        break;
      }
      default:  // OP_JA, OP_EXIT, OP_NOP (a class out of range)
        break;
    }
#undef VEC_REG
    pc = taken ? cur.tgt : add64(pc, 1);
    fuel -= 1;
    if (op == OP_EXIT) return S_DONE;
    if (pause) return S_PAUSED;
  }
  return S_DONE;
}

// maps.t_hash_fetch_add with pred = True by a whole warp: the lanes probe
// 32 slots of the chain at a time (the same first match before the first
// empty slot, and first free slot, as hash_find), lane 0 writes.
__device__ __forceinline__ void warp_hash_fetch_add(const MapDesc& m,
                                                    i64 key, i64 delta,
                                                    int lane) {
  const i64 n = m.n;
  const i64* keys = m.out[0];
  const i64* used = m.out[1];
  const i64 start = home_slot(key, n);
  i64 fm = n, ff = n, fe = n;
  for (i64 base = 0; base < n; base += 32) {
    const i64 i = base + lane;
    bool in = i < n, hit = false, empty = false, taken_slot = false;
    if (in) {
      i64 s = start + i;
      if (s >= n) s -= n;
      const i64 u = used[s];
      taken_slot = u == 1;
      hit = taken_slot && keys[s] == key;
      empty = u == 0;
    }
    const unsigned bh = __ballot_sync(0xffffffffu, hit);
    const unsigned bfree = __ballot_sync(0xffffffffu, in && !taken_slot);
    const unsigned be = __ballot_sync(0xffffffffu, empty);
    if (fm == n && bh) fm = base + __ffs(bh) - 1;
    if (ff == n && bfree) ff = base + __ffs(bfree) - 1;
    if (be) {
      fe = base + __ffs(be) - 1;
      break;
    }
  }
  if (lane == 0) {
    const bool found = fm < n && fm < fe, has_free = ff < n;
    if (found || has_free) {
      i64 t = start + (found ? fm : ff);
      if (t >= n) t -= n;
      i64* vals = m.out[2];
      m.out[0][t] = key;
      m.out[1][t] = 1;
      vals[t] = found ? add64(vals[t], delta) : delta;
    }
  }
  __syncwarp();
}

// Warp 0: the HASH requests of the lanes marked in `mask` (ceil(E / 64)
// words), in lane order, then the mask cleared.
__device__ __forceinline__ void hash_round(Shared& sh, const i64* lanes,
                                           u64* mask, i64 E) {
  const int lane = threadIdx.x & 31;
  const i64 words = (E + 63) / 64;
  for (i64 w = 0; w < words; ++w) {
    const u64 bits = mask[w];
    if (bits == 0) continue;
    for (int h = 0; h < 2; ++h) {
      unsigned hb = (unsigned)(bits >> (32 * h));
      if (hb == 0) continue;
      const i64 b = w * 64 + 32 * h + lane;
      i64 key = 0, delta = 0, fd = 0;
      if ((hb >> lane) & 1) {
        const i64* L = lanes + b * kLaneWords;
        fd = L[L_FD];
        key = L[L_KEY];
        delta = L[L_DELTA];
      }
      while (hb) {
        const int j = __ffs(hb) - 1;
        hb &= hb - 1;
        const i64 k = __shfl_sync(0xffffffffu, key, j);
        const i64 dl = __shfl_sync(0xffffffffu, delta, j);
        const int f = (int)__shfl_sync(0xffffffffu, fd, j);
        warp_hash_fetch_add(sh.maps[f], k, dl, lane);
      }
    }
    if (lane == 0) mask[w] = 0;
    __syncwarp();
  }
}

__device__ __forceinline__ void cp_async8(i64* dst, const i64* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
table_interp(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) i64 smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const i64 P = prm.P, N = prm.N, E = prm.E, cw = prm.ctx_words;
  const i64 nmaps = prm.nmaps, PN = P * N;

  // 1. copy-in: records, meta, map descriptors, aux, map states, tape
  Rec* rec = reinterpret_cast<Rec*>(smem + kSeqWords);
  i64* meta = smem + prm.sm_meta;
  for (i64 i = tid; i < PN; i += kThreads)
    rec[i] = decode(prm.table, PN, N, i);
  for (i64 i = tid; i < kMeta * P; i += kThreads)
    meta[i] = prm.table[kFields * PN + i];
  if (tid < nmaps) {
    MapDesc d = prm.maps[tid];
    if (prm.maps_shared) {
      i64 off = prm.sm_maps;
      for (int m = 0; m < tid; ++m)
        off += prm.maps[m].len[0] + prm.maps[m].len[1] + prm.maps[m].len[2];
      for (int f = 0; f < 3; ++f) {
        d.out[f] = smem + off;
        off += d.len[f];
      }
    }
    sh.maps[tid] = d;
  }
  if (tid == 0) {
    i64* a = sh.aux;
    for (int j = 0; j < 6; ++j) a[A_TIME + j] = *prm.aux_in[j];
    for (int i = 0; i < 16; ++i) a[A_PRINTK_BUF + i] = prm.aux_in[6][i];
    a[A_PRINTK_N] = *prm.aux_in[7];
    sh.tmin[0] = sh.tmin[1] = kNone;
  }
  u64* mask = reinterpret_cast<u64*>(prm.lanes + E * kLaneWords);
  for (i64 i = tid; i < (E + 63) / 64; i += kThreads) mask[i] = 0;
  i64* tape = smem + prm.sm_tape;
  if (prm.tape_shared)
    for (i64 i = tid; i < E * cw; i += kThreads) tape[i] = prm.rows[i];
  __syncthreads();
  for (int m = 0; m < nmaps; ++m)
    for (int f = 0; f < 3; ++f) {
      const MapDesc& d = sh.maps[m];
      for (i64 i = tid; i < d.len[f]; i += kThreads) d.out[f][i] = d.in[f][i];
    }
  if (tid == 0) {
    // the sequential slots, in slot order: (p, site, kind, fuel)
    i64* sl = smem + prm.sm_slots;
    int n = 0;
    for (i64 p = 0; p < P; ++p)
      if (meta[M_ACTIVE * P + p] && !meta[M_VEC * P + p]) {
        sl[4 * n] = p;
        sl[4 * n + 1] = meta[M_SITE * P + p];
        sl[4 * n + 2] = meta[M_KIND * P + p];
        sl[4 * n + 3] = meta[M_FUEL * P + p];
        ++n;
      }
    sh.nseq = n;
  }
  __syncthreads();

  // 2. the sequential sub-lane, thread 0, in tape order
  if (tid == 0 && sh.nseq > 0) {
    const i64* sl = smem + prm.sm_slots;
    const int nseq = sh.nseq;
    const bool ring = !prm.tape_shared;
    if (ring)
      for (i64 j = 0; j < kRing; ++j) {
        if (j < E)
          for (i64 c = 0; c < cw; ++c)
            cp_async8(tape + j * cw + c, prm.rows + j * cw + c);
        cp_async_commit();
      }
    for (i64 e = 0; e < E; ++e) {
      i64* ctx = tape + (ring ? (e % kRing) : e) * cw;
      if (ring) cp_async_wait<kRing - 1>();
      for (int q = 0; q < nseq; ++q) {
        const i64 p = sl[4 * q];
        if (!prm.match_all && (ctx[0] != sl[4 * q + 1] ||
                               ctx[1] != sl[4 * q + 2]))
          continue;
        const i64 r0 = seq_run(smem, sh, rec + p * N, N, sl[4 * q + 3], ctx,
                               cw, nmaps);
        if (prm.r0 != nullptr) prm.r0[p * E + e] = r0;
      }
      if (ring) {
        if (e + kRing < E)
          for (i64 c = 0; c < cw; ++c)
            cp_async8(ctx + c, prm.rows + (e + kRing) * cw + c);
        cp_async_commit();
      }
    }
    if (ring) cp_async_wait<0>();
  }
  __syncthreads();

  // 3. the vec sub-lane, slot by slot: every lane runs free; rounds apply
  // the HASH fetch-adds in (machine step, lane) order
  const bool multi = E > kThreads;
  const int st = (int)prm.lane_stride;
  i64* R = smem + prm.sm_lanes + tid;
  int parity = 0;
  for (i64 p = 0; p < P; ++p) {
    if (meta[M_ACTIVE * P + p] && meta[M_VEC * P + p]) {
      const VecEnv v{rec + p * N, N, meta[M_FUEL * P + p], cw, nmaps,
                     sh.aux[A_TIME], sh.aux[A_CPU], sh.aux[A_PID], st};
      const i64 site = meta[M_SITE * P + p], kind = meta[M_KIND * P + p];
      // a thread's one lane (E <= kThreads) keeps its state here across
      // rounds; with more lanes, in the scratch
      int state = S_FRESH;
      i64 pc = 0, fuel = 0;
      u64 t_pend = kNone;
      for (bool first = true;; first = false) {
        u64 my_min = kNone;
        for (i64 b = tid; b < E; b += kThreads) {
          i64* L = prm.lanes + b * kLaneWords;
          const i64* row = prm.tape_shared ? tape + b * cw : prm.rows + b * cw;
          int s = multi ? (first ? S_FRESH : (int)L[L_STATE]) : state;
          if (s == S_PAUSED) {
            const u64 t = multi ? (u64)L[L_T] : t_pend;
            my_min = t < my_min ? t : my_min;
            continue;
          }
          if (s == S_DONE) continue;
          if (s == S_FRESH) {
            if (!prm.match_all && (row[0] != site || row[1] != kind)) {
              if (multi)
                L[L_STATE] = S_DONE;
              else
                state = S_DONE;
              continue;
            }
            for (int w = 0; w < kVecWords; ++w) R[w * st] = 0;
            R[1 * st] = kCtxBase;
            R[10 * st] = kStackBase + kStackSize;
            pc = 0;
            fuel = v.fuel0;
          } else if (multi) {  // resumed after a round: reload
            for (int w = 0; w < kVecWords; ++w) R[w * st] = L[L_REGS + w];
            pc = L[L_PC];
            fuel = L[L_FUEL];
          }
          s = vec_run(v, sh, R, row, pc, fuel, L);
          if (s == S_DONE) {
            if (prm.r0 != nullptr) prm.r0[p * E + b] = R[0];
          } else {
            const u64 t = (u64)L[L_T];
            my_min = t < my_min ? t : my_min;
            if (multi) {
              for (int w = 0; w < kVecWords; ++w) L[L_REGS + w] = R[w * st];
              L[L_PC] = pc;
              L[L_FUEL] = fuel;
            } else {
              t_pend = t;
            }
          }
          if (multi)
            L[L_STATE] = s;
          else
            state = s;
        }
        if (my_min != kNone) atomicMin(&sh.tmin[parity], my_min);
        __syncthreads();
        const u64 tmin = sh.tmin[parity];
        if (tmin == kNone) break;    // every lane has ended
        // the lanes paused at tmin resume after the round
        for (i64 b = tid; b < E; b += kThreads) {
          i64* L = prm.lanes + b * kLaneWords;
          const int s = multi ? (int)L[L_STATE] : state;
          const u64 t = multi ? (u64)L[L_T] : t_pend;
          if (s == S_PAUSED && t == tmin) {
            atomicOr(mask + (b >> 6), 1ULL << (b & 63));
            if (multi)
              L[L_STATE] = S_READY;
            else
              state = S_READY;
          }
        }
        __syncthreads();
        if (tid < 32) {
          hash_round(sh, prm.lanes, mask, E);
          if (tid == 0) sh.tmin[parity] = kNone;
        }
        parity ^= 1;
        __syncthreads();
      }
      parity ^= 1;
    }
  }

  // 4. copy-out: the shared route's map states and the aux block
  if (prm.maps_shared)
    for (int m = 0; m < nmaps; ++m)
      for (int f = 0; f < 3; ++f) {
        const MapDesc& d = sh.maps[m];
        i64* out = prm.maps[m].out[f];
        for (i64 i = tid; i < d.len[f]; i += kThreads) out[i] = d.out[f][i];
      }
  for (int i = tid; i < A_WORDS; i += kThreads) prm.aux_out[i] = sh.aux[i];
}

}  // namespace

extern "C" int repro_table_interp_sizes(int* params_bytes, int* max_maps,
                                        int* lane_words, int* aux_words,
                                        int* threads, int* vec_words,
                                        int* ring_rows, int* rec_words,
                                        int* seq_words) {
  *params_bytes = (int)sizeof(Params);
  *max_maps = kMaxMaps;
  *lane_words = kLaneWords;
  *aux_words = A_WORDS;
  *threads = kThreads;
  *vec_words = kVecWords;
  *ring_rows = kRing;
  *rec_words = kRecWords;
  *seq_words = kSeqWords;
  return 0;
}

// prm: the launch's parameters in host memory (copied into the launch);
// smem_bytes: the dynamic shared memory the wrapper planned. Returns the
// CUDA error of the launch (0 = ok).
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
