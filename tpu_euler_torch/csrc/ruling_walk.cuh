// Per-slot and per-element functions of the ruling walk's round and of the
// pointer-jump doubling, shared by the CUDA kernels (ruling_walk.cu) and by
// the host build that the CPU tests load (ruling_walk_host.cpp, g++). Every
// value is an int64, as in the port's tensors; -1 is "none" for pointers
// and element ids, INT64_MAX (keys.SENT) the sentinel key.
//
// walk_slot is one lane of the reference's lockstep walk
// (tpu_euler/euler/ranking.py:135-256 _walk_round, the while_loop at :228),
// run to its end by one thread. That equals the lockstep loop because each
// element has at most one predecessor in a unitig successor array: a walk
// writes owner words only inside its own sublist and patches succ2 only at
// its own last element, so the order of hops across threads changes no
// output.
//
// jump_rounds is every round of one of the reference's doubling
// fori_loops, min-propagating (ranking.py:351 _contracted_cycle_min,
// unitigs.py:170 cut_cycles_from_t), weighted Wyllie (ranking.py:373
// _contracted_rank, :561 _patch_rank, unitigs.py:59 wyllie_rank) or the
// tour's labels (tour.py:90-124 _labels, the fori_loop at :115), over the
// elements first, first + stride, ..., with a barrier of every thread
// between passes. The state is kept as records (MinRec, RankRec, LabelRec),
// so the gather of an element's successor reads one sector; a round reads
// the old records and writes the other buffer, so its semantics are the
// synchronous ones.
//
// cut_lane and cut_unpack are the cut tables' fold of one cut lane into
// its ruler's slot and the unpacking of one slot (at the end of the file).

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace ruling_walk {

using i64 = long long;
constexpr i64 kSent = INT64_MAX;
constexpr i64 kLow32 = 0xffffffffLL;

// One walk round from frontier[0, s_cap): owner words, the succ2 patch,
// the ruler tables' rows [base, base + s_cap) and each slot's continuation.
// Without the minimum succ2 is an array; with it, the [E + 1, 2] record
// that holds succ2 in word 0 and the transition key t in word 1, so a hop
// reads both in one 16-byte load, one sector.
struct WalkArgs {
  i64* succ2;            // succ, -1 at a chain end, -2 - succ where succ is a ruler; [E + 1] or [E + 1, 2]
  const i64* frontier;   // [s_cap] element ids, -1 padded
  i64* owner_off;        // [E + 1] gid << 8 | hop offset
  i64* elem;             // ruler tables, written at base + s
  i64* next_r;
  i64* end_e;
  i64* hops;
  i64* mmin;             // null without the minimum
  i64* cont;             // [s_cap]: the continuation element, -1 for none
  i64 base;              // gid of slot 0
  int walk_cap;          // hops a round
};

// element x's succ2 word
template <bool TrackMin>
__host__ __device__ inline i64& succ2_at(const WalkArgs& a, i64 x) { return a.succ2[TrackMin ? 2 * x : x]; }

// succ2[x] into raw and, with the minimum, t[x] into tx
template <bool TrackMin>
__host__ __device__ inline void read_hop(const WalkArgs& a, i64 x, i64& raw, i64& tx) {
  if (TrackMin) {
#ifdef __CUDA_ARCH__
    const longlong2 v = *reinterpret_cast<const longlong2*>(a.succ2 + 2 * x);
    raw = v.x;
    tx = v.y;
#else
    raw = a.succ2[2 * x];
    tx = a.succ2[2 * x + 1];
#endif
  } else {
    raw = a.succ2[x];
  }
}

// Slot s's walk, run to its end by one thread: from its ruler along succ2
// until a ruler, a chain end or walk_cap hops; the owner words on its way,
// its row of the tables, the succ2 patch and its continuation.
template <bool TrackMin>
__host__ __device__ inline void walk_slot(const WalkArgs& a, i64 s) {
  const i64 f = a.frontier[s];
  i64 next_r = -1, end_e = -1, hops = 0, mmin = kSent, cont = -1;
  if (f >= 0) {
    const i64 gid = a.base + s;
    a.owner_off[f] = gid << 8;  // a ruler owns itself at offset 0
    i64 x = f, raw = 0, step = 0;
    read_hop<TrackMin>(a, f, raw, mmin);
    bool stopped = false;
    for (int it = 0; it < a.walk_cap; ++it) {
      if (raw <= -2) {  // the next element is a ruler
        next_r = -2 - raw;
        hops = step + 1;
        stopped = true;
        break;
      }
      if (raw == -1) {  // x ends its chain
        end_e = x;
        hops = step;
        stopped = true;
        break;
      }
      ++step;
      x = raw;
      a.owner_off[x] = (gid << 8) | step;
      i64 tx = kSent;
      read_hop<TrackMin>(a, x, raw, tx);
      if (TrackMin) mmin = tx < mmin ? tx : mmin;
    }
    if (!stopped) {  // alive at the cap: classified as the reference does (:230-248)
      if (raw <= -2) {
        next_r = -2 - raw;
        hops = step + 1;
      } else if (raw == -1) {
        end_e = x;
        hops = step;
      } else {  // raw becomes next round's virtual ruler; later walks stop before it
        next_r = raw;
        hops = step + 1;
        succ2_at<TrackMin>(a, x) = -2 - raw;
        cont = raw;
      }
    }
  }
  const i64 row = a.base + s;
  a.elem[row] = f;
  a.next_r[row] = next_r;
  a.end_e[row] = end_e;
  a.hops[row] = hops;
  if (TrackMin) a.mmin[row] = mmin;
  a.cont[s] = cont;
}

__host__ __device__ inline i64 clamp_slot(i64 p, i64 n) { return p < 0 ? 0 : (p > n - 1 ? n - 1 : p); }

// The state of one doubling: n elements, the input arrays (p, m) or
// (p, d, q), the output arrays, two record buffers of n records, rounds;
// the labels' doubling reads (succ) and the valid bytes, and writes (label)
// and the on-cycle bytes.
struct JumpArgs {
  const i64* in[3];
  i64* out[3];
  void* buf[2];
  i64 n;
  int rounds;
  const uint8_t* valid;
  uint8_t* on_cycle;
};

// min-propagating: m' = min(m, alive ? m[p] : SENT), p' = alive ? p[p] : -1
struct alignas(16) MinRec {
  i64 p, m;

  __host__ __device__ static MinRec load(const JumpArgs& a, i64 i) { return {a.in[0][i], a.in[1][i]}; }
  __host__ __device__ void store(const JumpArgs& a, i64 i) const {
    a.out[0][i] = p;
    a.out[1][i] = m;
  }
  __host__ __device__ MinRec step(const MinRec* s, i64 n) const {
    if (p < 0) return {-1, m};
    const MinRec o = s[clamp_slot(p, n)];
    return {o.p, o.m < m ? o.m : m};
  }
};

// weighted Wyllie: with idx = alive ? p : own index, p' = alive ? p[idx] :
// -1, d' = d + (alive ? d[idx] : 0), q' = q[idx]; padded to one sector
struct alignas(32) RankRec {
  i64 p, d, q, pad;

  __host__ __device__ static RankRec load(const JumpArgs& a, i64 i) { return {a.in[0][i], a.in[1][i], a.in[2][i], 0}; }
  __host__ __device__ void store(const JumpArgs& a, i64 i) const {
    a.out[0][i] = p;
    a.out[1][i] = d;
    a.out[2][i] = q;
  }
  __host__ __device__ RankRec step(const RankRec* s, i64 n) const {
    if (p < 0) return {-1, d, q, 0};
    const RankRec o = s[clamp_slot(p, n)];
    return {o.p, d + o.d, o.q, 0};
  }
};

// The tour's labels, with the reference's initial state and final select
// fused in: from succ (-1 for none), p = succ, m = own id, q = succ >= 0 ?
// succ : own id; a round, with idx = alive ? p : own id, p' = alive ? p[idx]
// : -1, m' = min(m, m[idx]) where alive (m < n, so the reference's sentinel
// n never wins), q' = q[idx]; at the end on_cycle = p >= 0 && valid and
// label = valid ? (on_cycle ? m : n + q) : 2n. 16 bytes: p, then m << 32 |
// q (m and q are below n < 2^31), the minimum taken of the high halves; a
// 32-byte (p, m, q, pad) record was slower (PERF.md section 6, row 9).
struct alignas(16) LabelRec {
  i64 p, mq;

  __host__ __device__ static LabelRec load(const JumpArgs& a, i64 i) {
    const i64 s = a.in[0][i];
    return {s, (i << 32) | (s >= 0 ? s : i)};
  }
  __host__ __device__ void store(const JumpArgs& a, i64 i) const {
    const bool valid = a.valid[i] != 0;
    const bool cyc = p >= 0 && valid;
    a.out[0][i] = !valid ? 2 * a.n : (cyc ? mq >> 32 : a.n + (mq & kLow32));
    a.on_cycle[i] = cyc;
  }
  __host__ __device__ LabelRec step(const LabelRec* s, i64 n) const {
    if (p < 0) return {-1, mq};
    const LabelRec o = s[clamp_slot(p, n)];
    const i64 m = mq >> 32, om = o.mq >> 32;
    return {o.p, ((om < m ? om : m) << 32) | (o.mq & kLow32)};
  }
};

// Every round of one doubling over elements first, first + stride, ...:
// pack the inputs into buf[0]; round r reads buf[r % 2] and writes
// buf[(r + 1) % 2], the last round the output arrays; sync() is a barrier
// of every thread that runs it. No round: the packed state goes straight
// to the outputs, and the buffers are not touched.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Rec, class Sync>
__host__ __device__ inline void jump_rounds(const JumpArgs& a, i64 first, i64 stride, Sync sync) {
  if (a.rounds == 0) {
    for (i64 i = first; i < a.n; i += stride) Rec::load(a, i).store(a, i);
    return;
  }
  Rec* bufs[2] = {static_cast<Rec*>(a.buf[0]), static_cast<Rec*>(a.buf[1])};
  for (i64 i = first; i < a.n; i += stride) bufs[0][i] = Rec::load(a, i);
  for (int r = 0; r < a.rounds; ++r) {
    sync();
    const Rec* src = bufs[r & 1];
    Rec* dst = bufs[(r + 1) & 1];
    if (r + 1 < a.rounds) {
      for (i64 i = first; i < a.n; i += stride) dst[i] = src[i].step(src, a.n);
    } else {
      for (i64 i = first; i < a.n; i += stride) src[i].step(src, a.n).store(a, i);
    }
  }
}

// ---------------------------------------------------------------------------
// The tour's labels by a ruling set (ruling_labels in ruling_walk.cu): the
// same function as LabelRec's doubling at log2_ceil(n) + 1 rounds, where it
// has converged: a cycle's elements carry the smallest id on the cycle and
// on_cycle (where valid), a path's elements n + the id of its last element,
// invalid elements 2n. succ is injective (each element has at most one
// predecessor), so the elements form disjoint paths and cycles.
//
// label_count (one cooperative launch): the has-predecessor bits, and the
// rulers counted: every element that starts a path and a hash sample of
// the ids with a predecessor (mix32(id) < sample_below). The caller reads the count (and the
// bad-input flag) and sizes the ruler rows. label_walk (one cooperative
// launch): each thread claims slots for its rulers and walks each ruler's
// sublist to the next ruler or the path's end, writing the 32-bit owner slot
// of every element on its way and the ruler's row (next ruler, the sublist's
// smallest id, or n + the path's end); a doubling over the rows alone; one
// gather back from each element's row. A walk reaches only elements with a
// predecessor, so it stops where the hash samples: it reads no ruler flag.
// Elements that no walk covered lie on cycles that the sample missed; they
// are resolved by a doubling in place over their label words, (m << 32 | p),
// which is exact in any order of updates: an element's word always holds
// the minimum over the ids from itself up to (not including) p.
//
// Ctx is the threads that run it: LabelGrid in ruling_walk.cu (a cooperative
// grid), HostLabelCtx in ruling_walk_host.cpp (one thread). It gives first
// and stride (this thread's elements), sync() (a barrier of every thread),
// now() (ns), add / max (every thread's value summed or maximized into a
// word), claim (each thread's first of v slots taken from a counter),
// mark (sets a bit, returns whether it was set) and load (a read of a word
// that another thread may have written since the last barrier). Each thread
// calls add, max and claim once where it calls them at all.

constexpr int kLabelRulers = 0;     // stats words: rulers counted by label_count
constexpr int kLabelBad = 1;        //   nonzero where succ is out of range or has a repeated value
constexpr int kLabelSlots = 2;      //   slots claimed by label_walk (= rulers)
constexpr int kLabelUncovered = 3;  //   elements no walk covered (on cycles with no ruler)
constexpr int kLabelLongest = 4;    //   elements of the longest sublist
constexpr int kLabelStamp = 5;      //   kLabelStamps ns stamps at the phases' ends
constexpr int kLabelStamps = 10;
constexpr int kLabelStats = kLabelStamp + kLabelStamps;

// A ruler's row: the next ruler (its element id after the walk, its slot
// from then on; -1 where the sublist ends a path) and v, the smallest id on
// the sublist, or n + the path's last element where it ends one.
struct alignas(8) LabelRow {
  int32_t p;
  uint32_t v;
};

struct LabelArgs {
  const i64* succ;      // [n], -1 (any negative) for none
  const uint8_t* valid;  // [n] bytes
  i64* label;           // [n]
  uint8_t* on_cycle;    // [n] bytes
  uint32_t* bits;       // [ceil(n / 32)] has-predecessor bits
  int32_t* owner;       // [n] the slot of each element's ruler, -1 for none
  LabelRow* rows[2];    // [rulers] each: the walk's rows, then the doubling's other buffer
  i64* stats;           // [kLabelStats]
  i64 n;
  uint64_t sample_below;  // the ruler sample: mix32(id) < sample_below
};

// murmur3's 32-bit finalizer (keys._mix32)
__host__ __device__ inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__host__ __device__ inline int log2_ceil(i64 n) {
  int b = 0;
  while ((1LL << b) < n) ++b;
  return b < 1 ? 1 : b;
}

__host__ __device__ inline bool label_sampled(const LabelArgs& a, i64 x) { return mix32((uint32_t)x) < a.sample_below; }

// A ruler: an element with a predecessor that the hash samples, or one
// with none that starts a path. An element with neither predecessor nor
// successor is no ruler: its label is fixed (the gather writes it), and
// succ is read only for the elements without a predecessor.
__host__ __device__ inline bool label_ruler(const LabelArgs& a, i64 x) {
  return (a.bits[x >> 5] >> (x & 31)) & 1u ? label_sampled(a, x) : a.succ[x] >= 0;
}

// An element that no walk covered and that has a successor: it lies on a
// cycle with no ruler (the rest without an owner are lone elements).
__host__ __device__ inline bool label_uncovered(const LabelArgs& a, i64 x) { return a.owner[x] < 0 && a.succ[x] >= 0; }

// Ruler r's walk: owner slot `slot` for r and every element up to the next
// ruler or the path's end, and r's row. Returns the sublist's elements.
__host__ __device__ inline i64 label_sublist(const LabelArgs& a, i64 r, i64 slot) {
  a.owner[r] = (int32_t)slot;
  i64 v = r, last = r, len = 1, x = a.succ[r];
  while (x >= 0 && !label_sampled(a, x)) {
    a.owner[x] = (int32_t)slot;
    v = x < v ? x : v;
    last = x;
    ++len;
    x = a.succ[x];
  }
  a.rows[0][slot] = x >= 0 ? LabelRow{(int32_t)x, (uint32_t)v} : LabelRow{-1, (uint32_t)(a.n + last)};
  return len;
}

// One synchronous doubling round of row s: a row whose next row has ended
// its path takes that row's v (n + the path's end); else the minimum.
__host__ __device__ inline LabelRow label_step(const LabelRow* src, i64 s) {
  const LabelRow r = src[s];
  if (r.p < 0) return r;
  const LabelRow o = src[r.p];
  return {o.p, o.p < 0 ? o.v : (o.v < r.v ? o.v : r.v)};
}

#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Ctx>
__host__ __device__ inline void label_stamp(const LabelArgs& a, Ctx& c, int k) {
  if (c.first == 0) a.stats[kLabelStamp + k] = c.now();
}

// The count launch: stats zeroed, the has-predecessor bits, the rulers.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Ctx>
__host__ __device__ inline void label_count(const LabelArgs& a, Ctx& c) {
  if (c.first == 0) {
    for (int k = 0; k < kLabelStats; ++k) a.stats[k] = 0;
  }
  label_stamp(a, c, 0);
  for (i64 w = c.first; w < (a.n + 31) >> 5; w += c.stride) a.bits[w] = 0;
  c.sync();
  label_stamp(a, c, 1);
  i64 bad = 0;
  for (i64 i = c.first; i < a.n; i += c.stride) {
    const i64 s = a.succ[i];
    if (s >= a.n || (s >= 0 && c.mark(a.bits, s))) bad = 1;
  }
  c.max(a.stats + kLabelBad, bad);
  c.sync();
  label_stamp(a, c, 2);
  i64 rulers = 0;
  for (i64 i = c.first; i < a.n; i += c.stride) rulers += label_ruler(a, i);
  c.add(a.stats + kLabelRulers, rulers);
  c.sync();
  label_stamp(a, c, 3);
}

// The labels launch, on the count launch's bits and stats: claim, walk,
// the rows' doubling, the gather back, and the uncovered cycles.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Ctx>
__host__ __device__ inline void label_walk(const LabelArgs& a, Ctx& c) {
  label_stamp(a, c, 4);
  i64 slot = 0;
  for (i64 i = c.first; i < a.n; i += c.stride) {
    a.owner[i] = -1;
    slot += label_ruler(a, i);
  }
  slot = c.claim(a.stats + kLabelSlots, slot);
  c.sync();
  label_stamp(a, c, 5);
  i64 longest = 0;
  for (i64 i = c.first; i < a.n; i += c.stride) {
    if (!label_ruler(a, i)) continue;
    const i64 len = label_sublist(a, i, slot++);
    longest = len > longest ? len : longest;
  }
  c.max(a.stats + kLabelLongest, longest);
  c.sync();
  label_stamp(a, c, 6);
  const i64 S = c.load(a.stats + kLabelRulers);
  for (i64 s = c.first; s < S; s += c.stride) {
    const int32_t x = a.rows[0][s].p;
    if (x >= 0) a.rows[0][s].p = a.owner[x];  // a ruler owns itself
  }
  const int rounds = S ? log2_ceil(S) + 1 : 0;
  for (int r = 0; r < rounds; ++r) {
    c.sync();
    const LabelRow* src = r & 1 ? a.rows[1] : a.rows[0];  // a select, not an index: the rows stay in registers
    LabelRow* dst = r & 1 ? a.rows[0] : a.rows[1];
    for (i64 s = c.first; s < S; s += c.stride) dst[s] = label_step(src, s);
  }
  c.sync();
  label_stamp(a, c, 7);
  const LabelRow* fin = rounds & 1 ? a.rows[1] : a.rows[0];
  i64 uncovered = 0;
  for (i64 i = c.first; i < a.n; i += c.stride) {
    const int32_t o = a.owner[i];
    if (o >= 0) {
      const bool valid = a.valid[i] != 0;
      const LabelRow row = fin[o];
      a.label[i] = valid ? (i64)row.v : 2 * a.n;
      a.on_cycle[i] = valid && row.p >= 0;
    } else if (a.succ[i] < 0) {  // no predecessor and no successor: a path of its own
      a.label[i] = a.valid[i] ? a.n + i : 2 * a.n;
      a.on_cycle[i] = 0;
    } else {
      a.label[i] = (i << 32) | a.succ[i];  // (m, p) of the uncovered doubling
      ++uncovered;
    }
  }
  c.add(a.stats + kLabelUncovered, uncovered);
  c.sync();
  label_stamp(a, c, 8);
  const i64 U = c.load(a.stats + kLabelUncovered);
  if (U) {  // the same in every thread
    for (int r = log2_ceil(U) + 1; r > 0; --r) {
      for (i64 i = c.first; i < a.n; i += c.stride) {
        if (!label_uncovered(a, i)) continue;
        const i64 w = a.label[i], o = c.load(a.label + (w & kLow32));
        const i64 m = w >> 32, om = o >> 32;
        a.label[i] = ((om < m ? om : m) << 32) | (o & kLow32);
      }
      c.sync();
    }
    for (i64 i = c.first; i < a.n; i += c.stride) {
      if (!label_uncovered(a, i)) continue;
      const bool valid = a.valid[i] != 0;
      a.label[i] = valid ? a.label[i] >> 32 : 2 * a.n;
      a.on_cycle[i] = valid;
    }
    c.sync();
  }
  label_stamp(a, c, 9);
}

// The cut tables of the cut list's rank (ranking.py _cut_tables; the
// reference's ranking.py:510): for each ruler gid, the smallest hop offset
// of a cut edge it owns and the edge at that offset. A cut lane with an
// owner word folds the key (offset << kCutEdgeBits) | e into its gid's slot
// by a minimum; the smallest key is the smallest offset and, at it, the
// smallest edge id, which is what the reference's two scatter minima give.
// The minimum does not depend on the order of the folds, so the tables are
// the same on every run.
constexpr int kCutEdgeBits = 40;                     // edge ids below 2^40
constexpr unsigned long long kCutEdgeMask = (1ULL << kCutEdgeBits) - 1;
constexpr unsigned long long kCutNone = ~0ULL;       // a slot no cut reached
constexpr i64 kCutNoOffset = 1LL << 30;              // its offset: ranking._INF

struct CutArgs {
  const uint8_t* is_cut;      // [n] bytes (a torch bool)
  const i64* owner_off;       // [n] gid << 8 | offset, -1 where no walk covered the lane
  unsigned long long* table;  // [s] the folded keys, kCutNone to start; may be cut_edge's words
  i64* m1;                    // [s] the first cut's offset, kCutNoOffset for none
  i64* cut_edge;              // [s] its edge id, n for none
  i64 n, s;
};

__host__ __device__ inline void cut_fold(unsigned long long* slot, unsigned long long key) {
#ifdef __CUDA_ARCH__
  atomicMin(slot, key);
#else
  if (key < *slot) *slot = key;
#endif
}

// Lane e, whose cut flag is set: one fold where a walk covered it. The gid
// is clamped to the table as ranking._owner clamps it.
__host__ __device__ inline void cut_lane(const CutArgs& a, i64 e) {
  const i64 w = a.owner_off[e];
  if (w < 0) return;
  const i64 gid = (w >> 8) < a.s - 1 ? (w >> 8) : a.s - 1;
  cut_fold(a.table + gid, ((unsigned long long)(w & 0xff) << kCutEdgeBits) | (unsigned long long)e);
}

// Slot g's key into (m1, cut_edge); the key is read before either is written.
__host__ __device__ inline void cut_unpack(const CutArgs& a, i64 g) {
  const unsigned long long key = a.table[g];
  const bool none = key == kCutNone;
  a.m1[g] = none ? kCutNoOffset : (i64)(key >> kCutEdgeBits);
  a.cut_edge[g] = none ? a.n : (i64)(key & kCutEdgeMask);
}

}  // namespace ruling_walk
