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
// unitigs.py:170 cut_cycles_from_t) or weighted Wyllie (ranking.py:373
// _contracted_rank, :561 _patch_rank, unitigs.py:59 wyllie_rank), over the
// elements first, first + stride, ..., with a barrier of every thread
// between passes. The state is kept as records (MinRec, RankRec), so the
// gather of an element's successor reads one sector; a round reads the old
// records and writes the other buffer, so its semantics are the
// synchronous ones.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace ruling_walk {

using i64 = long long;
constexpr i64 kSent = INT64_MAX;

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
// (p, d, q), the output arrays, two record buffers of n records, rounds.
struct JumpArgs {
  const i64* in[3];
  i64* out[3];
  void* buf[2];
  i64 n;
  int rounds;
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

// Every round of one doubling (rounds >= 1) over elements first, first +
// stride, ...: pack the inputs into buf[0]; round r reads buf[r % 2] and
// writes buf[(r + 1) % 2], the last round the output arrays; sync() is a
// barrier of every thread that runs it.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Rec, class Sync>
__host__ __device__ inline void jump_rounds(const JumpArgs& a, i64 first, i64 stride, Sync sync) {
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

}  // namespace ruling_walk
