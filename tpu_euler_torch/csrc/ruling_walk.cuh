// Per-slot functions of the ruling walk's round and of the pointer-jump
// round, shared by the CUDA kernels (ruling_walk.cu) and by the host build
// that the CPU tests load (ruling_walk_host.cpp, g++). Every value is an
// int64, as in the port's tensors; -1 is "none" for pointers and element
// ids, INT64_MAX (keys.SENT) the sentinel key.
//
// walk_slot is one lane of the reference's lockstep walk
// (tpu_euler/euler/ranking.py:135-256 _walk_round, the while_loop at :228),
// run to its end by one thread. That equals the lockstep loop because each
// element has at most one predecessor in a unitig successor array: a walk
// writes owner words only inside its own sublist and patches succ2 only at
// its own last element, so the order of hops across threads changes no
// output.
//
// jump_min_slot and jump_rank_slot are one element of one round of the
// reference's doubling fori_loops: min-propagating (ranking.py:351
// _contracted_cycle_min, unitigs.py:170 cut_cycles_from_t) and weighted
// Wyllie (ranking.py:373 _contracted_rank, :561 _patch_rank, unitigs.py:59
// wyllie_rank). A round reads the old state and writes the new one into
// other buffers, so its semantics are the synchronous ones.

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
struct WalkArgs {
  i64* succ2;            // [E + 1]: succ, -1 at a chain end, -2 - succ where succ is a ruler
  const i64* t;          // [E] transition keys; null without the minimum
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

template <bool TrackMin>
__host__ __device__ inline void walk_slot(const WalkArgs& a, i64 s) {
  const i64 f = a.frontier[s];
  i64 next_r = -1, end_e = -1, hops = 0, mmin = kSent, cont = -1;
  if (f >= 0) {
    const i64 gid = a.base + s;
    a.owner_off[f] = gid << 8;  // a ruler owns itself at offset 0
    i64 x = f, raw = a.succ2[f], step = 0;
    if (TrackMin) mmin = a.t[f];
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
      raw = a.succ2[x];
      if (TrackMin) {
        const i64 tx = a.t[x];
        mmin = tx < mmin ? tx : mmin;
      }
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
        a.succ2[x] = -2 - raw;
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

// m' = min(m, alive ? m[p] : SENT), p' = alive ? p[p] : -1, at element i of n.
__host__ __device__ inline void jump_min_slot(i64 i, i64 n, const i64* p, const i64* m, i64* p_out,
                                              i64* m_out) {
  const i64 pi = p[i];
  const bool alive = pi >= 0;
  const i64 pc = clamp_slot(pi, n);
  const i64 mi = m[i];
  const i64 mn = alive ? m[pc] : kSent;
  m_out[i] = mn < mi ? mn : mi;
  p_out[i] = alive ? p[pc] : -1;
}

// idx = alive ? p : i; p' = alive ? p[idx] : -1, d' = d + (alive ? d[idx] : 0),
// q' = q[idx], at element i of n.
__host__ __device__ inline void jump_rank_slot(i64 i, i64 n, const i64* p, const i64* d, const i64* q,
                                               i64* p_out, i64* d_out, i64* q_out) {
  const i64 pi = p[i];
  const bool alive = pi >= 0;
  const i64 idx = alive ? clamp_slot(pi, n) : i;
  p_out[i] = alive ? p[idx] : -1;
  d_out[i] = d[i] + (alive ? d[idx] : 0);
  q_out[i] = q[idx];
}

}  // namespace ruling_walk
