// Per-contig and per-byte functions of the canonical emission, shared by the
// CUDA kernels (emit_canonical.cu) and by the host build that the CPU tests
// load (emit_canonical_host.cpp, g++).
//
// Input: the emission's code buffer (a contig's bases from its k-th on, as
// emit_chains_device scatters them; its first k - 1 slots are not read),
// the contigs' ascending offsets, each contig's start edge key, whose
// first k - 1 bases are the contig's prefix, and where the caller knows it
// the contig that may repeat it (its twin: the other strand's chain).
// Output: a header of 2n + 2 int64 words (the n + 1 offsets, the count of
// contigs resolved in the second pass, then for each contig the lower
// index of a contig whose canonical bytes are the same, or -1) and the
// canonical ASCII bytes, each contig the smaller of its sequence and its
// reverse complement, byte for byte, at its own offset.
//
// A contig of length L reads forward where its first position j with
// code[j] != 3 - code[L-1-j] has the smaller forward base, or where there
// is none (it is its own reverse complement); else reverse complemented.
// Such a j, where there is one, lies in the first (L + 1) / 2 positions.
// Since ASCII orders A < C < G < T as the codes 0 < 1 < 2 < 3, the bytes
// compare as the codes do.

#pragma once

#include <cstdint>
#include <cstring>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace emit_canonical {

using i64 = long long;

constexpr int kLoBases = 31;         // bases a key word holds (keys.LO_BASES)
constexpr i64 kPrefixWindow = 64;    // positions the decide pass reads (emit_kernel.PREFIX_WINDOW)
constexpr int kGroup = 16;           // output bytes a thread of the write pass
constexpr uint32_t kFwd = 0x54474341u;  // "ACGT": byte c is the ASCII of code c
constexpr uint32_t kRev = 0x41434754u;  // "TGCA": byte c is the ASCII of code 3 - c
constexpr i64 kPending = 2;          // a contig's state word until the second pass decides it

struct Args {
  const uint8_t* codes;      // [>= total] base codes 0..3, at the output's positions
  const i64* off;            // [n] contig offsets, ascending; contig n - 1 ends at total
  const i64* start_words;    // [n, W] each contig's start edge key
  const i64* twin;           // [n] a contig that may repeat each, or -1; null for none
  uint8_t* out;              // [total] the canonical ASCII bytes
  i64* head;                 // [header_words(n)] offsets, total, the second pass's count, repeats
  i64* state;                // [2n + 1], zeroed: each contig's direction (0 forward, 1 reverse
                             // complement, kPending), the pending contigs, their count
  i64 n, total;
  int k, W;
  bool vec;                  // codes 16-byte aligned: the write pass may load 16 codes at once
};

__host__ __device__ inline i64 header_words(i64 n) { return 2 * n + 2; }

// contig c's word of the header's repeats
__host__ __device__ inline i64* repeat_of(const Args& a, i64 c) { return a.head + a.n + 2 + c; }

__host__ __device__ inline i64 end_of(const Args& a, i64 c) { return c + 1 < a.n ? a.off[c + 1] : a.total; }

// The base code at position j of contig c: below k - 1 the start key's base
// j (up = k - 1 - j bases above the key's last base, in word W - 1 - up / 31),
// else the buffer's.
__host__ __device__ inline int code_at(const Args& a, i64 c, i64 j) {
  if (j < a.k - 1) {
    const int up = a.k - 1 - (int)j;
    const uint64_t w = (uint64_t)a.start_words[c * a.W + a.W - 1 - up / kLoBases];
    return (int)((w >> (2 * (up % kLoBases))) & 3);
  }
  return a.codes[a.off[c] + j];
}

// The first j in [j0, j1) where contig c, of length L, differs from its
// reverse complement; -1 for none.
__host__ __device__ inline i64 first_mismatch(const Args& a, i64 c, i64 L, i64 j0, i64 j1) {
  for (i64 j = j0; j < j1; ++j) {
    if (code_at(a, c, j) != 3 - code_at(a, c, L - 1 - j)) return j;
  }
  return -1;
}

// The direction a first mismatch at j decides: 1 where the reverse
// complement's base there is the smaller.
__host__ __device__ inline i64 direction_at(const Args& a, i64 c, i64 L, i64 j) {
  return 3 - code_at(a, c, L - 1 - j) < code_at(a, c, j) ? 1 : 0;
}

// The decide pass for contig c: its header words (its offset; its twin as
// its repeat where the twin is a lower index of its length, which the
// write pass clears at the first byte that differs), and its direction
// from the first kPrefixWindow positions; a contig whose window is its own
// mirror, and that is longer, is appended to the pending list (``claim``
// returns a fresh slot of the count word).
template <class Claim>
__host__ __device__ inline void decide(const Args& a, i64 c, Claim claim) {
  a.head[c] = a.off[c];
  if (c == 0) a.head[a.n] = a.total;
  const i64 L = end_of(a, c) - a.off[c], half = (L + 1) / 2;
  const i64 t = a.twin == nullptr ? -1 : a.twin[c];
  *repeat_of(a, c) = t >= 0 && t < c && end_of(a, t) - a.off[t] == L ? t : -1;
  const i64 j = first_mismatch(a, c, L, 0, half < kPrefixWindow ? half : kPrefixWindow);
  if (j >= 0) {
    a.state[c] = direction_at(a, c, L, j);
  } else if (half > kPrefixWindow) {
    a.state[c] = kPending;
    a.state[a.n + claim(&a.state[2 * a.n])] = c;
  }
}

// The header's pending count, after the decide pass.
__host__ __device__ inline void finish_head(const Args& a) { a.head[a.n + 1] = a.state[2 * a.n]; }

// The contig that holds output byte p: the last c with off[c] <= p.
__host__ __device__ inline i64 contig_of(const Args& a, i64 p) {
  i64 lo = 0, hi = a.n - 1;
  while (lo < hi) {
    const i64 mid = (lo + hi + 1) >> 1;
    if (a.off[mid] <= p) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__host__ __device__ inline uint8_t ascii(uint32_t table, int code) { return (uint8_t)(table >> (8 * code)); }

// The canonical byte at position j of contig c, which ends at e, once its
// direction is decided.
__host__ __device__ inline uint8_t canonical_at(const Args& a, i64 c, i64 e, i64 j) {
  return a.state[c] == 1 ? ascii(kRev, code_at(a, c, e - a.off[c] - 1 - j)) : ascii(kFwd, code_at(a, c, j));
}

// Clears contig c's repeat where its canonical bytes from local position j
// (v[0, cnt)) differ from its twin's there.
__host__ __device__ inline void check_repeat(const Args& a, i64 c, i64 j, const uint8_t* v, int cnt) {
  i64* rep = repeat_of(a, c);
  const i64 t = *rep;
  if (t < 0) return;
  const i64 e = end_of(a, t);
  for (int i = 0; i < cnt; ++i) {
    if (v[i] != canonical_at(a, t, e, j + i)) {
      *rep = -1;
      return;
    }
  }
}

__host__ __device__ inline void load16(const uint8_t* src, uint8_t* v) {
#ifdef __CUDA_ARCH__
  *(uint4*)v = __ldg((const uint4*)src);
#else
  memcpy(v, src, kGroup);
#endif
}

// Output bytes [g * kGroup, + kGroup) (fewer at the end) into v, each
// held against its contig's twin's (check_repeat); returns their count. A
// group inside one forward contig, past its prefix, is one 16-byte load of
// codes mapped byte by byte; any other byte is looked up alone, at its own
// position or its mirror's.
__host__ __device__ inline int group_bytes(const Args& a, i64 g, uint8_t* v) {
  const i64 p0 = g * kGroup;
  const int cnt = (int)(a.total - p0 < kGroup ? a.total - p0 : kGroup);
  i64 c = contig_of(a, p0), s = a.off[c], e = end_of(a, c);
  if (a.vec && cnt == kGroup && a.state[c] == 0 && p0 >= s + a.k - 1 && p0 + kGroup <= e) {
    load16(a.codes + p0, v);
    for (int i = 0; i < kGroup; ++i) v[i] = ascii(kFwd, v[i]);
    check_repeat(a, c, p0 - s, v, cnt);
    return cnt;
  }
  int i0 = 0;  // the first byte of contig c in the group
  for (int i = 0; i < cnt; ++i) {
    const i64 p = p0 + i;
    if (p >= e) {
      check_repeat(a, c, p0 + i0 - s, v + i0, i - i0);
      i0 = i;
      while (p >= e) {
        ++c;
        s = e;
        e = end_of(a, c);
      }
    }
    v[i] = canonical_at(a, c, e, p - s);
  }
  check_repeat(a, c, p0 + i0 - s, v + i0, cnt - i0);
  return cnt;
}

}  // namespace emit_canonical
