// A tile of reads in 2-bit packed form, and k-mer windows cut from it in
// O(1): device functions shared by the fused extract kernel
// (extract_canonical.cu) and probe 3 (probes.cu, extract_stages), so the
// probe checks the arithmetic the extract kernel runs.
//
// A block turns each read of its tile once into packed form in shared
// memory, from int8 codes (pack_tile) or from the feed's 2.25-bit batches
// (pack_tile_packed):
//
//   fwd    the read at 2 bits a base, 32 bases a 64-bit word, first base in
//          the most significant bits (base i: word i / 32, bits
//          63 - 2 (i % 32) and the one below);
//   rc     the reverse complement of the whole read (base i of rc =
//          3 - base Lmax-1-i of the read, codes taken & 3), same layout;
//   nmap   one bit a base, set where the code is 4 (base i: bit i % 64 of
//          word i / 64), after one word that is non-zero where the read
//          holds a code 4 at all.
//
// Both strands carry one zero word past their end, so n <= 31 bases from any
// base a with a + n <= Lmax are one two-word funnel shift (bases()):
// ((s[q] : s[q+1]) << 2 (a % 32)) >> (64 - 2n), q = a / 32. Word j of a
// key is one such cut at its own base offset (key_word()); the reverse
// complement of window w is the window at base Lmax - k - w of rc; the
// window is valid where the k map bits from bit w are zero (has_n(): one
// load and test for a read without a code 4, as nearly all are). No
// loop runs over the bases of a window.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmer_tile {

typedef unsigned long long u64;

constexpr int kLoBases = 31;  // bases in every key word but the first

// Shapes of the packed tile, computed once on the host.
struct Shape {
  int Lmax;    // bases a read
  int nq;      // 32-base words a strand, rounded up to even
  int stride;  // 64-bit words a read: 2 (nq + 1) strand words + 1 + nq / 2 map words
  int l4;      // packed loader: bytes a packed row, ceil(Lmax / 4); 0 for int8 codes
  int l8;      // packed loader: bytes a row of the N map, ceil(Lmax / 8); 0 without one
};

// The tile of int8 codes [R, Lmax] (pack_tile).
__host__ __device__ inline Shape make_shape(int Lmax) {
  Shape s;
  s.Lmax = Lmax;
  s.nq = 2 * ((Lmax + 63) / 64);
  s.stride = 2 * (s.nq + 1) + 1 + s.nq / 2;
  s.l4 = s.l8 = 0;
  return s;
}

// The tile of packed codes [R, ceil(Lmax/4)] and, where ``has_map``, an N
// map [R, ceil(Lmax/8)] (pack_tile_packed).
__host__ __device__ inline Shape make_shape_packed(int Lmax, bool has_map) {
  Shape s = make_shape(Lmax);
  s.l4 = (Lmax + 3) / 4;
  s.l8 = has_map ? (Lmax + 7) / 8 : 0;
  return s;
}

// Shared memory of a tile of ``reads`` reads: the packed tile, then the raw
// bytes as the loader stages them (each array with 16 bytes of slack, so
// raw and global addresses agree mod 16). All sizes are multiples of 16.
__host__ __device__ inline size_t packed_bytes(const Shape& s, int reads) {
  return ((size_t)reads * s.stride * sizeof(u64) + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t raw_area(size_t n) { return ((n + 15) & ~(size_t)15) + 16; }
__host__ __device__ inline size_t raw_bytes(const Shape& s, int reads) {
  if (s.l4 == 0) return raw_area((size_t)reads * s.Lmax);
  return raw_area((size_t)reads * s.l4) + (s.l8 ? raw_area((size_t)reads * s.l8) : 0);
}
__host__ __device__ inline size_t smem_bytes(const Shape& s, int reads) {
  return packed_bytes(s, reads) + raw_bytes(s, reads);
}

// Reads of a block's tile: kTileReads, halved until the tile and ``extra``
// more bytes fit the 48 KB of shared memory a launch gets without opting
// in to more; 0 where not even one read fits.
constexpr int kTileReads = 128;
constexpr size_t kSmemLimit = 48 * 1024;
inline int tile_reads(const Shape& s, size_t extra) {
  int reads = kTileReads;
  while (reads > 1 && smem_bytes(s, reads) + extra > kSmemLimit) reads /= 2;
  return smem_bytes(s, reads) + extra > kSmemLimit ? 0 : reads;
}

__device__ __forceinline__ const u64* fwd_of(const u64* tile, const Shape& s, int r) {
  return tile + (size_t)r * s.stride;
}
__device__ __forceinline__ const u64* rc_of(const u64* tile, const Shape& s, int r) {
  return tile + (size_t)r * s.stride + (s.nq + 1);
}
__device__ __forceinline__ const u64* nmap_of(const u64* tile, const Shape& s, int r) {
  return tile + (size_t)r * s.stride + 2 * (s.nq + 1);
}

// Reverse the thirty-two 2-bit groups of a word.
__device__ __forceinline__ u64 rev2(u64 x) {
  const u64 b = __brevll(x);
  return ((b >> 1) & 0x5555555555555555ULL) | ((b & 0x5555555555555555ULL) << 1);
}

// n bytes at src -> shared memory at raw + (src mod 16), with 16-byte
// loads aligned on the source: the bytes before the first and after the
// last 16-byte boundary go one by one. ``raw`` is 16-byte aligned scratch
// of raw_area(n) bytes. Returns the staged copy; the caller synchronizes.
template <class T>
__device__ inline const T* stage_bytes(const T* __restrict__ src, int n, unsigned char* raw) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int sh = (int)((uintptr_t)src & 15);
  T* dst = reinterpret_cast<T*>(raw + sh);
  const int head = min(n, (16 - sh) & 15);
  const int nvec = (n - head) >> 4;
  const int4* src16 = reinterpret_cast<const int4*>(src + head);
  int4* dst16 = reinterpret_cast<int4*>(dst + head);
  for (int i = tid; i < nvec; i += nt) dst16[i] = __ldg(src16 + i);
  for (int i = tid; i < head; i += nt) dst[i] = src[i];
  for (int i = head + 16 * nvec + tid; i < n; i += nt) dst[i] = src[i];
  return dst;
}

// Step 3 of both loaders, once the forward words and the map words are in
// the tile: the map's leading word, and the reverse complement of the whole
// read from the forward words: reverse the base order of the 32 nq slots
// (word order and rev2), shift out the 32 nq - Lmax empty slots that now
// lead, and complement.
__device__ inline void finish_tile(int nr, const Shape& s, u64* tile) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Lmax = s.Lmax, nq = s.nq;
  const int pad = 32 * nq - Lmax;
  const int pq = pad >> 5, po = (pad & 31) * 2;
  for (int t = tid; t < nr * nq; t += nt) {
    const int r = t / nq, j = t - r * nq;
    u64* fw = tile + (size_t)r * s.stride;
    const int a = j + pq;
    const u64 hi = a < nq ? rev2(fw[nq - 1 - a]) : 0;
    const u64 lo = a + 1 < nq ? rev2(fw[nq - 2 - a]) : 0;
    fw[nq + 1 + j] = ~(po ? (hi << po) | (lo >> (64 - po)) : hi);
    if (j == 0) {  // the map's leading word: any code 4 in the read
      u64* nm = fw + 2 * (nq + 1);
      u64 any = 0;
      for (int i = 1; i <= nq / 2; ++i) any |= nm[i];
      nm[0] = any;
    }
  }
  __syncthreads();
}

// Codes of nr reads (nr * Lmax bytes at src) -> packed tile at ``tile``;
// ``raw`` is 16-byte aligned scratch of raw_bytes(). Every thread of the
// block calls it; the tile is complete when it returns.
__device__ inline void pack_tile(const int8_t* __restrict__ src, int nr,
                                 const Shape& s, u64* tile, int8_t* raw) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Lmax = s.Lmax, nq = s.nq;

  // 1. stage the codes
  const int8_t* dst = stage_bytes(src, nr * Lmax, reinterpret_cast<unsigned char*>(raw));
  __syncthreads();

  // 2. forward strand and code-4 map: one (read, 32-base word) a thread,
  // four codes a 32-bit load where the rows are 4-byte aligned
  const bool rows_aligned = (Lmax & 3) == 0 && ((uintptr_t)dst & 3) == 0;
  for (int t = tid; t < nr * nq; t += nt) {
    const int r = t / nq, q = t - r * nq;
    const int8_t* row = dst + r * Lmax;
    u64 f = 0;
    unsigned int m = 0;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int i = 32 * q + 4 * g;
      unsigned int x = 0;  // codes i .. i+3, lowest byte first; 0 past the read
      if (rows_aligned && i + 4 <= Lmax) {
        x = *reinterpret_cast<const unsigned int*>(row + i);
      } else {
        for (int b = 0; b < 4; ++b)
          if (i + b < Lmax) x |= (unsigned int)(uint8_t)row[i + b] << (8 * b);
      }
      const unsigned int c = x & 0x03030303u;
      f = (f << 8) | (((c << 6) | (c >> 4) | (c >> 14) | (c >> 24)) & 0xFFu);
      const unsigned int n = __vcmpeq4(x, 0x04040404u) & 0x01010101u;
      m |= ((n | (n >> 7) | (n >> 14) | (n >> 21)) & 0xFu) << (4 * g);
    }
    u64* fw = tile + (size_t)r * s.stride;
    fw[q] = f;
    reinterpret_cast<unsigned int*>(fw + 2 * (nq + 1) + 1)[q] = m;
    if (q == 0) {
      fw[nq] = 0;
      fw[2 * nq + 1] = 0;
    }
  }
  __syncthreads();

  finish_tile(nr, s, tile);
}

// Little-endian word of ``n`` bytes from row[i] (0 <= n <= 8); the bytes
// of a packed row are not word-aligned, so they are read one by one.
__device__ __forceinline__ u64 le_bytes(const uint8_t* row, int i, int n) {
  u64 x = 0;
  for (int b = 0; b < n; ++b) x |= (u64)row[i + b] << (8 * b);
  return x;
}

// The packed batch's tile [reference unpack_codes fused in]: nr rows of
// s.l4 packed bytes at ``packed`` (four bases a byte, base 4j + b at bits
// 2b of byte j) and, where s.l8 > 0, nr rows of s.l8 N-map bytes at
// ``nmask`` (bit b of byte j set where base 8j + b is N or past the read);
// a batch without a map has no code 4. The packed bytes 8q .. 8q+7 of a
// row, read as a little-endian word, hold bases 32q .. 32q+31 with the
// first in the low bits: rev2 of it is forward word q. The map bytes
// 4q .. 4q+3 are map half-word q, once the bits at Lmax and above (set by
// the pack for the positions past the read) are cleared: else every read's
// leading map word would be non-zero and has_n() would take its slow loop.
// Same contract as pack_tile otherwise.
__device__ inline void pack_tile_packed(const uint8_t* __restrict__ packed,
                                        const uint8_t* __restrict__ nmask, int nr,
                                        const Shape& s, u64* tile, unsigned char* raw) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Lmax = s.Lmax, nq = s.nq, l4 = s.l4, l8 = s.l8;

  // 1. stage the packed rows, then the map's
  const uint8_t* pk = stage_bytes(packed, nr * l4, raw);
  const uint8_t* nm = l8 ? stage_bytes(nmask, nr * l8, raw + raw_area((size_t)nr * l4)) : nullptr;
  __syncthreads();

  // 2. forward word and map half-word q of read r, a thread each
  for (int t = tid; t < nr * nq; t += nt) {
    const int r = t / nq, q = t - r * nq;
    const int i = 8 * q;  // the word's first packed byte
    const u64 x = le_bytes(pk + r * l4, i, max(0, min(8, l4 - i)));
    unsigned int m = 0;
    if (l8) {
      const int j = 4 * q, left = Lmax - 32 * q;  // bases of this half in the read
      m = (unsigned int)le_bytes(nm + r * l8, j, max(0, min(4, l8 - j)));
      m = left >= 32 ? m : left > 0 ? m & ((1u << left) - 1u) : 0u;
    }
    u64* fw = tile + (size_t)r * s.stride;
    fw[q] = rev2(x);
    reinterpret_cast<unsigned int*>(fw + 2 * (nq + 1) + 1)[q] = m;
    if (q == 0) {
      fw[nq] = 0;
      fw[2 * nq + 1] = 0;
    }
  }
  __syncthreads();

  finish_tile(nr, s, tile);
}

// n bases (1 <= n <= 31) of a strand from base a, right-aligned in a word.
__device__ __forceinline__ u64 bases(const u64* strand, int a, int n) {
  const int q = a >> 5, o = (a & 31) * 2;
  const u64 hi = strand[q], lo = strand[q + 1];
  const u64 v = o ? (hi << o) | (lo >> (64 - o)) : hi;
  return v >> (64 - 2 * n);
}

// Word j of the key of the k bases from base a0; h = k - 31 (words - 1) is
// the base count of word 0.
__device__ __forceinline__ u64 key_word(const u64* strand, int a0, int h, int j) {
  return j == 0 ? bases(strand, a0, h)
                : bases(strand, a0 + h + kLoBases * (j - 1), kLoBases);
}

// True where bases [w, w + k) of the read hold a code 4; nmap is the read's
// map, leading word first.
__device__ __forceinline__ bool has_n(const u64* nmap, int w, int k) {
  if (nmap[0] == 0) return false;
  const int e = w + k;
  u64 hit = 0;
  for (int q = w >> 6; q <= (e - 1) >> 6; ++q) {
    const int lo = max(w - 64 * q, 0), n = min(e - 64 * q, 64) - lo;
    hit |= nmap[1 + q] & ((n == 64 ? ~0ULL : (1ULL << n) - 1ULL) << lo);
  }
  return hit != 0;
}

// Forward words a and reverse-complement words b of window w of a read
// with strands f and rc, for keys of NW words.
template <int NW>
__device__ __forceinline__ void window_words(const u64* f, const u64* rc, int w,
                                             int k, int Lmax, u64 (&a)[NW],
                                             u64 (&b)[NW]) {
  const int h = k - kLoBases * (NW - 1);
  const int wr = Lmax - k - w;  // the window's reverse complement on rc
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    a[j] = key_word(f, w, h, j);
    b[j] = key_word(rc, wr, h, j);
  }
}

// b < a, the words compared lexicographically.
template <int NW>
__device__ __forceinline__ bool key_less(const u64 (&b)[NW], const u64 (&a)[NW]) {
  bool lt = b[NW - 1] < a[NW - 1];
#pragma unroll
  for (int j = NW - 2; j >= 0; --j) lt = b[j] < a[j] || (b[j] == a[j] && lt);
  return lt;
}

// (read, window) of flat window j of a tile, kept without a division a
// step: init() divides once, advance() adds a fixed step = dr * W + dw.
struct Cursor {
  int r, w;
  __device__ __forceinline__ void init(int j, int W) {
    r = j / W;
    w = j - r * W;
  }
  __device__ __forceinline__ void advance(int dr, int dw, int W) {
    r += dr;
    w += dw;
    if (w >= W) {
      w -= W;
      ++r;
    }
  }
};

// body(j, r, w) for every flat window j < n_win of a tile whose reads have
// W windows, neighbouring threads on neighbouring windows.
template <class Body>
__device__ __forceinline__ void for_windows(int n_win, int W, Body body) {
  const int nt = blockDim.x;
  const int dr = nt / W, dw = nt - dr * W;
  Cursor c;
  c.init(threadIdx.x, W);
  for (int j = threadIdx.x; j < n_win; j += nt, c.advance(dr, dw, W)) body(j, c.r, c.w);
}

// The two words of a key to p[0] and p[1]: one 16-byte store where p is
// 16-byte aligned, as it is where the output tensor is. The stores are
// streaming (st.global.cs): the outputs are far larger than the L2 and are
// not read again by the kernel.
__device__ __forceinline__ void store_key2(long long* p, u64 a, u64 b) {
  if (((uintptr_t)p & 15) == 0) {
    __stcs(reinterpret_cast<longlong2*>(p), make_longlong2((long long)a, (long long)b));
  } else {
    __stcs(p, (long long)a);
    __stcs(p + 1, (long long)b);
  }
}

}  // namespace kmer_tile
