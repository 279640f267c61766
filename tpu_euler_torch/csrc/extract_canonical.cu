// Fused k-mer extraction + canonicalization + sentinel fill, for sm_90a.
//
// Replaces the Pallas TPU kernel tpu_euler/kmer/pallas_extract.py
// (extract_canonical_pallas, body _extract_kernel) together with what XLA
// fused around it in the one-shot fill step
// (tpu_euler/pipeline/assemble.py:make_extract_fill_step, _core):
//
//   buf[start + r*W + w] = canonical 2k-bit key of read r, window w
//                          (INT64_MAX when the window holds a code 4)
//   *n_valid            += number of valid windows
//
// Key layout: 2 bits/base (A=0 C=1 G=2 T=3), first base most significant.
// For odd k <= 31 a key is one int64 word, right-aligned in 62 bits, so the
// sentinel INT64_MAX sorts after every key. For k > 31 it is nw = ceil(k/31)
// words, stored as buf[nw*row .. nw*row + nw-1]: words 1..nw-1 hold 31 bases
// each, word 0 the first k - 31(nw-1); the canonical choice compares the
// words lexicographically, and an invalid window gets INT64_MAX in every
// word. For nw = 1 and 2 the word count is a template parameter (the k = 31
// and k = 41 paths); nw >= 3 (k >= 63) takes a run-time word loop, so any k
// the read length allows has a kernel. The host entry point picks the
// instantiation from k.
//
// The kernel has two tile loaders and is instantiated with each:
//  * int8 codes [R, Lmax] (extract_canonical_fill; the sharded mode's path);
//  * the feed's 2.25-bit batches (extract_canonical_fill_packed; every
//    single-device route): packed [R, ceil(Lmax/4)] uint8 and an N map
//    [R, ceil(Lmax/8)] uint8, or no map for a batch without N or padding.
//    This fuses the reference's unpack_codes / unpack_codes_clean
//    (tpu_euler/kmer/extract.py:51, :67), which run before the Pallas kernel
//    there: the packed bytes are the 2-bit tile up to a reversal of the
//    2-bit groups of each word (kmer_tile.cuh pack_tile_packed).
//
// Bound: device memory. Per window the kernel stores 8 B per word and reads
// Lmax/W B of codes (1 B per base; 0.25 B packed, + 0.125 B with a map): at
// the config-2 batch (2^18 reads x 100 bases) one launch reads 26 MB of int8
// codes, or 6.6 MB packed (+ 3.4 MB of map), and writes 147 MB at k = 31
// (W = 70, one word), 252 MB at k = 41 (W = 60, two words), 239 MB at
// k = 63 (W = 38, three words). The stores are 85-98% of the bytes.
// Design: what a block does per window is kept to a few tens of
// instructions, so that the stores and not the arithmetic set the time.
//  * A block packs a tile of reads once into 2-bit words in shared memory
//    (kmer_tile.cuh: forward strand, reverse complement of the whole read,
//    a bit map of code 4; the codes staged with 16-byte loads). A key word
//    is then one two-word funnel shift of the forward strand, its reverse
//    complement the same cut of the other strand, validity a mask of the
//    map: no loop over the bases of a window.
//  * Threads take the tile's windows in flat order, neighbouring threads on
//    neighbouring keys, so a warp's stores are one contiguous run: 8 bytes a
//    thread at nw = 1, one 16-byte store a key at nw = 2; at nw >= 3 a warp
//    gathers its 32 keys in shared memory and writes them as whole lines.
//    A thread that owns both windows of a 16-byte slot at nw = 1 was
//    measured on the H100 and not kept (slower: more registers, fewer
//    blocks an SM). Streaming stores (st.global.cs) change this kernel's
//    time by under 2% either way; the two-word store is streaming because
//    probe 3, which shares it and writes three such streams, needs it.
//  * (read, window) of a flat index advances by a fixed step (kmer_tile's
//    Cursor): one division a thread, none a window.
//  * Valid windows are counted per thread, reduced per warp with shuffles,
//    then per block in shared memory: one 64-bit atomic per block, an exact
//    integer sum.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_tile.cuh"

namespace {

using kmer_tile::Cursor;
using kmer_tile::Shape;
using kmer_tile::u64;

constexpr int kThreads = 256;
constexpr u64 kSent = (u64)INT64_MAX;

// Canonical key of window w of read r of the tile, for NW = 1 or 2 words;
// sentinel words where the window holds a code 4. Returns whether the
// window is valid.
template <int NW>
__device__ __forceinline__ bool canonical_key(const u64* tile, const Shape& shape,
                                              int r, int w, int k, u64 (&out)[NW]) {
  u64 a[NW], b[NW];
  kmer_tile::window_words<NW>(kmer_tile::fwd_of(tile, shape, r), kmer_tile::rc_of(tile, shape, r),
                              w, k, shape.Lmax, a, b);
  const bool take_rc = kmer_tile::key_less<NW>(b, a);
  const bool bad = kmer_tile::has_n(kmer_tile::nmap_of(tile, shape, r), w, k);
#pragma unroll
  for (int j = 0; j < NW; ++j) out[j] = bad ? kSent : (take_rc ? b[j] : a[j]);
  return !bad;
}

// The tile loaders: each builds a block's packed tile from rows
// [r0, r0 + nr) of its input, ``raw`` being the scratch of
// kmer_tile::raw_bytes(shape, ...).
struct CodesLoader {  // int8 codes [R, Lmax]
  const int8_t* codes;
  __device__ void operator()(long long r0, int nr, const Shape& s, u64* tile,
                             unsigned char* raw) const {
    kmer_tile::pack_tile(codes + r0 * s.Lmax, nr, s, tile, reinterpret_cast<int8_t*>(raw));
  }
};
struct PackedLoader {  // packed [R, l4] uint8 + N map [R, l8] uint8 (none where l8 = 0)
  const uint8_t* packed;
  const uint8_t* nmask;
  __device__ void operator()(long long r0, int nr, const Shape& s, u64* tile,
                             unsigned char* raw) const {
    kmer_tile::pack_tile_packed(packed + r0 * s.l4, s.l8 ? nmask + r0 * s.l8 : nullptr, nr, s,
                                tile, raw);
  }
};

// NW = 1 or 2: that many words; NW = 0: nw words, nw >= 3, read at run time.
template <int NW, class Loader>
__global__ void __launch_bounds__(kThreads)
extract_canonical_fill_kernel(Loader load, long long R,
                              Shape shape, int k, int reads_per_block,
                              long long* __restrict__ buf, long long start,
                              unsigned long long* __restrict__ n_valid,
                              int nw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long block_count;

  const int Lmax = shape.Lmax;
  const int W = Lmax - k + 1;
  const long long r0 = (long long)blockIdx.x * reads_per_block;
  const int nr = (int)min((long long)reads_per_block, R - r0);
  const int tid = threadIdx.x;

  u64* tile = reinterpret_cast<u64*>(smem);
  unsigned char* raw = smem + kmer_tile::packed_bytes(shape, reads_per_block);
  if (tid == 0) block_count = 0;
  load(r0, nr, shape, tile, raw);

  const int words = NW ? NW : nw;
  long long* out = buf + (start + r0 * W) * words;
  unsigned int local = 0;
  const int n_win = nr * W;

  if constexpr (NW == 1) {
    kmer_tile::for_windows(n_win, W, [&](int j, int r, int w) {
      u64 key[1];
      local += canonical_key<1>(tile, shape, r, w, k, key);
      out[j] = (long long)key[0];
    });
  } else if constexpr (NW == 2) {
    kmer_tile::for_windows(n_win, W, [&](int j, int r, int w) {
      u64 key[2];
      local += canonical_key<2>(tile, shape, r, w, k, key);
      kmer_tile::store_key2(out + 2 * (long long)j, key[0], key[1]);
    });
  } else {
    // a warp takes 32 neighbouring windows: each lane compares its window's
    // forward and reverse-complement words until they differ, writes the
    // chosen strand's words to the warp's rows of `lines`, and the warp
    // stores the 32 nw words as one contiguous run
    u64* lines = reinterpret_cast<u64*>(raw + kmer_tile::raw_bytes(shape, reads_per_block));
    const int lane = tid & 31, nt = blockDim.x;
    u64* mine = lines + (size_t)(tid >> 5) * 32 * nw;
    const int h = k - kmer_tile::kLoBases * (nw - 1);
    const int dr = nt / W, dw = nt - dr * W;
    Cursor c;
    c.init(tid, W);
    for (int j0 = tid - lane; j0 < n_win; j0 += nt, c.advance(dr, dw, W)) {
      if (j0 + lane < n_win) {
        const u64* f = kmer_tile::fwd_of(tile, shape, c.r);
        const u64* rc = kmer_tile::rc_of(tile, shape, c.r);
        const int wr = Lmax - k - c.w;
        const bool bad = kmer_tile::has_n(kmer_tile::nmap_of(tile, shape, c.r), c.w, k);
        bool take_rc = false;
        for (int q = 0; q < nw; ++q) {
          const u64 a = kmer_tile::key_word(f, c.w, h, q);
          const u64 b = kmer_tile::key_word(rc, wr, h, q);
          if (a != b) {
            take_rc = b < a;
            break;
          }
        }
        const u64* s = take_rc ? rc : f;
        const int a0 = take_rc ? wr : c.w;
        for (int q = 0; q < nw; ++q)
          mine[lane * nw + q] = bad ? kSent : kmer_tile::key_word(s, a0, h, q);
        local += bad ? 0u : 1u;
      }
      __syncwarp();
      const int n_out = min(32, n_win - j0) * nw;
      long long* o = out + (long long)j0 * nw;
      for (int i = lane; i < n_out; i += 32) o[i] = (long long)mine[i];
      __syncwarp();
    }
  }

  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0 && local)
    atomicAdd(&block_count, (unsigned long long)local);
  __syncthreads();
  if (tid == 0 && block_count) atomicAdd(n_valid, block_count);
}

// Launch the kernel with ``load`` over R reads of ``shape``: k <= 31 takes
// the one-word kernel, 31 < k <= 61 the two-word one, and larger k the
// run-time word loop. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without one where a single read's tile does not fit
// the shared memory.
template <class Loader>
int launch(Loader load, long long R, const Shape& shape, int k, void* buf,
           long long start, void* n_valid, void* stream) {
  if (R > 0) {
    const int nw = (k + kmer_tile::kLoBases - 1) / kmer_tile::kLoBases;
    // at three words a key and more, a warp's 32 keys go through shared memory
    const size_t lines = nw > 2 ? (size_t)kThreads * nw * sizeof(u64) : 0;
    const int reads = kmer_tile::tile_reads(shape, lines);
    if (reads == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = kmer_tile::smem_bytes(shape, reads) + lines;
    const unsigned int grid = (unsigned int)((R + reads - 1) / reads);
    const cudaStream_t st = (cudaStream_t)stream;
    long long* b = (long long*)buf;
    unsigned long long* nv = (unsigned long long*)n_valid;
    if (nw == 1) {
      extract_canonical_fill_kernel<1><<<grid, kThreads, smem, st>>>(
          load, R, shape, k, reads, b, start, nv, nw);
    } else if (nw == 2) {
      extract_canonical_fill_kernel<2><<<grid, kThreads, smem, st>>>(
          load, R, shape, k, reads, b, start, nv, nw);
    } else {
      extract_canonical_fill_kernel<0><<<grid, kThreads, smem, st>>>(
          load, R, shape, k, reads, b, start, nv, nw);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// ``stream`` is a cudaStream_t; ``start`` counts keys (rows), not words.

// int8 codes [R, Lmax].
extern "C" int extract_canonical_fill(const void* codes, long long R, int Lmax,
                                      int k, void* buf, long long start,
                                      void* n_valid, void* stream) {
  return launch(CodesLoader{(const int8_t*)codes}, R, kmer_tile::make_shape(Lmax), k, buf,
                start, n_valid, stream);
}

// Packed codes [R, ceil(Lmax/4)] and an N map [R, ceil(Lmax/8)], or
// ``nmask`` null for a batch without N or padding.
extern "C" int extract_canonical_fill_packed(const void* packed, const void* nmask, long long R,
                                             int Lmax, int k, void* buf, long long start,
                                             void* n_valid, void* stream) {
  return launch(PackedLoader{(const uint8_t*)packed, (const uint8_t*)nmask}, R,
                kmer_tile::make_shape_packed(Lmax, nmask != nullptr), k, buf, start, n_valid,
                stream);
}
