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
// sentinel INT64_MAX sorts after every key. For k > 31 it is W = ceil(k/31)
// words, stored as buf[W*row .. W*row + W-1]: words 1..W-1 hold 31 bases
// each, word 0 the first k - 31(W-1); the canonical choice compares the
// words lexicographically, and an invalid window gets INT64_MAX in every
// word. For W = 1 and 2 the word count is a template parameter, so neither
// inner loop branches on it (the k = 31 and k = 41 paths). W >= 3 (k >= 63)
// takes a run-time word loop in O(1) registers: it compares forward against
// reverse complement word by word until they differ, then writes the chosen
// orientation word by word, so any k the read length allows has a kernel.
// The host entry point picks the instantiation from k.
//
// Bound: device memory. Per window the kernel stores 8 B per word and reads
// Lmax/W B of codes (1 B per base); the arithmetic is ~2k shifts/ORs per
// window from shared memory. At the config-2 batch (2^18 reads x 100 bases,
// k = 31, W = 70) one launch writes 147 MB and reads 26 MB; at k = 41
// (W = 60, two words) it writes 252 MB; at k = 63 (W = 38, three words)
// 239 MB, with twice the arithmetic per base (compare, then write).
// Design: a block stages a tile of reads in shared memory with coalesced
// byte loads; one thread per (read, window), neighbouring threads on
// neighbouring windows, so the stores of a warp are contiguous.
// Valid windows are counted per thread, reduced per warp with shuffles, then
// per block in shared memory: one 64-bit atomic per block, an exact integer
// sum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoBases = 31;

// NW = 1 or 2: that many words; NW = 0: nw words, nw >= 3, read at run time.
template <int NW>
__global__ void __launch_bounds__(kThreads)
extract_canonical_fill_kernel(const int8_t* __restrict__ codes, long long R,
                              int Lmax, int k, int reads_per_block,
                              long long* __restrict__ buf, long long start,
                              unsigned long long* __restrict__ n_valid,
                              int nw) {
  extern __shared__ int8_t tile[];
  __shared__ unsigned long long block_count;

  const int W = Lmax - k + 1;
  const long long r0 = (long long)blockIdx.x * reads_per_block;
  const int nr = (int)min((long long)reads_per_block, R - r0);
  const int n_bytes = nr * Lmax;
  const int8_t* src = codes + r0 * Lmax;

  if (threadIdx.x == 0) block_count = 0;
  for (int i = threadIdx.x; i < n_bytes; i += blockDim.x) tile[i] = src[i];
  __syncthreads();

  const int words = NW ? NW : nw;
  long long* out = buf + (start + r0 * W) * words;
  unsigned int local = 0;
  const int n_win = nr * W;
  for (int j = threadIdx.x; j < n_win; j += blockDim.x) {
    const int r = j / W;
    const int w = j - r * W;
    const int8_t* s = tile + r * Lmax + w;
    bool bad = false;
    if constexpr (NW == 1) {
      const unsigned long long kmask = (1ULL << (2 * k)) - 1ULL;
      unsigned long long fwd = 0, rc = 0;
      for (int i = 0; i < k; ++i) {
        const int8_t c = s[i];
        bad |= (c == 4);
        fwd = (fwd << 2) | (unsigned long long)(c & 3);
      }
      for (int i = k - 1; i >= 0; --i) {
        rc = (rc << 2) | (unsigned long long)((s[i] & 3) ^ 3);
      }
      fwd &= kmask;
      rc &= kmask;
      const unsigned long long canon = rc < fwd ? rc : fwd;
      out[j] = bad ? (long long)INT64_MAX : (long long)canon;
    } else if constexpr (NW == 2) {
      // fwd = bases [0, h) in hi, [h, k) in lo; its reverse complement =
      // complements of bases k-1 .. k-h in hi, k-h-1 .. 0 in lo
      const int h = k - kLoBases;
      unsigned long long fhi = 0, flo = 0, rhi = 0, rlo = 0;
      for (int i = 0; i < h; ++i) {
        const int8_t c = s[i];
        bad |= (c == 4);
        fhi = (fhi << 2) | (unsigned long long)(c & 3);
      }
      for (int i = h; i < k; ++i) {
        const int8_t c = s[i];
        bad |= (c == 4);
        flo = (flo << 2) | (unsigned long long)(c & 3);
      }
      for (int i = k - 1; i >= k - h; --i) {
        rhi = (rhi << 2) | (unsigned long long)((s[i] & 3) ^ 3);
      }
      for (int i = k - h - 1; i >= 0; --i) {
        rlo = (rlo << 2) | (unsigned long long)((s[i] & 3) ^ 3);
      }
      const bool take_rc = rhi < fhi || (rhi == fhi && rlo < flo);
      out[2 * j] = bad ? (long long)INT64_MAX : (long long)(take_rc ? rhi : fhi);
      out[2 * j + 1] = bad ? (long long)INT64_MAX : (long long)(take_rc ? rlo : flo);
    } else {
      // word j holds bases [a_j, a_j + len_j): a_0 = 0, len_0 = h, then 31
      // each; the reverse complement's base i is 3 - base k-1-i
      const int h = k - kLoBases * (nw - 1);
      for (int i = 0; i < k; ++i) bad |= (s[i] == 4);
      bool take_rc = false;
      for (int q = 0, a = 0; q < nw; a += (q == 0 ? h : kLoBases), ++q) {
        const int b = a + (q == 0 ? h : kLoBases);
        unsigned long long f = 0, rv = 0;
        for (int i = a; i < b; ++i) {
          f = (f << 2) | (unsigned long long)(s[i] & 3);
          rv = (rv << 2) | (unsigned long long)((s[k - 1 - i] & 3) ^ 3);
        }
        if (f != rv) {
          take_rc = rv < f;
          break;
        }
      }
      long long* o = out + (long long)nw * j;
      for (int q = 0, a = 0; q < nw; a += (q == 0 ? h : kLoBases), ++q) {
        const int b = a + (q == 0 ? h : kLoBases);
        unsigned long long v = 0;
        for (int i = a; i < b; ++i) {
          const int c = take_rc ? ((s[k - 1 - i] & 3) ^ 3) : (s[i] & 3);
          v = (v << 2) | (unsigned long long)c;
        }
        o[q] = bad ? (long long)INT64_MAX : (long long)v;
      }
    }
    local += bad ? 0u : 1u;
  }

  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0 && local)
    atomicAdd(&block_count, (unsigned long long)local);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(n_valid, block_count);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers;
// ``stream`` is a cudaStream_t; ``start`` counts keys (rows), not words.
// k <= 31 launches the one-word kernel, 31 < k <= 61 the two-word one, and
// larger k the run-time word loop.
// Returns cudaGetLastError() after the launch.
extern "C" int extract_canonical_fill(const void* codes, long long R, int Lmax,
                                      int k, int reads_per_block, void* buf,
                                      long long start, void* n_valid,
                                      void* stream) {
  if (R > 0) {
    const long long blocks = (R + reads_per_block - 1) / reads_per_block;
    const size_t smem = (size_t)reads_per_block * (size_t)Lmax;
    const cudaStream_t st = (cudaStream_t)stream;
    const int8_t* c = (const int8_t*)codes;
    long long* b = (long long*)buf;
    unsigned long long* nv = (unsigned long long*)n_valid;
    const int nw = (k + kLoBases - 1) / kLoBases;
    const unsigned int grid = (unsigned int)blocks;
    if (nw == 1) {
      extract_canonical_fill_kernel<1><<<grid, kThreads, smem, st>>>(
          c, R, Lmax, k, reads_per_block, b, start, nv, nw);
    } else if (nw == 2) {
      extract_canonical_fill_kernel<2><<<grid, kThreads, smem, st>>>(
          c, R, Lmax, k, reads_per_block, b, start, nv, nw);
    } else {
      extract_canonical_fill_kernel<0><<<grid, kThreads, smem, st>>>(
          c, R, Lmax, k, reads_per_block, b, start, nv, nw);
    }
  }
  return (int)cudaGetLastError();
}
