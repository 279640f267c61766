// The five TPU compiler probes of scripts/debug_pallas{2,3,4,5,6}.py, as
// CUDA kernels for sm_90a.
//
// Each probe replaced one Pallas kernel that checked a pack or shift
// operation of the extract kernel on the TPU against numpy:
//
//   lane_slices       scripts/debug_pallas2.py:33  probe (kernel :26)
//   extract_stages    scripts/debug_pallas3.py:44  probe (kernel :31)
//   shift_terms       scripts/debug_pallas4.py:59  probe (kernel :30)
//   u32_shifts        scripts/debug_pallas5.py:45  probe (kernel :30)
//   hoisted_and_roll  scripts/debug_pallas6.py:51  probe (kernel :30)
//
// Each kernel computes what its TPU kernel computes, one thread per output
// element (read r, window w) with neighbouring threads on neighbouring
// windows; the BlockSpecs, VMEM tiles and pltpu.roll of the TPU kernels are
// TPU artifacts and have no counterpart here (a roll by Lmax - i that
// brings column w + i to column w is an index w + i; no kept column wraps).
// Shapes are parameters; the scripts' defaults are the Python wrapper's.
// Outputs are stacked on a leading axis; uint32 results are stored as their
// 32 bits (the wrapper hands int32 tensors).
//
// Bound: device memory and launch latency. At the scripts' shapes (512 x 100
// codes) each launch moves well under 1 MB, so a launch costs its latency;
// extract_stages at the config-2 batch (2^18 x 100, k = 31) writes 3 words
// per window, 440 MB, and reads the 26 MB of codes once (it cuts its
// windows from the packed tile of kmer_tile.cuh, which it shares with the
// extract kernel).

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_tile.cuh"

namespace {

constexpr int kThreads = 256;

// scripts/debug_pallas5.py: LS, RS, MS
constexpr int kNShift = 9;
constexpr int kNMul = 5;
__constant__ int kShifts[kNShift] = {2, 8, 14, 16, 18, 20, 22, 26, 30};
__constant__ int kMulShifts[kNMul] = {14, 16, 18, 20, 22};

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

// out[i, r, w] = codes[r, w + i], i < n_off
__global__ void lane_slices_kernel(const int8_t* __restrict__ codes, int R,
                                   int Lmax, int W, int n_off,
                                   int* __restrict__ out) {
  const long long n = (long long)R * W;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long r = e / W;
  const int w = (int)(e - r * W);
  const int8_t* s = codes + r * Lmax + w;
  for (int i = 0; i < n_off; ++i) out[i * n + e] = (int)s[i];
}

// out[0] = forward key, out[1] = its reverse complement, out[2] = the
// canonical (smaller) of the two, of window (r, w) of codes & 3; each [R*W]
// words, or [R*W, 2] (hi, lo) for NW = 2 (lo = last 31 bases). The windows
// come from the packed tile of kmer_tile.cuh, as in the extract kernel: a
// block packs a tile of reads (kmer_tile::tile_reads), a key word
// is one funnel shift, and a two-word key is one 16-byte store.
template <int NW>
__global__ void __launch_bounds__(kThreads)
extract_stages_kernel(const int8_t* __restrict__ codes, int R,
                      kmer_tile::Shape shape, int k, int reads_per_block,
                      long long* __restrict__ out) {
  using kmer_tile::u64;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lmax = shape.Lmax;
  const int W = Lmax - k + 1;
  const long long n = (long long)R * W;
  const long long r0 = (long long)blockIdx.x * reads_per_block;
  const int nr = (int)min((long long)reads_per_block, R - r0);
  u64* tile = reinterpret_cast<u64*>(smem);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + kmer_tile::packed_bytes(shape, reads_per_block));
  kmer_tile::pack_tile(codes + r0 * Lmax, nr, shape, tile, raw);

  long long* fwd = out + r0 * W * NW;
  long long* rev = fwd + n * NW;
  long long* can = rev + n * NW;
  const int n_win = nr * W;
  kmer_tile::for_windows(n_win, W, [&](int j, int r, int w) {
    u64 a[NW], b[NW], c[NW];
    kmer_tile::window_words<NW>(kmer_tile::fwd_of(tile, shape, r), kmer_tile::rc_of(tile, shape, r),
                                w, k, Lmax, a, b);
    const bool take_rc = kmer_tile::key_less<NW>(b, a);
#pragma unroll
    for (int i = 0; i < NW; ++i) c[i] = take_rc ? b[i] : a[i];
    if constexpr (NW == 1) {
      fwd[j] = (long long)a[0];
      rev[j] = (long long)b[0];
      can[j] = (long long)c[0];
    } else {
      kmer_tile::store_key2(fwd + 2 * (long long)j, a[0], a[1]);
      kmer_tile::store_key2(rev + 2 * (long long)j, b[0], b[1]);
      kmer_tile::store_key2(can + 2 * (long long)j, c[0], c[1]);
    }
  });
}

// limb-0 terms of k = 31: term(i) = (codes[r, w + i] & 3) << 2 (14 - i).
// out: term(4), term(5), term(8), OR, SUM and int32-OR of terms 0..14
__global__ void shift_terms_kernel(const int8_t* __restrict__ codes, int R,
                                   int Lmax, int W,
                                   unsigned int* __restrict__ out) {
  const long long n = (long long)R * W;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long r = e / W;
  const int w = (int)(e - r * W);
  const int8_t* s = codes + r * Lmax + w;
  unsigned int acc_or = 0, acc_sum = 0;
  int acc_i = 0;
  for (int i = 0; i < 15; ++i) {
    const int shift = 2 * (14 - i);
    const unsigned int t = ((unsigned int)(int)s[i] & 3u) << shift;
    acc_or |= t;
    acc_sum += t;
    acc_i |= ((int)s[i] & 3) << shift;
    if (i == 4) out[e] = t;
    if (i == 5) out[n + e] = t;
    if (i == 8) out[2 * n + e] = t;
  }
  out[3 * n + e] = acc_or;
  out[4 * n + e] = acc_sum;
  out[5 * n + e] = (unsigned int)acc_i;
}

// uint32 x << s and x >> s for s in kShifts, x * 2^s for s in kMulShifts
__global__ void u32_shifts_kernel(const unsigned int* __restrict__ x,
                                  long long n, unsigned int* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const unsigned int v = x[e];
  for (int j = 0; j < kNShift; ++j) out[j * n + e] = v << kShifts[j];
  for (int j = 0; j < kNShift; ++j) out[(kNShift + j) * n + e] = v >> kShifts[j];
  for (int j = 0; j < kNMul; ++j)
    out[(2 * kNShift + j) * n + e] = v * (1u << kMulShifts[j]);
}

// cm = codes & 3 as uint32. out: cm[w + 4] << 20, cm[w + 5] << 18, and the
// limb-0 accumulation of bases 0..14: the OR of shifted slices; the OR of
// shifted rolled rows, which is the same sum (roll(cm, Lmax - i)[w] is
// cm[w + i] and no kept column wraps); Horner (shift by 2, OR)
__global__ void hoisted_and_roll_kernel(const int8_t* __restrict__ codes, int R,
                                        int Lmax, int W,
                                        unsigned int* __restrict__ out) {
  const long long n = (long long)R * W;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long r = e / W;
  const int w = (int)(e - r * W);
  const int8_t* s = codes + r * Lmax + w;
  unsigned int acc = 0, horner = 0;
  for (int i = 0; i < 15; ++i) {
    const unsigned int cm = (unsigned int)(int)s[i] & 3u;
    acc |= cm << (2 * (14 - i));
    horner = (horner << 2) | cm;
  }
  out[e] = ((unsigned int)(int)s[4] & 3u) << 20;
  out[n + e] = ((unsigned int)(int)s[5] & 3u) << 18;
  out[2 * n + e] = acc;
  out[3 * n + e] = acc;
  out[4 * n + e] = horner;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// ``stream`` is a cudaStream_t. Each returns cudaGetLastError() after its
// launch.

extern "C" int probe_lane_slices(const void* codes, int R, int Lmax, int W,
                                 int n_off, void* out, void* stream) {
  const long long n = (long long)R * W;
  if (n > 0)
    lane_slices_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)codes, R, Lmax, W, n_off, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int probe_extract_stages(const void* codes, int R, int Lmax, int k,
                                    void* out, void* stream) {
  const long long n = (long long)R * (Lmax - k + 1);
  if (n > 0) {
    const kmer_tile::Shape shape = kmer_tile::make_shape(Lmax);
    const int rpb = kmer_tile::tile_reads(shape, 0);
    if (rpb == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = kmer_tile::smem_bytes(shape, rpb);
    const unsigned int grid = (unsigned int)((R + rpb - 1) / rpb);
    if (k <= kmer_tile::kLoBases)
      extract_stages_kernel<1><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const int8_t*)codes, R, shape, k, rpb, (long long*)out);
    else
      extract_stages_kernel<2><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const int8_t*)codes, R, shape, k, rpb, (long long*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_shift_terms(const void* codes, int R, int Lmax, int W,
                                 void* out, void* stream) {
  const long long n = (long long)R * W;
  if (n > 0)
    shift_terms_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)codes, R, Lmax, W, (unsigned int*)out);
  return (int)cudaGetLastError();
}

extern "C" int probe_u32_shifts(const void* x, long long n, void* out,
                                void* stream) {
  if (n > 0)
    u32_shifts_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned int*)x, n, (unsigned int*)out);
  return (int)cudaGetLastError();
}

extern "C" int probe_hoisted_and_roll(const void* codes, int R, int Lmax, int W,
                                      void* out, void* stream) {
  const long long n = (long long)R * W;
  if (n > 0)
    hoisted_and_roll_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)codes, R, Lmax, W, (unsigned int*)out);
  return (int)cudaGetLastError();
}
