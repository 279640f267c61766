// The canonical emission's host tail, on the card, for sm_90a.
//
// Replaces no TPU kernel. It replaces the reference's numpy tail of the
// device emission, which the port had carried over as it was:
// tpu_euler/euler/extract.py:306 _emission_to_contigs (the base lookup and
// the stitch of each chain's (k - 1)-base prefix from its start key) and
// :48 canonicalize_contig_buffer (each contig against its reverse
// complement). After emit_chains_device's scatter, three launches finish
// the canonical ASCII contig buffer and its header on the card, so the
// host receives O(total) bytes in one copy and only cuts them into bytes
// objects, skipping each contig that the card found to repeat a lower one
// byte for byte (emit_canonical.cuh says what is computed):
//
//  * emit_canonical_decide: one thread a contig writes its header words and
//    reads its first kPrefixWindow positions against their mirrors. A
//    random or real contig differs from its mirror within a few bases, so
//    nearly every contig is decided here; one whose window is its own
//    mirror, and that is longer, goes on a pending list (one atomic a
//    pending contig, none a byte).
//  * emit_canonical_resolve: one block a pending contig scans the rest of
//    its first half, kThreads * kGroup positions a step, each thread its
//    own kGroup of them, with a block minimum (shared memory) a step and
//    an exit at the first step that holds a mismatch. No pending contig
//    (the usual case): every block reads the count and leaves. Block 0
//    writes the header's count.
//  * emit_canonical_write: one thread each kGroup = 16 output bytes, grid
//    wide over the bytes and not one thread a contig, so it costs the same
//    for 1 contig or millions: a binary search of the offsets for the
//    group's contig, then a 16-byte load of codes and a 16-byte store where
//    the group lies in one forward contig past its prefix, else each byte
//    from its own position or its mirror's (codes 3 - c read in reverse),
//    the first k - 1 positions from the start key. A contig whose twin (the
//    other strand's chain, which the caller names) is a lower index of its
//    length holds each byte against the twin's canonical byte there and
//    clears its repeat word at the first that differs: the doubled edge
//    array emits every contig from both strands, and the host then hashes
//    and copies out each distinct contig once instead of twice.
//
// What bounds it: bytes. The write pass reads the codes once, writes the
// ASCII once and reads a repeating contig's twin's codes once more: 2.5
// bytes a byte of total where every contig has its twin (total holds both
// strands, about 200 MB for a 100 Mbp genome: 500 MB, 150 us at 3.35
// TB/s); the decide pass reads about 2 * kPrefixWindow bytes and the
// offsets and keys a contig, the resolve pass nothing unless a contig's
// window is its own mirror. A reverse complemented group reads its mirror's
// 16 codes one byte at a time, but a warp's reads of one group fall in the
// same few sectors, which L1 serves. The one thing avoided is a reduction
// of every byte of a contig onto one address (a segmented min by atomics
// or scatter-reduce serializes on the few contigs of a genome).

#include <cuda_runtime.h>

#include "emit_canonical.cuh"

namespace {

using emit_canonical::Args;
using emit_canonical::i64;
using emit_canonical::kGroup;
using emit_canonical::kPrefixWindow;

constexpr int kThreads = 256;
constexpr int kResolveBlocks = 264;  // two a streaming multiprocessor of the H100
constexpr i64 kNone = INT64_MAX;

__global__ void __launch_bounds__(kThreads) decide_kernel(Args a) {
  const i64 c = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (c < a.n) {
    emit_canonical::decide(a, c, [](i64* count) { return (i64)atomicAdd((unsigned long long*)count, 1ull); });
  }
}

__global__ void __launch_bounds__(kThreads) resolve_kernel(Args a) {
  __shared__ long long best;
  const i64 pending = a.state[2 * a.n];
  if (blockIdx.x == 0 && threadIdx.x == 0) emit_canonical::finish_head(a);
  for (i64 u = blockIdx.x; u < pending; u += gridDim.x) {
    const i64 c = a.state[a.n + u];
    const i64 L = emit_canonical::end_of(a, c) - a.off[c], half = (L + 1) / 2;
    i64 j = -1;
    for (i64 j0 = kPrefixWindow; j0 < half; j0 += (i64)kThreads * kGroup) {
      if (threadIdx.x == 0) best = kNone;
      __syncthreads();
      const i64 lo = j0 + (i64)threadIdx.x * kGroup, hi = lo + kGroup < half ? lo + kGroup : half;
      const i64 mine = lo < half ? emit_canonical::first_mismatch(a, c, L, lo, hi) : -1;
      if (mine >= 0) atomicMin(&best, (long long)mine);
      __syncthreads();
      const i64 found = best;
      __syncthreads();  // every thread has read best before the next step resets it
      if (found != kNone) {
        j = found;
        break;
      }
    }
    if (threadIdx.x == 0) a.state[c] = j >= 0 ? emit_canonical::direction_at(a, c, L, j) : 0;
  }
}

__global__ void __launch_bounds__(kThreads) write_kernel(Args a, i64 groups) {
  for (i64 g = (i64)blockIdx.x * kThreads + threadIdx.x; g < groups; g += (i64)gridDim.x * kThreads) {
    alignas(16) uint8_t v[kGroup];
    const int cnt = emit_canonical::group_bytes(a, g, v);
    uint8_t* dst = a.out + g * kGroup;
    if (cnt == kGroup) {
      *(uint4*)dst = *(const uint4*)v;
    } else {
      for (int i = 0; i < cnt; ++i) dst[i] = v[i];
    }
  }
}

}  // namespace

// ``codes``: [>= total] uint8; ``off``: [n] int64, ascending, off[0] = 0;
// ``start_words``: [n, W] int64; ``twin``: [n] int64 or null; ``out``:
// [total] bytes, 16-byte aligned; ``head``: [header_words(n)] int64;
// ``state``: [2n + 1] int64, zeroed. n >= 1. Three launches on ``stream``;
// returns the first CUDA error.
extern "C" int emit_canonical_bytes(const void* codes, const void* off, const void* start_words, const void* twin,
                                    void* out, void* head, void* state, long long n, long long total, int k,
                                    int W, void* stream) {
  if (n <= 0 || total <= 0 || ((uintptr_t)out & 15) != 0) return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)codes, (const i64*)off, (const i64*)start_words, (const i64*)twin, (uint8_t*)out,
               (i64*)head, (i64*)state, n, total, k, W, ((uintptr_t)codes & 15) == 0};
  const cudaStream_t st = (cudaStream_t)stream;
  decide_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  resolve_kernel<<<(unsigned)(n < kResolveBlocks ? n : kResolveBlocks), kThreads, 0, st>>>(a);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const i64 groups = (total + kGroup - 1) / kGroup;
  const i64 blocks = (groups + kThreads - 1) / kThreads;
  write_kernel<<<(unsigned)(blocks < (1ll << 30) ? blocks : (1ll << 30)), kThreads, 0, st>>>(a, groups);
  return (int)cudaGetLastError();
}
