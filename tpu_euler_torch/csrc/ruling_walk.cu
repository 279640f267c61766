// The ruling walk's round and the pointer-jump doubling, for sm_90a.
//
// Replace two device loops of the reference, which ran as one XLA program
// each and which the port had turned into host loops of small torch ops:
//
//  * ruling_walk_round: one capped walk round, the reference's jitted
//    _walk_round (tpu_euler/euler/ranking.py:135-256, its lax.while_loop at
//    :228) together with _append_tables (:259). One thread takes one
//    frontier slot and follows succ2 until a ruler, a chain end or the cap
//    (ruling_walk.cuh walk_slot); it writes the owner words on its way, its
//    row of the ruler tables at base + slot, the succ2 patch at a capped
//    walk's last element, and the continuation element (-1 for none). The
//    host compacts the continuations in slot order (torch), so the gids of
//    the next round's virtual rulers are the reference's, and reads their
//    count: one host read a round, as the reference's int(n_capped) (:331).
//  * pointer_jump_min / pointer_jump_rank: every round of one of the
//    reference's doubling fori_loops, min-propagating (ranking.py:351
//    _contracted_cycle_min; unitigs.py:170 cut_cycles_from_t) or weighted
//    Wyllie (ranking.py:373 _contracted_rank, :561 _patch_rank;
//    unitigs.py:59 wyllie_rank), in one cooperative launch.
//  * pointer_jump_labels: the Eulerian tour's label doubling, the
//    reference's _labels (tpu_euler/euler/tour.py:90-124, its fori_loop at
//    :115) whole, in one cooperative launch: the initial state (from succ
//    and the element's own id) packed into the first buffer, every round,
//    and the final select of the label and the on-cycle flag (which reads
//    the valid byte) in the last pass, so its bytes are succ and valid read
//    once and label and on_cycle written once, 18 a tour edge.
//
// What bounds them. A walk is a chain of dependent gathers (up to walk_cap
// of them); a round of config 2's graph touches ~8 M random elements, and
// each random 8-byte access costs a whole 32-byte sector, so the round is
// bound by random accesses (a load and the owner word's store a hop; the
// store alone is half the kernel's time), and its tail by the latency of
// the longest walk. A doubling at the contracted size (~0.5 M elements, in
// L2) is short per round, so launching it a round at a time left it bound by
// the host's issue rate; at E (~10 M) each round's gathers cost a sector per
// array gathered.
//
// Design. The walk: one thread a frontier slot runs its walk to its end
// (resident blocks that take slots from a counter, and several walks in
// flight a thread, were measured and gained nothing, PERF.md section 6);
// with the minimum, succ2 and t lie in one [E + 1, 2] record array, so a
// hop reads them in one 16-byte load, one sector instead of two. The
// doubling: one cooperative launch runs every round over a grid-stride
// loop, with a grid barrier (cooperative_groups::this_grid().sync())
// between rounds, on at most the resident blocks and about
// kJumpElems elements a thread (fewer blocks, a cheaper barrier); the state
// is packed into 16-byte (p, m) or 32-byte (p, d, q, pad) records, so each
// gather reads one sector, and the last round writes the output arrays.
// The labels' record is 16 bytes, (p, m << 32 | q): the tour refuses
// E >= 2^30, so m and q fit 32 bits each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ruling_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using ruling_walk::i64;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// elements a thread of the doubling takes before the grid grows past the
// resident blocks: fewer blocks make each round's grid barrier cheaper
constexpr int kJumpElems = 8;

i64 ceil_div(i64 n, i64 d) { return (n + d - 1) / d; }

// Blocks of `kernel` that the current device holds at once, or 0 where the
// query fails; `cache` (one entry a device) is the caller's, one per kernel.
int resident_blocks(const void* kernel, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess) {
    return 0;
  }
  if (dev < kMaxDevices) cache[dev] = sms * per_sm;
  return sms * per_sm;
}

template <bool TrackMin>
__global__ void __launch_bounds__(kThreads) walk_round_kernel(ruling_walk::WalkArgs a, i64 s_cap) {
  const i64 s = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (s < s_cap) ruling_walk::walk_slot<TrackMin>(a, s);
}

template <bool TrackMin>
int launch_walk(const ruling_walk::WalkArgs& a, i64 s_cap, cudaStream_t st) {
  walk_round_kernel<TrackMin><<<(unsigned int)ceil_div(s_cap, kThreads), kThreads, 0, st>>>(a, s_cap);
  return (int)cudaGetLastError();
}

template <class Rec>
__global__ void __launch_bounds__(kThreads) jump_kernel(ruling_walk::JumpArgs a) {
  cg::grid_group grid = cg::this_grid();
  ruling_walk::jump_rounds<Rec>(a, (i64)blockIdx.x * kThreads + threadIdx.x, (i64)gridDim.x * kThreads,
                                [&] { grid.sync(); });
}

template <class Rec>
int launch_jump(ruling_walk::JumpArgs a, cudaStream_t st) {
  static int cache[kMaxDevices] = {};
  const auto kernel = jump_kernel<Rec>;
  const int resident = resident_blocks((const void*)kernel, cache);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const i64 want = ceil_div(a.n, (i64)kJumpElems * kThreads);
  const int blocks = (int)(want < resident ? want : resident);
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel((void*)kernel, blocks, kThreads, args, 0, st);
  const cudaError_t last = cudaGetLastError();  // read (and clear) it either way
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers to
// int64 arrays; ``stream`` is a cudaStream_t. Each returns the launch's
// error (cudaGetLastError(); 0 and no launch for an empty input).

// ``mmin`` null: the walk without the minimum over the succ2 array; else
// ``succ2`` points at the [E + 1, 2] (succ2, t) record (16-byte aligned).
extern "C" int ruling_walk_round(void* succ2, const void* frontier, long long s_cap, void* owner_off, void* elem,
                                 void* next_r, void* end_e, void* hops, void* mmin, void* cont, long long base,
                                 int walk_cap, void* stream) {
  const ruling_walk::WalkArgs a{(i64*)succ2, (const i64*)frontier, (i64*)owner_off, (i64*)elem, (i64*)next_r,
                                (i64*)end_e, (i64*)hops, (i64*)mmin, (i64*)cont, base, walk_cap};
  const cudaStream_t st = (cudaStream_t)stream;
  if (s_cap <= 0) return (int)cudaGetLastError();
  return mmin == nullptr ? launch_walk<false>(a, s_cap, st) : launch_walk<true>(a, s_cap, st);
}

// ``buf0``, ``buf1``: two buffers of n 16-byte (min) or 32-byte (rank)
// records, aligned to their size. rounds >= 1.
extern "C" int pointer_jump_min(const void* p, const void* m, void* p_out, void* m_out, void* buf0, void* buf1,
                                long long n, int rounds, void* stream) {
  if (n <= 0 || rounds <= 0) return (int)cudaGetLastError();
  const ruling_walk::JumpArgs a{{(const i64*)p, (const i64*)m, nullptr}, {(i64*)p_out, (i64*)m_out, nullptr},
                                {buf0, buf1}, n, rounds};
  return launch_jump<ruling_walk::MinRec>(a, (cudaStream_t)stream);
}

extern "C" int pointer_jump_rank(const void* p, const void* d, const void* q, void* p_out, void* d_out,
                                 void* q_out, void* buf0, void* buf1, long long n, int rounds, void* stream) {
  if (n <= 0 || rounds <= 0) return (int)cudaGetLastError();
  const ruling_walk::JumpArgs a{{(const i64*)p, (const i64*)d, (const i64*)q}, {(i64*)p_out, (i64*)d_out, (i64*)q_out},
                                {buf0, buf1}, n, rounds};
  return launch_jump<ruling_walk::RankRec>(a, (cudaStream_t)stream);
}

// ``succ``: [n] int64 (-1 for none); ``valid``: [n] bytes (a torch bool);
// ``label``: [n] int64; ``on_cycle``: [n] bytes; ``buf0``, ``buf1``: two
// buffers of n 16-byte records, aligned to 16, not read where rounds is 0.
// n < 2^31; rounds >= 0.
extern "C" int pointer_jump_labels(const void* succ, const void* valid, void* label, void* on_cycle, void* buf0,
                                   void* buf1, long long n, int rounds, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (rounds < 0) return (int)cudaErrorInvalidValue;
  const ruling_walk::JumpArgs a{{(const i64*)succ, nullptr, nullptr}, {(i64*)label, nullptr, nullptr}, {buf0, buf1},
                                n, rounds, (const uint8_t*)valid, (uint8_t*)on_cycle};
  return launch_jump<ruling_walk::LabelRec>(a, (cudaStream_t)stream);
}
