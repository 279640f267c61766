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
//  * ruling_labels_count / ruling_labels_walk: the same labels by a ruling
//    set in O(n) work, what the tour runs (ruling_walk.cuh label_count and
//    label_walk). The doubling gathers every element's record in each of
//    its log2(n) + 1 rounds, since on the tour's few long circuits no
//    element drops out; here one launch marks the has-predecessor bits and
//    counts the rulers (the path heads and a 1-in-R hash sample of the
//    ids), the caller reads that count and sizes the rows, and a second
//    launch claims slots, walks each ruler's sublist once (one thread a
//    ruler, no hop cap, a 4-byte owner slot stored a hop), runs the doubling
//    over the rulers' 8-byte rows alone (in L2) and gathers each element's
//    label from its ruler's row.
//  * ruling_cut_tables: the cut list's first-cut tables (ranking.py
//    _cut_tables; the reference's ranking.py:510, two scatter minima over
//    every edge). See below.
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
// E >= 2^30, so m and q fit 32 bits each. The ruling labels: the walk is
// bound, as the walk round is, by a dependent random load and a random
// store a hop, and its tail by the longest sublist (about R ln(rulers)
// hops); every phase between grid barriers is stamped with %globaltimer
// into the stats words, so what each costs is read after a call.
//
// The cut tables. The reference takes both minima over all E edges, each
// lane that is not a covered cut sending a sentinel to one spare slot; as
// scatter minima on this card those are E 64-bit atomics on one address, one
// after another (about 0.8 ns a lane). Only the cut edges, one or two a cycle,
// matter. So one pass reads the cut flags as 16-byte vectors, skips a vector
// with no flag set, and only a set lane with an owner word loads that word and
// takes one atomicMin of its packed key (ruling_walk.cuh cut_lane) into the
// gid's slot. The slots start at all ones and an O(S) pass unpacks them, all
// three phases in one cooperative launch with a grid barrier between them
// (one launch's latency at a small graph, resident blocks with several loads
// in flight a thread at a large one). Its bytes are about E, the flags, plus
// 24 a table slot: bound by the card's memory rate.

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

// One cooperative launch of `kernel` over n elements: at most the resident
// blocks (`cache`, one per kernel, holds their count), about kJumpElems
// elements a thread.
int launch_cooperative(const void* kernel, int* cache, void* arg, i64 n, cudaStream_t st) {
  const int resident = resident_blocks(kernel, cache);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const i64 want = ceil_div(n, (i64)kJumpElems * kThreads);
  const int blocks = (int)(want < resident ? want : resident);
  void* args[] = {arg};
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, blocks, kThreads, args, 0, st);
  const cudaError_t last = cudaGetLastError();  // read (and clear) it either way
  return (int)(err != cudaSuccess ? err : last);
}

template <class Rec>
int launch_jump(ruling_walk::JumpArgs a, cudaStream_t st) {
  static int cache[kMaxDevices] = {};
  return launch_cooperative((const void*)jump_kernel<Rec>, cache, &a, a.n, st);
}

// The label pass's threads (ruling_walk.cuh, the Ctx of label_count and
// label_walk): a cooperative grid of kThreads-thread blocks.
struct LabelGrid {
  cg::grid_group grid;
  i64 first, stride;
  i64* scan;  // shared: a block's warp totals, then its first slot

  __device__ void sync() { grid.sync(); }
  __device__ i64 now() const {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return (i64)t;
  }
  __device__ void add(i64* p, i64 v) const {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd((unsigned long long*)p, (unsigned long long)v);
  }
  __device__ void max(i64* p, i64 v) const {
    for (int o = 16; o > 0; o >>= 1) {
      const i64 w = __shfl_xor_sync(0xffffffffu, v, o);
      v = w > v ? w : v;
    }
    if ((threadIdx.x & 31) == 0 && v) atomicMax((long long*)p, (long long)v);
  }
  // an exclusive scan of v over the block, and one atomic a block
  __device__ i64 claim(i64* p, i64 v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    i64 x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) scan[warp] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
      i64 acc = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        const i64 t = scan[w];
        scan[w] = acc;
        acc += t;
      }
      scan[kThreads / 32] = (i64)atomicAdd((unsigned long long*)p, (unsigned long long)acc);
    }
    __syncthreads();
    return scan[kThreads / 32] + scan[warp] + x - v;
  }
  __device__ bool mark(uint32_t* bits, i64 x) const {
    const uint32_t m = 1u << (x & 31);
    return (atomicOr(bits + (x >> 5), m) & m) != 0;
  }
  __device__ i64 load(const i64* p) const { return __ldcg(p); }
};

__device__ LabelGrid label_grid(i64* scan) {
  return {cg::this_grid(), (i64)blockIdx.x * kThreads + threadIdx.x, (i64)gridDim.x * kThreads, scan};
}

__global__ void __launch_bounds__(kThreads) label_count_kernel(ruling_walk::LabelArgs a) {
  __shared__ i64 scan[kThreads / 32 + 1];
  LabelGrid c = label_grid(scan);
  ruling_walk::label_count(a, c);
}

__global__ void __launch_bounds__(kThreads) label_walk_kernel(ruling_walk::LabelArgs a) {
  __shared__ i64 scan[kThreads / 32 + 1];
  LabelGrid c = label_grid(scan);
  ruling_walk::label_walk(a, c);
}

// The cut tables' launch: the arguments and where the 16-byte vectors of the
// cut flags start (`head` bytes after the flags' start) and how many there are.
struct CutLaunch {
  ruling_walk::CutArgs a;
  i64 head, n_vec;
};

// One vector of 16 cut flags from lane e0: its set lanes folded, the byte
// picked from the words by shifts so the vector stays in registers.
__device__ inline void cut_vector(const ruling_walk::CutArgs& a, uint4 f, i64 e0) {
  if ((f.x | f.y | f.z | f.w) == 0) return;
  const unsigned int w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) ruling_walk::cut_lane(a, e0 + j);
  }
}

// The cut tables in one cooperative launch over a grid-stride loop: the
// table's slots set to kCutNone; a grid barrier; the flags read kCutLoads
// vectors at a time (loads in flight before any test), a vector with no
// flag set costing its load alone, then the bytes before and after the
// vectors, fewer than 32, a lane a thread; a grid barrier; the unpack.
constexpr int kCutLoads = 4;

__global__ void __launch_bounds__(kThreads) cut_tables_kernel(CutLaunch c) {
  cg::grid_group grid = cg::this_grid();
  const ruling_walk::CutArgs& a = c.a;
  const i64 first = (i64)blockIdx.x * kThreads + threadIdx.x, stride = (i64)gridDim.x * kThreads;
  for (i64 g = first; g < a.s; g += stride) a.table[g] = ruling_walk::kCutNone;
  grid.sync();
  const uint4* vec = reinterpret_cast<const uint4*>(a.is_cut + c.head);
  for (i64 v0 = first; v0 < c.n_vec; v0 += kCutLoads * stride) {
    uint4 f[kCutLoads];
#pragma unroll
    for (int u = 0; u < kCutLoads; ++u) {
      const i64 v = v0 + u * stride;
      f[u] = v < c.n_vec ? __ldcs(vec + v) : make_uint4(0, 0, 0, 0);  // read once: kept out of the caches
    }
#pragma unroll
    for (int u = 0; u < kCutLoads; ++u) cut_vector(a, f[u], c.head + 16 * (v0 + u * stride));
  }
  const i64 body_end = c.head + 16 * c.n_vec;
  for (i64 r = first; r < c.head + (a.n - body_end); r += stride) {
    const i64 e = r < c.head ? r : body_end + (r - c.head);
    if (a.is_cut[e]) ruling_walk::cut_lane(a, e);
  }
  grid.sync();
  for (i64 g = first; g < a.s; g += stride) ruling_walk::cut_unpack(a, g);
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

// The tour's labels by a ruling set, in two cooperative launches with the
// caller's read of the ruler count between them (ruling_walk.cuh,
// label_count and label_walk). ``succ``: [n] int64; ``bits``: [ceil(n / 32)]
// words; ``stats``: [kLabelStats] int64, written by the count. n < 2^31;
// sample_below <= 2^32.
extern "C" int ruling_labels_count(const void* succ, void* bits, void* stats, long long n,
                                   unsigned long long sample_below, void* stream) {
  static int cache[kMaxDevices] = {};
  if (n <= 0) return (int)cudaGetLastError();
  ruling_walk::LabelArgs a{(const i64*)succ, nullptr, nullptr, nullptr, (uint32_t*)bits, nullptr, {nullptr, nullptr},
                           (i64*)stats, n, sample_below};
  return launch_cooperative((const void*)label_count_kernel, cache, &a, n, (cudaStream_t)stream);
}

// ``valid``: [n] bytes; ``label``: [n] int64; ``on_cycle``: [n] bytes;
// ``owner``: [n] int32; ``rows0``, ``rows1``: [max(rulers, 1)] 8-byte rows
// each; ``bits`` and ``stats`` as the count left them.
extern "C" int ruling_labels_walk(const void* succ, const void* valid, void* label, void* on_cycle, void* bits,
                                  void* owner, void* rows0, void* rows1, void* stats, long long n,
                                  unsigned long long sample_below, void* stream) {
  static int cache[kMaxDevices] = {};
  if (n <= 0) return (int)cudaGetLastError();
  ruling_walk::LabelArgs a{(const i64*)succ, (const uint8_t*)valid, (i64*)label, (uint8_t*)on_cycle, (uint32_t*)bits,
                           (int32_t*)owner, {(ruling_walk::LabelRow*)rows0, (ruling_walk::LabelRow*)rows1},
                           (i64*)stats, n, sample_below};
  return launch_cooperative((const void*)label_walk_kernel, cache, &a, n, (cudaStream_t)stream);
}

// The cut tables: ``is_cut``: [n] bytes; ``owner_off``: [n] int64; ``m1``,
// ``cut_edge``: [s] int64, written (cut_edge's words hold the folded keys
// until the unpack). One cooperative launch; n < 2^40.
extern "C" int ruling_cut_tables(const void* is_cut, const void* owner_off, void* m1, void* cut_edge, long long n,
                                 long long s, void* stream) {
  static int cache[kMaxDevices] = {};
  if (s <= 0) return (int)cudaGetLastError();
  const i64 misaligned = (i64)((uintptr_t)is_cut % 16);
  const i64 head = misaligned ? (16 - misaligned < n ? 16 - misaligned : n) : 0;
  const i64 n_vec = n > head ? (n - head) / 16 : 0;
  CutLaunch c{{(const uint8_t*)is_cut, (const i64*)owner_off, (unsigned long long*)cut_edge, (i64*)m1,
               (i64*)cut_edge, n, s},
              head, n_vec};
  return launch_cooperative((const void*)cut_tables_kernel, cache, &c, (n_vec > s ? n_vec : s), (cudaStream_t)stream);
}
