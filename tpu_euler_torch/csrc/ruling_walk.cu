// The ruling walk's round and the pointer-jump round, for sm_90a.
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
//  * pointer_jump_min_round / pointer_jump_rank_round: one round of the
//    reference's doubling fori_loops, min-propagating (ranking.py:351
//    _contracted_cycle_min; unitigs.py:170 cut_cycles_from_t) or weighted
//    Wyllie (ranking.py:373 _contracted_rank, :561 _patch_rank;
//    unitigs.py:59 wyllie_rank). One thread an element; the old state is
//    read and the new one written to other buffers (the host ping-pongs
//    them), so a round is synchronous. The host launches log2_ceil(n) + 1
//    rounds without a sync.
//
// Bound. A walk is a chain of dependent gathers, up to walk_cap of them:
// latency sets its time, not bytes. The bytes it must move are 24 a covered
// element (read succ2 and t, write the owner word; 16 without t) and 56 a
// slot (the frontier, five table words, the continuation). A jump round
// moves 32 bytes an element (min: read p and m, write both) or 48 (rank:
// p, d, q); its gathers are random, so it reaches a fraction of the memory
// rate at best.
//
// Design: the simplest kernels that keep the walk on the device, one launch
// a round instead of ~15 a hop; a thread keeps its walk's state in
// registers and touches device memory only for the gather of the next
// element, its owner word and its t. Several hops in flight a warp, and
// retuned (RULER_STRIDE, WALK_CAP), are later work.

#include <cuda_runtime.h>

#include "ruling_walk.cuh"

namespace {

using ruling_walk::i64;

constexpr int kThreads = 256;

template <bool TrackMin>
__global__ void __launch_bounds__(kThreads) walk_round_kernel(ruling_walk::WalkArgs a, i64 s_cap) {
  const i64 s = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (s < s_cap) ruling_walk::walk_slot<TrackMin>(a, s);
}

__global__ void __launch_bounds__(kThreads)
jump_min_kernel(i64 n, const i64* __restrict__ p, const i64* __restrict__ m, i64* __restrict__ p_out,
                i64* __restrict__ m_out) {
  const i64 i = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) ruling_walk::jump_min_slot(i, n, p, m, p_out, m_out);
}

__global__ void __launch_bounds__(kThreads)
jump_rank_kernel(i64 n, const i64* __restrict__ p, const i64* __restrict__ d, const i64* __restrict__ q,
                 i64* __restrict__ p_out, i64* __restrict__ d_out, i64* __restrict__ q_out) {
  const i64 i = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) ruling_walk::jump_rank_slot(i, n, p, d, q, p_out, d_out, q_out);
}

unsigned int grid(i64 n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers to
// int64 arrays; ``stream`` is a cudaStream_t. Each returns
// cudaGetLastError() after its launch (none for an empty input).

// ``t`` and ``mmin`` null: the walk without the minimum.
extern "C" int ruling_walk_round(void* succ2, const void* t, const void* frontier, long long s_cap,
                                 void* owner_off, void* elem, void* next_r, void* end_e, void* hops,
                                 void* mmin, void* cont, long long base, int walk_cap, void* stream) {
  const ruling_walk::WalkArgs a{(i64*)succ2, (const i64*)t, (const i64*)frontier, (i64*)owner_off,
                                (i64*)elem, (i64*)next_r, (i64*)end_e, (i64*)hops, (i64*)mmin,
                                (i64*)cont, base, walk_cap};
  const cudaStream_t st = (cudaStream_t)stream;
  if (s_cap <= 0) return (int)cudaGetLastError();
  if (t != nullptr) {
    walk_round_kernel<true><<<grid(s_cap), kThreads, 0, st>>>(a, s_cap);
  } else {
    walk_round_kernel<false><<<grid(s_cap), kThreads, 0, st>>>(a, s_cap);
  }
  return (int)cudaGetLastError();
}

extern "C" int pointer_jump_min_round(const void* p, const void* m, void* p_out, void* m_out, long long n,
                                      void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  jump_min_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(n, (const i64*)p, (const i64*)m,
                                                                  (i64*)p_out, (i64*)m_out);
  return (int)cudaGetLastError();
}

extern "C" int pointer_jump_rank_round(const void* p, const void* d, const void* q, void* p_out,
                                       void* d_out, void* q_out, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  jump_rank_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      n, (const i64*)p, (const i64*)d, (const i64*)q, (i64*)p_out, (i64*)d_out, (i64*)q_out);
  return (int)cudaGetLastError();
}
