// Host build of ruling_walk.cuh, for the CPU tests: g++ compiles it with
// __host__ and __device__ empty, and each entry point runs the kernels'
// functions as one thread on host arrays: the walk's per-slot function over
// every slot in order, the doubling's pack, rounds and unpack over every
// element in order (the grid barrier a no-op). A test holds it bit for bit
// against the plain PyTorch versions in
// tpu_euler_torch/euler/ranking_kernel.py. It says nothing of speed or of
// what nvcc accepts.

#include "ruling_walk.cuh"

using ruling_walk::i64;

// The CUDA entry points' arguments without the stream.
extern "C" void ruling_walk_round_host(void* succ2, const void* frontier, long long s_cap, void* owner_off,
                                       void* elem, void* next_r, void* end_e, void* hops, void* mmin, void* cont,
                                       long long base, int walk_cap) {
  const ruling_walk::WalkArgs a{(i64*)succ2, (const i64*)frontier, (i64*)owner_off, (i64*)elem, (i64*)next_r,
                                (i64*)end_e, (i64*)hops, (i64*)mmin, (i64*)cont, base, walk_cap};
  for (i64 s = 0; s < s_cap; ++s) {
    if (mmin == nullptr) {
      ruling_walk::walk_slot<false>(a, s);
    } else {
      ruling_walk::walk_slot<true>(a, s);
    }
  }
}

extern "C" int pointer_jump_min_host(const void* p, const void* m, void* p_out, void* m_out, void* buf0, void* buf1,
                                     long long n, int rounds) {
  if (n <= 0 || rounds <= 0) return 0;
  const ruling_walk::JumpArgs a{{(const i64*)p, (const i64*)m, nullptr}, {(i64*)p_out, (i64*)m_out, nullptr},
                                {buf0, buf1}, n, rounds};
  ruling_walk::jump_rounds<ruling_walk::MinRec>(a, 0, 1, [] {});
  return 0;
}

extern "C" int pointer_jump_rank_host(const void* p, const void* d, const void* q, void* p_out, void* d_out,
                                      void* q_out, void* buf0, void* buf1, long long n, int rounds) {
  if (n <= 0 || rounds <= 0) return 0;
  const ruling_walk::JumpArgs a{{(const i64*)p, (const i64*)d, (const i64*)q}, {(i64*)p_out, (i64*)d_out, (i64*)q_out},
                                {buf0, buf1}, n, rounds};
  ruling_walk::jump_rounds<ruling_walk::RankRec>(a, 0, 1, [] {});
  return 0;
}

extern "C" int pointer_jump_labels_host(const void* succ, const void* valid, void* label, void* on_cycle, void* buf0,
                                        void* buf1, long long n, int rounds) {
  if (n <= 0) return 0;
  if (rounds < 0) return 1;
  const ruling_walk::JumpArgs a{{(const i64*)succ, nullptr, nullptr}, {(i64*)label, nullptr, nullptr}, {buf0, buf1},
                                n, rounds, (const uint8_t*)valid, (uint8_t*)on_cycle};
  ruling_walk::jump_rounds<ruling_walk::LabelRec>(a, 0, 1, [] {});
  return 0;
}
