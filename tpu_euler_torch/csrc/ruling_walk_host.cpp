// Host build of ruling_walk.cuh, for the CPU tests: g++ compiles it with
// __host__ and __device__ empty, and each entry point runs the kernel's
// per-slot function over every slot in order, on host arrays. A test holds
// it bit for bit against the plain PyTorch versions in
// tpu_euler_torch/euler/ranking_kernel.py. It says nothing of speed or of
// what nvcc accepts.

#include "ruling_walk.cuh"

using ruling_walk::i64;

extern "C" void ruling_walk_round_host(void* succ2, const void* t, const void* frontier, long long s_cap,
                                       void* owner_off, void* elem, void* next_r, void* end_e, void* hops,
                                       void* mmin, void* cont, long long base, int walk_cap) {
  const ruling_walk::WalkArgs a{(i64*)succ2, (const i64*)t, (const i64*)frontier, (i64*)owner_off,
                                (i64*)elem, (i64*)next_r, (i64*)end_e, (i64*)hops, (i64*)mmin,
                                (i64*)cont, base, walk_cap};
  for (i64 s = 0; s < s_cap; ++s) {
    if (t != nullptr) {
      ruling_walk::walk_slot<true>(a, s);
    } else {
      ruling_walk::walk_slot<false>(a, s);
    }
  }
}

extern "C" void pointer_jump_min_round_host(const void* p, const void* m, void* p_out, void* m_out,
                                            long long n) {
  for (i64 i = 0; i < n; ++i) {
    ruling_walk::jump_min_slot(i, n, (const i64*)p, (const i64*)m, (i64*)p_out, (i64*)m_out);
  }
}

extern "C" void pointer_jump_rank_round_host(const void* p, const void* d, const void* q, void* p_out,
                                             void* d_out, void* q_out, long long n) {
  for (i64 i = 0; i < n; ++i) {
    ruling_walk::jump_rank_slot(i, n, (const i64*)p, (const i64*)d, (const i64*)q, (i64*)p_out,
                                (i64*)d_out, (i64*)q_out);
  }
}
