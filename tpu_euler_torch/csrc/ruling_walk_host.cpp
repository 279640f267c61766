// Host build of ruling_walk.cuh, for the CPU tests: g++ compiles it with
// __host__ and __device__ empty, and each entry point runs the kernels'
// functions as one thread on host arrays: the walk's per-slot function over
// every slot in order, the doubling's pack, rounds and unpack over every
// element in order (the grid barrier a no-op), the label pass's count and
// walk launches as one thread (HostLabelCtx), the cut tables' fold over
// every set lane and their unpack over every slot. A test holds it bit for bit
// against the plain PyTorch versions in
// tpu_euler_torch/euler/ranking_kernel.py. It says nothing of speed or of
// what nvcc accepts.

#include <chrono>

#include "ruling_walk.cuh"

using ruling_walk::i64;

namespace {

// The label pass's threads (ruling_walk.cuh): one thread, so every
// reduction is its own value and a barrier does nothing.
struct HostLabelCtx {
  i64 first = 0, stride = 1;

  void sync() {}
  i64 now() const {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }
  void add(i64* p, i64 v) const { *p += v; }
  void max(i64* p, i64 v) const { *p = v > *p ? v : *p; }
  i64 claim(i64* p, i64 v) const {
    const i64 first_slot = *p;
    *p += v;
    return first_slot;
  }
  bool mark(uint32_t* bits, i64 x) const {
    const uint32_t m = 1u << (x & 31), old = bits[x >> 5];
    bits[x >> 5] = old | m;
    return (old & m) != 0;
  }
  i64 load(const i64* p) const { return *p; }
};

ruling_walk::LabelArgs label_args(const void* succ, const void* valid, void* label, void* on_cycle, void* bits,
                                  void* owner, void* rows0, void* rows1, void* stats, long long n,
                                  unsigned long long sample_below) {
  return {(const i64*)succ, (const uint8_t*)valid, (i64*)label, (uint8_t*)on_cycle, (uint32_t*)bits, (int32_t*)owner,
          {(ruling_walk::LabelRow*)rows0, (ruling_walk::LabelRow*)rows1}, (i64*)stats, n, sample_below};
}

}  // namespace

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

extern "C" int ruling_labels_count_host(const void* succ, void* bits, void* stats, long long n,
                                        unsigned long long sample_below) {
  if (n <= 0) return 0;
  HostLabelCtx c;
  ruling_walk::label_count(
      label_args(succ, nullptr, nullptr, nullptr, bits, nullptr, nullptr, nullptr, stats, n, sample_below), c);
  return 0;
}

extern "C" int ruling_labels_walk_host(const void* succ, const void* valid, void* label, void* on_cycle, void* bits,
                                       void* owner, void* rows0, void* rows1, void* stats, long long n,
                                       unsigned long long sample_below) {
  if (n <= 0) return 0;
  HostLabelCtx c;
  ruling_walk::label_walk(label_args(succ, valid, label, on_cycle, bits, owner, rows0, rows1, stats, n, sample_below),
                          c);
  return 0;
}

extern "C" int ruling_cut_tables_host(const void* is_cut, const void* owner_off, void* m1, void* cut_edge, long long n,
                                      long long s) {
  if (s <= 0) return 0;
  const ruling_walk::CutArgs a{(const uint8_t*)is_cut, (const i64*)owner_off, (unsigned long long*)cut_edge,
                               (i64*)m1, (i64*)cut_edge, n, s};
  for (i64 g = 0; g < s; ++g) a.table[g] = ruling_walk::kCutNone;
  for (i64 e = 0; e < n; ++e) {
    if (a.is_cut[e]) ruling_walk::cut_lane(a, e);
  }
  for (i64 g = 0; g < s; ++g) ruling_walk::cut_unpack(a, g);
  return 0;
}
