// Host build of emit_canonical.cuh, for the CPU tests: g++ compiles it with
// __host__ and __device__ empty, and the entry point runs the kernels'
// functions as one thread on host arrays: the decide pass over every contig
// in order, the resolve pass's scan of each pending contig in one run from
// the prefix window to its half, the header's last words, and the write
// pass over every 16-byte group. A test holds it bit for bit against the
// plain PyTorch version in tpu_euler_torch/euler/emit_kernel.py. It says
// nothing of speed or of what nvcc accepts.

#include "emit_canonical.cuh"

using emit_canonical::Args;
using emit_canonical::i64;

// The CUDA entry point's arguments without the stream.
extern "C" int emit_canonical_host(const void* codes, const void* off, const void* start_words, const void* twin,
                                   void* out, void* head, void* state, long long n, long long total, int k, int W) {
  if (n <= 0 || total <= 0) return 1;
  const Args a{(const uint8_t*)codes, (const i64*)off, (const i64*)start_words, (const i64*)twin, (uint8_t*)out,
               (i64*)head, (i64*)state, n, total, k, W, true};
  for (i64 c = 0; c < n; ++c) {
    emit_canonical::decide(a, c, [](i64* count) { return (*count)++; });
  }
  emit_canonical::finish_head(a);
  for (i64 u = 0; u < a.state[2 * n]; ++u) {
    const i64 c = a.state[n + u];
    const i64 L = emit_canonical::end_of(a, c) - a.off[c], half = (L + 1) / 2;
    const i64 j = emit_canonical::first_mismatch(a, c, L, emit_canonical::kPrefixWindow, half);
    a.state[c] = j >= 0 ? emit_canonical::direction_at(a, c, L, j) : 0;
  }
  uint8_t v[emit_canonical::kGroup];
  for (i64 g = 0; g * emit_canonical::kGroup < total; ++g) {
    const int cnt = emit_canonical::group_bytes(a, g, v);
    memcpy(a.out + g * emit_canonical::kGroup, v, cnt);
  }
  return 0;
}
