// SA locate by LF walk, one thread per suffix-array row, for Hopper
// (sm_90a).
//
// Replaces the XLA program `device_locate`
// (megapath_tpu/align/seeding_jax.py:1030-1071): a row walks backwards
// through the text by the LF mapping, at most sa_interval + 1 steps,
// until it reaches a row whose text position was sampled; its position
// is then sa_sampled[rank of the mark] + steps. A row not resolved in
// that many steps reads -1, as there. The JAX walk runs every row in
// lockstep for all sa_interval + 1 iterations; here each thread stops at
// its mark.
//
// What bounds it on this card: dependent loads, as in the seed walk. A
// step is one mark-row fetch (bitmap word and its rank checkpoint, 8
// bytes), and when the row is not marked one 64-byte occ row for the LF
// step, whose address depends on the previous step; the last load is
// sa_sampled. The expanded rows of one batch are independent, so tens of
// thousands of threads keep the loads in flight.
//
// What the design does about that: one thread per row, no shared
// memory, no synchronisation; the mark bitmap with a rank checkpoint
// every 32 rows (0.25 bytes a row) makes a mark lookup one 8-byte fetch
// and a popcount, and the occ row holds the BWT char and its rank
// together, so an LF step is one row fetch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowWords = 16;  // occ[4] | words[8] | pad[4]

__global__ void __launch_bounds__(kThreads)
locate_kernel(const int32_t* __restrict__ rows_in, int32_t* __restrict__ out,
              const uint32_t* __restrict__ fm_rows,
              const int32_t* __restrict__ counts,
              const uint32_t* __restrict__ mark_rows,
              const int32_t* __restrict__ sa_sampled, int M, int primary,
              int sa_interval) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= M) return;
  int r = rows_in[t];
  int pos = -1;
  for (int steps = 0; steps <= sa_interval; ++steps) {
    const uint2 mk = *reinterpret_cast<const uint2*>(mark_rows + 2 * (r >> 5));
    const uint32_t bit = (uint32_t)(r & 31);
    if ((mk.x >> bit) & 1u) {
      const int rank = (int)mk.y + __popc(mk.x & ((1u << bit) - 1u));
      pos = sa_sampled[rank] + steps;
      break;
    }
    // LF step: the BWT char of row r and its rank, from one occ row
    const int adj = r - (r > primary ? 1 : 0);
    const uint32_t* row = fm_rows + (size_t)(adj >> 7) * kRowWords;
    const int rel = adj & 127;
    const uint4 occ = *reinterpret_cast<const uint4*>(row);
    const uint4 wa = *reinterpret_cast<const uint4*>(row + 4);
    const uint4 wb = *reinterpret_cast<const uint4*>(row + 8);
    const uint32_t words[8] = {wa.x, wa.y, wa.z, wa.w,
                               wb.x, wb.y, wb.z, wb.w};
    const int c = (int)((words[rel >> 4] >> (2 * (rel & 15))) & 3u);
    const uint32_t base = c == 0 ? occ.x : c == 1 ? occ.y : c == 2 ? occ.z
                                                                    : occ.w;
    const uint32_t pat = (uint32_t)c * 0x55555555u;
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t x = ~(words[q] ^ pat);
      const uint32_t m = x & (x >> 1) & 0x55555555u;
      const int k = min(max(rel - 16 * q, 0), 16);
      const uint32_t mask = k >= 16 ? 0xffffffffu : ((1u << (2 * k)) - 1u);
      cnt += __popc(m & mask);
    }
    r = r == primary ? 0 : counts[c] + (int)base + cnt;
  }
  out[t] = pos;
}

}  // namespace

// Locates M full-BWT rows (int32, each in [0, n]) on `stream`, writing
// int32 text positions (-1 where no mark lies within sa_interval + 1
// steps). Tables as built by megapath_tpu_torch/align/seeding_dev.py:
// occ rows [n_blocks + 1][16] uint32, counts int32 [5], mark rows
// [ceil((n + 1) / 32)][2] uint32 (bitmap word, rank checkpoint),
// sa_sampled int32. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for M <= 0. Allocates nothing.
extern "C" int mp_locate(const void* rows_in, void* out, const void* fm_rows,
                         const void* counts, const void* mark_rows,
                         const void* sa_sampled, int M, int primary,
                         int sa_interval, void* stream) {
  if (M <= 0 || sa_interval < 0) return (int)cudaErrorInvalidValue;
  locate_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows_in), static_cast<int32_t*>(out),
      static_cast<const uint32_t*>(fm_rows),
      static_cast<const int32_t*>(counts),
      static_cast<const uint32_t*>(mark_rows),
      static_cast<const int32_t*>(sa_sampled), M, primary, sa_interval);
  return (int)cudaGetLastError();
}
