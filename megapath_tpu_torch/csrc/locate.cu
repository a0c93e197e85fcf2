// SA locate by LF walk, two threads per suffix-array row, for Hopper
// (sm_90a).
//
// Replaces the XLA program `device_locate`
// (megapath_tpu/align/seeding_jax.py:1031-1071): a row walks backwards
// through the text by the LF mapping, at most sa_interval + 1 steps,
// until it reaches a row whose text position was sampled; its position
// is then sa_sampled[rank of the mark] + steps. A row not resolved in
// that many steps reads -1, as there. The JAX walk runs every row in
// lockstep for all sa_interval + 1 iterations; here each row stops at
// its mark.
//
// What bounds it on this card: latency, not bytes. A row's walk is a
// chain of dependent steps (the next row is known only once the current
// row's BWT char and rank are), each one load round trip (~0.14 us from
// L2, ~0.35 us from device memory on the H100) plus the instructions
// that turn the loaded row into the next row; a batch's few thousand
// rows leave most of the card idle, so those instructions sit on the
// chain too, and a launch costs ~5 us before any of it.
//
// What the design does about that:
// - One round trip a step. A step reads one 64-byte occ row: the block's
//   occ checkpoint, its 128 BWT chars and its 128 mark bits (the row's
//   last 4 words, indexed by the sentinel-free coordinate adj = r -
//   (r > primary), as the LF step ranks). So the mark test, the BWT char
//   and its rank come from the same fetch. Row `primary` shares its adj
//   with primary + 1, whose bit it is; it holds text position 0, which
//   every sampling marks, so the kernel decides it by comparison. A row
//   leaves the walk at its mark and only then reads its 8-byte mark row
//   (bitmap word and rank checkpoint) for the rank, then sa_sampled.
// - Two lanes a row, each loading half of it (lane 0: checkpoint and BWT
//   words 0-3; lane 1: words 4-7 and the mark bits) and counting the
//   char in its own 4 words. That halves each thread's instructions on
//   the chain and the 16-byte loads a warp issues per row; two shuffles
//   (the mark bit and the char, issued together) and one shuffle-add of
//   the two counts join the halves. One lane a row (all 64 bytes and 8
//   words in one thread) took 0.0120 ms on the toy's 5,910 rows where
//   this takes 0.0091, and four lanes a row (one 16-byte load each, two
//   shuffle-adds) 0.0088 on the toy but 0.0088-0.0089 against 0.0086 on
//   the 512 Mbp shard's 33,334 rows (tools/kernel_turns.py, NVIDIA H100
//   80GB HBM3, 700 W).
// - Words are picked from the loaded uint4s by value, never through a
//   register array indexed at run time (which nvcc places in local
//   memory, a store and a load more inside the chain): ptxas gives the
//   kernel a 0-byte stack frame. The four C[c] counts are loaded once,
//   ahead of the walk.
// - No shared memory: a row's chain is private and its reads are random
//   rows no other row of the block shares. Blocks of 32 rows spread a
//   batch's rows over all 132 SMs (with one lane a row, 32-128 rows a
//   block tied and 256 was 2-3% slower on the toy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 2;  // threads a row
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kLanes * kRowsPerBlock;
constexpr int kRowVecs = 4;  // uint4s a row: occ | words 0-3 | words 4-7 | marks

// word q (0..3) of v, selected by value
__device__ __forceinline__ uint32_t pick(const uint4& v, int q) {
  const uint32_t lo = (q & 1) ? v.y : v.x;
  const uint32_t hi = (q & 1) ? v.w : v.z;
  return (q & 2) ? hi : lo;
}

// chars equal to c among the first max(s, 0) / 2 chars (at most 16) of
// word w: x & (x >> 1) & 0x55555555 with x = ~(w ^ c * 0x55555555) marks
// them, and the funnel shift keeps the low min(s, 32) bits
__device__ __forceinline__ int count_in_word(uint32_t w, uint32_t pat, int s) {
  const uint32_t x = ~(w ^ pat);
  const uint32_t mask = __funnelshift_lc(0xffffffffu, 0u, max(s, 0));
  return __popc(x & (x >> 1) & 0x55555555u & mask);
}

// chars equal to c among the first max(s, 0) / 2 chars of the 4 words
// (64 chars) of v
__device__ __forceinline__ int count_in_words(const uint4& v, uint32_t pat, int s) {
  return count_in_word(v.x, pat, s) + count_in_word(v.y, pat, s - 32) +
         count_in_word(v.z, pat, s - 64) + count_in_word(v.w, pat, s - 96);
}

__global__ void __launch_bounds__(kThreads)
locate_kernel(const int32_t* __restrict__ rows_in, int32_t* __restrict__ out,
              const uint4* __restrict__ fm_rows,
              const int32_t* __restrict__ counts,
              const uint2* __restrict__ mark_rows,
              const int32_t* __restrict__ sa_sampled, int M, int primary,
              int sa_interval) {
  const int t = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  if (t >= M) return;  // a row's two lanes leave together
  const int lane = threadIdx.x % kLanes;
  const unsigned pair = 0x3u << (threadIdx.x & 30);  // the row's lanes in the warp
  const uint4 C = make_uint4(__ldg(counts), __ldg(counts + 1),
                             __ldg(counts + 2), __ldg(counts + 3));
  int r = __ldg(rows_in + t);
  int steps = 0;
  bool marked = false;
  for (; steps <= sa_interval; ++steps) {
    const int adj = r - (r > primary ? 1 : 0);
    const uint4* row = fm_rows + (size_t)(adj >> 7) * kRowVecs + 2 * lane;
    const uint4 a = __ldg(row);      // lane 0: checkpoint; lane 1: words 4-7
    const uint4 b = __ldg(row + 1);  // lane 0: words 0-3;  lane 1: mark bits
    const int rel = adj & 127;
    const uint4 words = lane ? a : b;
    // this lane's candidate char (bits 0-1) and, in lane 1, the mark bit
    // (bit 2); the char is lane rel >> 6's
    uint32_t mine = (pick(words, (rel >> 4) & 3) >> (2 * (rel & 15))) & 3u;
    if (lane) mine |= ((pick(b, rel >> 5) >> (rel & 31)) & 1u) << 2;
    const uint32_t bit = __shfl_sync(pair, mine, 1, kLanes) >> 2;
    const int c = (int)(__shfl_sync(pair, mine, rel >> 6, kLanes) & 3u);
    marked = r == primary || bit;
    if (marked) break;
    // LF step: C[c] + the checkpoint's count of c + c among the block's
    // first rel chars, each lane counting in its 64
    int part = count_in_words(words, (uint32_t)c * 0x55555555u, 2 * rel - 128 * lane);
    if (lane == 0) part += (int)(pick(C, c) + pick(a, c));
    r = part + __shfl_xor_sync(pair, part, 1, kLanes);
  }
  if (lane) return;
  // after the loop: the rank of the mark, then its sampled position
  int pos = -1;
  if (marked) {
    const uint2 m = __ldg(mark_rows + (r >> 5));
    const int rank = (int)m.y + __popc(m.x & ((1u << (r & 31)) - 1u));
    pos = __ldg(sa_sampled + rank) + steps;
  }
  out[t] = pos;
}

}  // namespace

// Locates M full-BWT rows (int32, each in [0, n]) on `stream`, writing
// int32 text positions (-1 where no mark lies within sa_interval + 1
// steps). Tables as built by megapath_tpu_torch/align/seeding_dev.py:
// occ rows [n_blocks + 1][16] uint32 (checkpoints, BWT words, mark bits
// by adj), 16-byte aligned; counts int32 [5]; mark rows
// [ceil((n + 1) / 32)][2] uint32 (bitmap word, rank checkpoint), 8-byte
// aligned; sa_sampled int32. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for M <= 0. Allocates nothing.
extern "C" int mp_locate(const void* rows_in, void* out, const void* fm_rows,
                         const void* counts, const void* mark_rows,
                         const void* sa_sampled, int M, int primary,
                         int sa_interval, void* stream) {
  if (M <= 0 || sa_interval < 0) return (int)cudaErrorInvalidValue;
  locate_kernel<<<(M + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows_in), static_cast<int32_t*>(out),
      static_cast<const uint4*>(fm_rows), static_cast<const int32_t*>(counts),
      static_cast<const uint2*>(mark_rows),
      static_cast<const int32_t*>(sa_sampled), M, primary, sa_interval);
  return (int)cudaGetLastError();
}
