// Affine-gap local DP, forward pass (score and end cell) and mirrored
// backward pass (start cell), one warp per candidate, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dp_full_kernel_t`, reached through
// `sw_align_full_pallas_t` (megapath_tpu/ops/dp_pallas.py:248-427), and
// computes exactly what it computes: the same scores, the same end and
// start cells, the same tie rules. The TPU kernel laid 128 candidates on
// the vector lanes and the window on sublanes; that layout is not copied.
// Its row-major twin `_dp_full_kernel` (dp_pallas.py:111, reached through
// `sw_align_full_pallas`) has the same contract and needs no kernel of
// its own here.
//
// Compiled with the backward pass left out (kBwd = false, `mp_dp_fwd`),
// the same kernel replaces the forward-only Pallas kernel `_dp_kernel`
// (dp_pallas.py:27, reached through `sw_align_pallas` :496 and
// `sw_align_auto`, megapath_tpu/ops/dp.py:120): score, end_ref and
// end_read under the same forward tie rules (strict > across columns, the
// lowest row within a column).
//
// What bounds it on this card: the integer ALU and the shuffle rate. A
// cell is ~10 integer operations (two adds, a compare-select for the
// substitution score, four max) on registers, and a candidate moves
// R + W + 16 bytes from device memory for R * W * 2 cells, so memory is
// never the limit. Each read column also costs a warp scan (5 shuffles),
// a neighbour shuffle and the scan's exclusive shift.
//
// What the design does about that: one warp per candidate, the window
// split across the 32 lanes in contiguous chunks of CH = ceil(W/32) rows
// held in registers (CH is a template argument, so the register arrays
// are static). Per read column a lane updates its CH cells in place,
// takes a 5-step warp scan of the lanes' maxima for the vertical gap
// chain, and keeps its own best cell; the warp reduces the lanes' bests
// once per pass, not once per column. The shuffle work is amortised over
// CH cells. The read is broadcast from shared memory. Scores are int32;
// int16 scores and the DPX max-plus instructions are left for later.
//
// The gap chain within a column is a prefix max of H_noE + go - i*ge
// (megapath_tpu/ops/dp.py:17-21), which holds only while
// gap_open <= gap_extend; the Python wrapper refuses other parameters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kNeg = -1000000;  // the reference's -inf surrogate
constexpr unsigned kFull = 0xffffffffu;
// The widest window this library takes: 32 lanes x 64 rows. The engine's
// widest window is the mate rescue's round_up(750 + L + 62, 128) = 1920 at
// its longest read, L = 1023. The CH = 40-64 instantiations hold three
// arrays of CH ints a lane and may spill registers: slower, not wrong.
constexpr int kMaxWidth = 32 * 64;

struct Scores {
  int match, mismatch, gap_open, gap_extend;
};

// Lexicographic warp argmax over (score, j, i) lanes: the highest score,
// then the lowest (forward) or highest (backward) j, then i likewise.
// A butterfly, so every lane ends with the same winner.
template <bool kLow>
__device__ __forceinline__ void warp_best(int& s, int& j, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int os = __shfl_xor_sync(kFull, s, d);
    const int oj = __shfl_xor_sync(kFull, j, d);
    const int oi = __shfl_xor_sync(kFull, i, d);
    const bool later = kLow ? (oj < j || (oj == j && oi < i))
                            : (oj > j || (oj == j && oi > i));
    if (os > s || (os == s && later)) {
      s = os;
      j = oj;
      i = oi;
    }
  }
}

template <int CH, bool kBwd>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dp_full_kernel(const uint8_t* __restrict__ reads,
               const uint8_t* __restrict__ refs,
               const int32_t* __restrict__ read_lens,
               const int32_t* __restrict__ ref_lens,
               int32_t* __restrict__ score_out,
               int32_t* __restrict__ end_ref_out,
               int32_t* __restrict__ end_read_out,
               int32_t* __restrict__ start_ref_out,
               int32_t* __restrict__ start_read_out,
               int C, int R, int W, Scores sc) {
  extern __shared__ uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * kWarpsPerBlock + warp;
  // the ragged edge: a whole warp leaves, and nothing below waits on the
  // block, only on the warp
  if (c >= C) return;

  uint8_t* rd = smem + warp * R;
  const uint8_t* read = reads + c * R;
  for (int t = lane; t < R; t += 32) rd[t] = read[t];
  __syncwarp();

  const uint8_t* win = refs + c * W;
  const int r0 = lane * CH;
  // rows past W are padding: in the forward pass they lie below every
  // real row and feed nothing back up; in the backward pass they lie
  // past end_ref and are masked like the rows the reference masks
  int wc[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) wc[k] = (r0 + k < W) ? (int)win[r0 + k] : -1;
  const int rl = min(max(read_lens[c], 0), R);
  const int wl = min(max(ref_lens[c], 0), W);

  const int go = sc.gap_open, ge = sc.gap_extend;
  int H[CH], F[CH];

  // ---------------- forward pass ----------------
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    H[k] = 0;
    F[k] = kNeg;
  }
  // this lane's best cell, first in (j, i) order: strict > while j and
  // i ascend keeps the earliest column and, in it, the lowest row
  int best = 0, best_i = 0, best_j = 0;
  for (int j = 0; j < rl; ++j) {
    const int rc = rd[j];
    int up = __shfl_up_sync(kFull, H[CH - 1], 1);
    if (lane == 0) up = 0;
    // H_noE and F, rows in descending order so that H[k-1] is still the
    // previous column's value when row k reads it as its diagonal
#pragma unroll
    for (int k = CH - 1; k >= 0; --k) {
      const int diag = (k > 0) ? H[k - 1] : up;
      const int f = max(H[k] + go, F[k] + ge);
      F[k] = f;
      const int m = diag + (wc[k] == rc ? sc.match : sc.mismatch);
      H[k] = max(max(m, f), 0);
    }
    // E[i] = max_{i' < i} (H_noE[i'] + go - i'*ge) + (i-1)*ge
    int tot = kNeg;
#pragma unroll
    for (int k = 0; k < CH; ++k) tot = max(tot, H[k] + go - (r0 + k) * ge);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, tot, d);
      if (lane >= d) tot = max(tot, o);
    }
    int pre = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) pre = kNeg;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int row = r0 + k;
      const int e = pre + (row - 1) * ge;
      pre = max(pre, H[k] + go - row * ge);
      const int h = max(H[k], e);
      H[k] = h;
      if (row < wl && h > best) {
        best = h;
        best_i = row + 1;
        best_j = j + 1;
      }
    }
  }
  warp_best<true>(best, best_j, best_i);
  const int end_ref = best_i, end_read = best_j;
  if constexpr (!kBwd) {
    if (lane == 0) {
      score_out[c] = best;
      end_ref_out[c] = end_ref;
      end_read_out[c] = end_read;
    }
    return;
  }

  // ---------------- backward pass ----------------
  // the mirrored recurrence over read[:end_read] x window[:end_ref]:
  // the diagonal comes from row i+1, the gap chain is a suffix max
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    H[k] = 0;
    F[k] = kNeg;
  }
  // first in (descending j, descending i) order: the largest column
  // and, in it, the highest row
  int bbest = 0, start_ref = 0, start_read = 0;
  for (int j = end_read - 1; j >= 0; --j) {
    const int rc = rd[j];
    int down = __shfl_down_sync(kFull, H[0], 1);
    if (lane == 31) down = 0;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int row = r0 + k;
      const int diag = (k < CH - 1) ? H[k + 1] : down;
      const int f = max(H[k] + go, F[k] + ge);
      F[k] = f;
      const int sub =
          row < end_ref ? (wc[k] == rc ? sc.match : sc.mismatch) : kNeg;
      H[k] = max(max(diag + sub, f), 0);
    }
    // E'[i] = max_{i' > i} (H_noE[i'] + go + i'*ge) - (i+1)*ge
    int tot = kNeg;
#pragma unroll
    for (int k = 0; k < CH; ++k) tot = max(tot, H[k] + go + (r0 + k) * ge);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(kFull, tot, d);
      if (lane + d < 32) tot = max(tot, o);
    }
    int suf = __shfl_down_sync(kFull, tot, 1);
    if (lane == 31) suf = kNeg;
    int col_best = 0, col_row = 0;
#pragma unroll
    for (int k = CH - 1; k >= 0; --k) {
      const int row = r0 + k;
      const int e = suf - (row + 1) * ge;
      suf = max(suf, H[k] + go + row * ge);
      const int h = max(H[k], e);
      H[k] = h;
      if (row < end_ref && h > col_best) {
        col_best = h;
        col_row = row;
      }
    }
    if (col_best > bbest) {
      bbest = col_best;
      start_ref = col_row;
      start_read = j;
    }
  }
  warp_best<false>(bbest, start_read, start_ref);

  if (lane == 0) {
    score_out[c] = best;
    end_ref_out[c] = end_ref;
    end_read_out[c] = end_read;
    start_ref_out[c] = start_ref;
    start_read_out[c] = start_read;
  }
}

template <int CH, bool kBwd>
cudaError_t launch(const uint8_t* reads, const uint8_t* refs,
                   const int32_t* read_lens, const int32_t* ref_lens,
                   int32_t* score, int32_t* end_ref, int32_t* end_read,
                   int32_t* start_ref, int32_t* start_read, int C, int R,
                   int W, Scores sc, cudaStream_t stream) {
  const int blocks = (C + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)kWarpsPerBlock * R;
  dp_full_kernel<CH, kBwd><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      reads, refs, read_lens, ref_lens, score, end_ref, end_read, start_ref,
      start_read, C, R, W, sc);
  return cudaGetLastError();
}

// Picks the instantiation for W: CH = ceil(W/32) rounded up to the next
// chunk size the library holds.
template <bool kBwd>
int dispatch(const void* reads, const void* refs, const void* read_lens,
             const void* ref_lens, void* score, void* end_ref, void* end_read,
             void* start_ref, void* start_read, int C, int R, int W,
             int match, int mismatch, int gap_open, int gap_extend,
             void* stream) {
  if (C <= 0 || R < 0 || W <= 0 || W > kMaxWidth) {
    return (int)cudaErrorInvalidValue;
  }
  const Scores sc{match, mismatch, gap_open, gap_extend};
  const auto* rd = static_cast<const uint8_t*>(reads);
  const auto* rf = static_cast<const uint8_t*>(refs);
  const auto* rl = static_cast<const int32_t*>(read_lens);
  const auto* wl = static_cast<const int32_t*>(ref_lens);
  auto* o0 = static_cast<int32_t*>(score);
  auto* o1 = static_cast<int32_t*>(end_ref);
  auto* o2 = static_cast<int32_t*>(end_read);
  auto* o3 = static_cast<int32_t*>(start_ref);
  auto* o4 = static_cast<int32_t*>(start_read);
  auto st = static_cast<cudaStream_t>(stream);
  const int ch = (W + 31) / 32;
#define MP_LAUNCH(N) \
  launch<N, kBwd>(rd, rf, rl, wl, o0, o1, o2, o3, o4, C, R, W, sc, st)
  if (ch <= 2) return (int)MP_LAUNCH(2);
  if (ch <= 4) return (int)MP_LAUNCH(4);
  if (ch <= 6) return (int)MP_LAUNCH(6);
  if (ch <= 8) return (int)MP_LAUNCH(8);
  if (ch <= 12) return (int)MP_LAUNCH(12);
  if (ch <= 16) return (int)MP_LAUNCH(16);
  if (ch <= 24) return (int)MP_LAUNCH(24);
  if (ch <= 32) return (int)MP_LAUNCH(32);
  if (ch <= 40) return (int)MP_LAUNCH(40);
  if (ch <= 48) return (int)MP_LAUNCH(48);
  if (ch <= 56) return (int)MP_LAUNCH(56);
  return (int)MP_LAUNCH(64);
#undef MP_LAUNCH
}

}  // namespace

extern "C" int mp_dp_full_max_width() { return kMaxWidth; }

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 when the launch was accepted), or cudaErrorInvalidValue for
// shapes the kernel does not take. Allocates nothing: the caller owns
// every buffer. All arrays are row-major and contiguous: reads [C, R],
// refs [C, W] as uint8 codes, the rest int32 [C].
extern "C" int mp_dp_full(const void* reads, const void* refs,
                          const void* read_lens, const void* ref_lens,
                          void* score, void* end_ref, void* end_read,
                          void* start_ref, void* start_read, int C, int R,
                          int W, int match, int mismatch, int gap_open,
                          int gap_extend, void* stream) {
  return dispatch<true>(reads, refs, read_lens, ref_lens, score, end_ref,
                        end_read, start_ref, start_read, C, R, W, match,
                        mismatch, gap_open, gap_extend, stream);
}

// The forward pass alone: score, end_ref and end_read, as mp_dp_full
// writes them; the same shapes and return codes.
extern "C" int mp_dp_fwd(const void* reads, const void* refs,
                         const void* read_lens, const void* ref_lens,
                         void* score, void* end_ref, void* end_read, int C,
                         int R, int W, int match, int mismatch, int gap_open,
                         int gap_extend, void* stream) {
  return dispatch<false>(reads, refs, read_lens, ref_lens, score, end_ref,
                         end_read, nullptr, nullptr, C, R, W, match,
                         mismatch, gap_open, gap_extend, stream);
}
