// Affine-gap local DP, forward pass (score and end cell) and backward pass
// (start cell), two candidates in the two halves of every register, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dp_full_kernel_t`, reached through
// `sw_align_full_pallas_t` (megapath_tpu/ops/dp_pallas.py:248-427), and
// computes exactly what it computes: the same scores, the same end and
// start cells, the same tie rules. Its row-major twin `_dp_full_kernel`
// (dp_pallas.py:111, reached through `sw_align_full_pallas`) has the same
// contract and needs no kernel of its own here. Compiled with the
// backward pass left out (kBwd = false, `mp_dp_fwd`), the same kernel
// replaces the forward-only Pallas kernel `_dp_kernel` (dp_pallas.py:27,
// reached through `sw_align_pallas` :496 and `sw_align_auto`,
// megapath_tpu/ops/dp.py:120).
//
// What bounds it on this card: integer issue. A candidate moves R + W + 16
// bytes for up to 2 * R * W cells, so memory is never the limit; the SM
// issues integer (and DPX) instructions for 64 lanes a clock, half its
// float rate. With DPX's int16x2 instructions a pair of cells (one of each
// candidate) costs 8.5 lane-instructions here: the substitution score (a
// xor and an add-max), the diagonal add-max with F, H = max(t + go, E, 0),
// F and E one add-max each plus one for max(t, 0) + go, and the position
// key of the running best (a shift-or and half a three-way max). With few
// candidates it is latency: one warp a scheduler runs each row's chain.
//
// What the design does about that:
// - A skewed wavefront instead of a scan across the window. A group of G
//   lanes (8, 16 or 32) holds one candidate pair; lane k owns CH window
//   rows and works read column j - k at step j, so the vertical gap chain
//   is the plain sequential recurrence down a lane's rows, and one pair of
//   __shfl_up_sync a step hands the chunk's last H and its outgoing E to
//   lane k + 1. With gap_open <= gap_extend (the Python wrapper refuses
//   other parameters), E[i+1] = max(E[i] + ge, H[i] + go) =
//   max(E[i] + ge, max(t, 0) + go), t the cell's H without E: one
//   instruction a row on the chain, and the same values as the prefix-max
//   form of megapath_tpu/ops/dp.py:17-21. A pass is R + G - 1 steps.
// - G is the fewest lanes that keep CH <= 32 (32 lanes past W = 1024, CH
//   up to 64) and give the launch about one warp a scheduler; the deep DP
//   of a toy pass (C ~ 20,000, W = 192) runs 8 x 24, a batch of 4,096 runs
//   16 x 12, the mate rescue at W = 1024 runs 32 x 32.
// - int16x2 with DPX: two candidates a register, `__viaddmax_s16x2` and
//   `__viaddmax_s16x2_relu` for every max-plus step. Scores fit: 0 <= H <=
//   min(read_len, win_len) * match <= 1023, which the wrapper checks
//   before it loads this library (on R and W, and on the lengths when
//   the reads are padded past them). F is kept as F - go, which saves the
//   H + go instruction.
// - No masks in the cell loop. Window rows past a candidate's length, and
//   read columns past its read's length, get 9-bit codes that no byte
//   equals. Such a cell can only score below a real cell that comes
//   earlier in the forward order (mismatch, gap open < 0 and gap extend
//   <= 0, which the wrapper checks), so it never wins, and it feeds no
//   real cell. The two halves thus share one loop and take their own
//   read_lens, ref_lens, end_read and end_ref.
// - The running best is a u16x2 max of the key H * 64 + (63 - k): the
//   highest score and, in a column, the lowest row. Each lane keeps the
//   first column that raised its best (strict >); the group reduces
//   (score, j, i) once a pass.
// - The backward pass is the forward pass over the reversed prefixes
//   read[:end_read][::-1] x window[:end_ref][::-1], as the plain version
//   computes it (ops/dp.py `sw_align_full`): its end cell is the distance
//   back to the start, and its forward tie rules are the contract's
//   backward ones (the highest j, then the highest i).
// - Window codes sit in registers as 9-bit pairs, H and F as int16x2: a
//   row costs three registers, and W <= 1152 (CH <= 36) does not spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// The widest window this library takes: 32 lanes x 64 rows. The engine's
// widest window is the mate rescue's round_up(750 + L + 62, 128) = 1920 at
// its longest read, L = 1023.
constexpr int kMaxWidth = 32 * 64;
// A byte is 0..255. A window row past the candidate's length and a read
// column past its read's length take codes that no byte, and not each
// other, equals.
constexpr uint32_t kNoRow = 256u;
constexpr uint32_t kNoCol = 257u;
// E into the window's first row, below every score the recurrence reaches
constexpr int kNeg = -16384;
// the xor of two equal 9-bit codes after col_code: 511 << 6
constexpr int kEqual = 511 << 6;

// The int16x2 constants of one launch, each value in both halves. F is
// kept as F - go, so the substitution scores carry a -go.
struct Consts {
  uint32_t k_match;   // match - go - kEqual: (codes xor) + k_match
  uint32_t mismatch;  // mismatch - go
  uint32_t go, go2, ge, neg;  // go2 = 2 * go
  uint32_t one;  // 1 in both halves
};

__host__ __device__ __forceinline__ uint32_t splat(int v) {
  return (uint32_t)(v & 0xffff) * 0x10001u;
}

// a window row's codes (low half: candidate a, high half: candidate b)
__device__ __forceinline__ uint32_t row_code(uint32_t a, uint32_t b) {
  return (a << 6) | (b << 22);
}

// a read column's codes, complemented so that `row ^ col` is kEqual in a
// half where the two codes are equal and at most kEqual - 64 elsewhere
__device__ __forceinline__ uint32_t col_code(uint32_t a, uint32_t b) {
  return ((a ^ 0x1ffu) << 6) | ((b ^ 0x1ffu) << 22);
}

// Lexicographic argmax over the G lanes of a group: the highest score,
// then the lowest j, then the lowest i. A butterfly inside the group, so
// every lane of it ends with the same winner.
template <int G>
__device__ __forceinline__ void group_best(int& s, int& j, int& i) {
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) {
    const int os = __shfl_xor_sync(kFull, s, d);
    const int oj = __shfl_xor_sync(kFull, j, d);
    const int oi = __shfl_xor_sync(kFull, i, d);
    if (os > s || (os == s && (oj < j || (oj == j && oi < i)))) {
      s = os;
      j = oj;
      i = oi;
    }
  }
}

// One forward pass of a candidate pair over its group: read column j
// (codes rc[j]) against this lane's window rows r0 .. r0 + CH - 1 (codes
// sel[]), both candidates at once. n_cols is the pair's column count and
// n_steps the warp's step count. Writes each half's best cell (score,
// j + 1, i + 1), (0, 0, 0) when nothing scores; every lane of the group
// gets the same result.
template <int G, int CH>
__device__ __forceinline__ void wave(const uint32_t* __restrict__ rc,
                                     const uint32_t (&sel)[CH], int n_cols,
                                     int n_steps, int last_col, int gl,
                                     const Consts& kc, int (&res)[2][3]) {
  // F[k] holds F - go; the first column's F is max(0 + go, -inf + ge)
  uint32_t H[CH], F[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    H[k] = 0;
    F[k] = 0;
  }
  // what the lane above handed down: its last row's E for this column
  // and its last row's H for this and the previous column
  uint32_t e_in = kc.neg, h_up = 0, h_diag = 0;
  int best[2] = {0, 0}, bj[2] = {0, 0}, bi[2] = {0, 0};
  const int r0 = gl * CH;
  // A lane outside the pair's columns (filling or draining the wavefront)
  // computes with never-match codes: from its first state that keeps H = 0
  // and F - go = 0 (mismatch < 0), and past the last column it can raise
  // no real best (the header's argument), so no branch guards the cells.
  const uint32_t kNone = col_code(kNoCol, kNoCol);
  auto codes = [&](int j) {
    const uint32_t c = rc[min(max(j, 0), last_col)];
    return (unsigned)j < (unsigned)n_cols ? c : kNone;
  };
  // Up to 32 rows a lane, the key's row positions (63 - k in both halves)
  // sit in registers, built from a launch parameter, so that the key is one
  // IMAD (the FMA pipe) and not a shift and an or on the integer pipe,
  // which the DPX steps fill. Wider chunks keep the registers for rows.
  constexpr bool kPosRegs = CH <= 32;
  uint32_t pos[kPosRegs ? CH : 1];
#pragma unroll
  for (int k = 0; k < (kPosRegs ? CH : 1); ++k) {
    pos[k] = (uint32_t)(63 - k) * kc.one;
  }
  uint32_t rcx = codes(-gl);
  for (int s = 0; s < n_steps; ++s) {
    const int j = s - gl;
    const uint32_t rcx_next = codes(j + 1);  // loaded while this step computes
    uint32_t e = e_in;
    uint32_t diag = h_diag;
    uint32_t colkey = 0, pend = 0;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      // t = max(diag + sub, F) - go
      const uint32_t sub =
          __viaddmax_s16x2(sel[k] ^ rcx, kc.k_match, kc.mismatch);
      const uint32_t t = __viaddmax_s16x2(diag, sub, F[k]);
      diag = H[k];
      const uint32_t h = __viaddmax_s16x2_relu(t, kc.go, e);  // max(., E, 0)
      H[k] = h;
      // F - go of the next column: max(F + ge, H + go) - go
      F[k] = __viaddmax_s16x2(F[k], kc.ge, h);
      // the next row's E = max(E + ge, H + go), which while go <= ge is
      // max(E + ge, max(t + go, go)) with t the H without E that the
      // register holds less go: one instruction on the chain down the rows
      e = __viaddmax_s16x2(e, kc.ge, __viaddmax_s16x2(t, kc.go2, kc.go));
      // 0 <= h <= 1023 in each half: the key stays in its half
      const uint32_t key =
          kPosRegs ? h * 64u + pos[kPosRegs ? k : 0]
                   : (h << 6) | ((uint32_t)(63 - k) * 0x10001u);
      if (k & 1) {
        colkey = __vimax3_u16x2(colkey, pend, key);
      } else if (k == CH - 1) {
        colkey = __vimax3_u16x2(colkey, key, key);
      } else {
        pend = key;
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t ck = (colkey >> (16 * q)) & 0xffffu;
      const bool up = (int)(ck >> 6) > best[q];
      best[q] = up ? (int)(ck >> 6) : best[q];
      bj[q] = up ? j + 1 : bj[q];
      bi[q] = up ? r0 + 64 - (int)(ck & 63u) : bi[q];
    }
    uint32_t h_rx = __shfl_up_sync(kFull, H[CH - 1], 1, G);
    uint32_t e_rx = __shfl_up_sync(kFull, e, 1, G);
    if (gl == 0) {  // row -1: H = 0, and no gap runs into row 0
      h_rx = 0;
      e_rx = kc.neg;
    }
    h_diag = h_up;
    h_up = h_rx;
    e_in = e_rx;
    rcx = rcx_next;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    group_best<G>(best[q], bj[q], bi[q]);
    res[q][0] = best[q];
    res[q][1] = bj[q];
    res[q][2] = bi[q];
  }
}

// The warp's step count for a pass: a pair's last column reaches its last
// lane with real rows (rows past both window lengths cannot win, and
// feed no row above them) after n_cols + that lane's index steps.
template <int G, int CH>
__device__ __forceinline__ int pass_steps(int n_cols, int n_rows) {
  const int lanes = min(G, (n_rows + CH - 1) / CH);
  return __reduce_max_sync(kFull, n_cols > 0 ? n_cols + lanes - 1 : 0);
}

template <int G, int CH, bool kBwd>
__global__ void __launch_bounds__(kThreads)
dp_wave_kernel(const uint8_t* __restrict__ reads,
               const uint8_t* __restrict__ refs,
               const int32_t* __restrict__ read_lens,
               const int32_t* __restrict__ ref_lens,
               int32_t* __restrict__ score_out,
               int32_t* __restrict__ end_ref_out,
               int32_t* __restrict__ end_read_out,
               int32_t* __restrict__ start_ref_out,
               int32_t* __restrict__ start_read_out, int C, int R, int W,
               Consts kc) {
  extern __shared__ uint32_t rc_all[];
  constexpr int kGroups = kThreads / G;
  const int gl = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  // a warp with no candidate leaves whole; nothing below waits on the
  // block, only on the warp
  const long long warp_pair =
      (long long)blockIdx.x * kGroups + (threadIdx.x & ~31) / G;
  if (2 * warp_pair >= C) return;
  const long long ca = 2 * ((long long)blockIdx.x * kGroups + grp);

  const uint8_t* rd[2];
  const uint8_t* wn[2];
  int rl[2], wl[2];
  bool has[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const long long c = ca + q;
    has[q] = c < C;  // an odd C leaves the last pair's high half empty
    rl[q] = has[q] ? min(max(read_lens[c], 0), R) : 0;
    wl[q] = has[q] ? min(max(ref_lens[c], 0), W) : 0;
    rd[q] = reads + (has[q] ? c : 0) * R;
    wn[q] = refs + (has[q] ? c : 0) * W;
  }
  uint32_t* rc = rc_all + grp * max(R, 1);
  const int last_col = max(R, 1) - 1;
  const int r0 = gl * CH;

  // ---------------- forward pass ----------------
  for (int j = gl; j < R; j += G) {
    rc[j] = col_code(j < rl[0] ? rd[0][j] : kNoCol,
                     j < rl[1] ? rd[1][j] : kNoCol);
  }
  uint32_t sel[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int row = r0 + k;
    sel[k] = row_code(row < wl[0] ? wn[0][row] : kNoRow,
                      row < wl[1] ? wn[1][row] : kNoRow);
  }
  __syncwarp();
  int n_cols = max(rl[0], rl[1]);
  int fw[2][3];
  wave<G, CH>(rc, sel, n_cols, pass_steps<G, CH>(n_cols, max(wl[0], wl[1])),
              last_col, gl, kc, fw);
  if constexpr (!kBwd) {
    if (gl == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (has[q]) {
          score_out[ca + q] = fw[q][0];
          end_ref_out[ca + q] = fw[q][2];
          end_read_out[ca + q] = fw[q][1];
        }
      }
    }
    return;
  }

  // ---------------- backward pass ----------------
  // the forward pass over read[:end_read][::-1] x window[:end_ref][::-1]
  const int er[2] = {fw[0][1], fw[1][1]};
  const int ef[2] = {fw[0][2], fw[1][2]};
  __syncwarp();  // every lane of the group is done with the forward codes
  for (int j = gl; j < R; j += G) {
    rc[j] = col_code(j < er[0] ? rd[0][er[0] - 1 - j] : kNoCol,
                     j < er[1] ? rd[1][er[1] - 1 - j] : kNoCol);
  }
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int u = r0 + k;
    sel[k] = row_code(u < ef[0] ? wn[0][ef[0] - 1 - u] : kNoRow,
                      u < ef[1] ? wn[1][ef[1] - 1 - u] : kNoRow);
  }
  __syncwarp();
  n_cols = max(er[0], er[1]);
  int bw[2][3];
  wave<G, CH>(rc, sel, n_cols, pass_steps<G, CH>(n_cols, max(ef[0], ef[1])),
              last_col, gl, kc, bw);
  if (gl == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (has[q]) {
        score_out[ca + q] = fw[q][0];
        end_ref_out[ca + q] = ef[q];
        end_read_out[ca + q] = er[q];
        start_ref_out[ca + q] = ef[q] - bw[q][2];
        start_read_out[ca + q] = er[q] - bw[q][1];
      }
    }
  }
}

template <int G, int CH, bool kBwd>
cudaError_t launch(const uint8_t* reads, const uint8_t* refs,
                   const int32_t* read_lens, const int32_t* ref_lens,
                   int32_t* score, int32_t* end_ref, int32_t* end_read,
                   int32_t* start_ref, int32_t* start_read, int C, int R,
                   int W, const Consts& kc, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const long long pairs = (C + 1LL) / 2;
  const int blocks = (int)((pairs + kGroups - 1) / kGroups);
  // one column code word per read column and group
  const size_t smem = (size_t)kGroups * (size_t)(R > 1 ? R : 1) * 4;
  constexpr size_t kDefaultSmem = 48 * 1024, kMaxSmem = 227 * 1024;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_wave_kernel<G, CH, kBwd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dp_wave_kernel<G, CH, kBwd><<<blocks, kThreads, smem, stream>>>(
      reads, refs, read_lens, ref_lens, score, end_ref, end_read, start_ref,
      start_read, C, R, W, kc);
  return cudaGetLastError();
}

// The launch wants about one warp for each of the card's warp schedulers
// (4 an SM); fewer and the cell loop's latency shows.
int target_warps() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 132;
    }
  }
  return 4 * sms;
}

template <bool kBwd, int G>
cudaError_t launch_rows(int ch, const uint8_t* rd, const uint8_t* rf,
                        const int32_t* rl, const int32_t* wl, int32_t* o0,
                        int32_t* o1, int32_t* o2, int32_t* o3, int32_t* o4,
                        int C, int R, int W, const Consts& kc,
                        cudaStream_t st) {
#define MP_LAUNCH(N) \
  launch<G, N, kBwd>(rd, rf, rl, wl, o0, o1, o2, o3, o4, C, R, W, kc, st)
  if (ch <= 4) return MP_LAUNCH(4);
  if (ch <= 6) return MP_LAUNCH(6);
  if (ch <= 8) return MP_LAUNCH(8);
  if (ch <= 12) return MP_LAUNCH(12);
  if (ch <= 16) return MP_LAUNCH(16);
  if (ch <= 24) return MP_LAUNCH(24);
  if constexpr (G < 32) {
    return MP_LAUNCH(32);
  } else {
    if (ch <= 32) return MP_LAUNCH(32);
    if (ch <= 36) return MP_LAUNCH(36);  // W <= 1152, the 2 x 250 bp rescue
    if (ch <= 40) return MP_LAUNCH(40);
    if (ch <= 48) return MP_LAUNCH(48);
    if (ch <= 56) return MP_LAUNCH(56);
    return MP_LAUNCH(64);
  }
#undef MP_LAUNCH
}

// Picks the instantiation: the fewest lanes a pair (8, 16 or 32) that
// keep CH = ceil(W / G) <= 32 rows a lane (32 lanes past W = 1024) and
// give the launch target_warps(); then CH rounded up to a size the
// library holds.
template <bool kBwd>
int dispatch(const void* reads, const void* refs, const void* read_lens,
             const void* ref_lens, void* score, void* end_ref, void* end_read,
             void* start_ref, void* start_read, int C, int R, int W,
             int match, int mismatch, int gap_open, int gap_extend,
             void* stream) {
  if (C <= 0 || R < 0 || W <= 0 || W > kMaxWidth) {
    return (int)cudaErrorInvalidValue;
  }
  const Consts kc{splat(match - gap_open - kEqual), splat(mismatch - gap_open),
                  splat(gap_open), splat(2 * gap_open), splat(gap_extend),
                  splat(kNeg), splat(1)};
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
  const long long pairs = (C + 1LL) / 2;
  int G = 8;
  while (G < 32 && ((W + G - 1) / G > 32 || pairs * G / 32 < target_warps())) {
    G *= 2;
  }
  const int ch = (W + G - 1) / G;
  cudaError_t err;
  if (G == 8) {
    err = launch_rows<kBwd, 8>(ch, rd, rf, rl, wl, o0, o1, o2, o3, o4, C, R, W, kc, st);
  } else if (G == 16) {
    err = launch_rows<kBwd, 16>(ch, rd, rf, rl, wl, o0, o1, o2, o3, o4, C, R, W, kc, st);
  } else {
    err = launch_rows<kBwd, 32>(ch, rd, rf, rl, wl, o0, o1, o2, o3, o4, C, R, W, kc, st);
  }
  return (int)err;
}

}  // namespace

extern "C" int mp_dp_full_max_width() { return kMaxWidth; }

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 when the launch was accepted), or cudaErrorInvalidValue for
// shapes the kernel does not take. Allocates nothing: the caller owns
// every buffer. All arrays are row-major and contiguous: reads [C, R],
// refs [C, W] as uint8 codes, the rest int32 [C]. The scores must keep
// min(read_lens[c], ref_lens[c]) * match <= 1023 for every c (the lengths
// clamped to R and W) with match > 0, mismatch < 0, gap_open < 0,
// gap_open <= gap_extend <= 0 and match - mismatch <= 64 (ops/dp_cuda.py
// checks them before it loads this library).
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
