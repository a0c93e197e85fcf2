// Affine-gap local alignment under a substitution matrix (BLOSUM62 on the
// protein path): score and end cell of every candidate, for Hopper (sm_90a).
//
// Replaces the XLA program `sw_align_substmat` (megapath_tpu/ops/dp.py:146,
// a jit lax.scan), reached through `sw_align_protein` (:222) from `blastx`
// (megapath_tpu/classify/protein.py:383-390), and computes exactly what it
// computes: per candidate, query codes reads[:read_len] (columns) against
// subject codes refs[:ref_len] (rows), F = max(H + go, F + ge) along a row,
// E the prefix max down a column of H without E, floor 0; score, end_ref
// and end_read, the best cell being the largest score, then the earliest
// column, then the lowest row. A code >= n_codes scores 0 against
// everything, as the JAX one-hot rows make it.
//
// What bounds it on this card: integer issue. A candidate moves R + W + 20
// bytes for read_len * ref_len cells, so memory is never the limit; each
// cell costs the SM about 12 lane-instructions here (F an add and an
// add-max, the substitution score a shared-memory load, H without E one
// add-max-relu, H a max, the next row's E an add and an add-max, the
// running best a compare and three selects), at 64 integer lanes a clock,
// plus a step's shuffles and bookkeeping shared by a lane's rows. A batch
// of a few long frames among short ones is instead bound by the long
// candidates' steps, one after another in their warp (~0.3 us a step on an
// H100: 3.1 ms for 9,873 columns, chip_smoke.py / tools/kernel_turns.py).
//
// What the design does about that:
// - One warp a candidate, a skewed wavefront over the subject rows: lane k
//   owns a stripe of rows and works query column s - k at step s, so the
//   column's gap chain is the sequential recurrence E[i+1] = max(E[i] + ge,
//   H_noE[i] + go) down the lane's rows, the same values as the JAX prefix
//   max of H_noE + go - i * ge for any go and ge, and one pair of
//   __shfl_up_sync a step hands the stripe's last H and its outgoing E to
//   lane k + 1. No block barrier and no scan a column.
// - A candidate's loop stops at its own read_len and its rows at its own
//   ref_len (rows past it feed no row above), so the padding a blastx batch
//   carries up to its longest frame and window costs nothing but the load
//   of two lengths.
// - No width limit: the subject is cut into tiles of at most 32 x kMaxRows
//   rows, all lanes given equal stripes; a tile's last row (its H and its
//   outgoing E, per column) goes to a scratch row the next tile's lane 0
//   reads, two scratch rows a candidate used in turns. Each lane keeps the
//   first of its best cells in a tile (strict >, in column-then-row order),
//   then merges it into its best by the full key, and the warp reduces the
//   key once at the end.
// - The substitution table sits in shared memory with a zero row and
//   column for codes >= n_codes; a lane keeps its rows' table offsets, H and
//   F in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // candidates a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// subject rows a lane holds in a tile: a tile is up to 512 rows
constexpr int kMaxRows = 16;
constexpr int kTile = 32 * kMaxRows;
constexpr int kMaxCodes = 32;
// NEG of ops/dp.py: E into a tile's first row and F before the first column
constexpr int kNeg = -1000000;

// does (s, j, i) beat (bs, bj, bi): the larger score, then the lower
// column, then the lower row
__device__ __forceinline__ bool beats(int s, int j, int i, int bs, int bj, int bi) {
  return s > bs || (s == bs && (j < bj || (j == bj && i < bi)));
}

__global__ void __launch_bounds__(kThreads)
sw_subst_kernel(const uint8_t* __restrict__ reads, const uint8_t* __restrict__ refs,
                const int* __restrict__ read_lens, const int* __restrict__ ref_lens,
                const int* __restrict__ subst, int n_codes,
                int* __restrict__ out_score, int* __restrict__ out_end_ref,
                int* __restrict__ out_end_read, int2* __restrict__ carry, int B, int R,
                int W, int go, int ge) {
  __shared__ int tab[(kMaxCodes + 1) * (kMaxCodes + 1)];
  const int nc1 = n_codes + 1;
  for (int t = threadIdx.x; t < nc1 * nc1; t += blockDim.x) {
    const int a = t / nc1, b = t % nc1;
    tab[t] = (a < n_codes && b < n_codes) ? subst[a * n_codes + b] : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cand >= B) return;
  const int n_cols = min(max(read_lens[cand], 0), R);
  const int n_rows = min(max(ref_lens[cand], 0), W);
  const uint8_t* rd = reads + (size_t)cand * R;
  const uint8_t* rf = refs + (size_t)cand * W;

  // this lane's best cell over all tiles: (score, column, row), 0-based
  int best = 0, bj = 0, bi = 0;
  if (n_cols > 0 && n_rows > 0) {
    const int tiles0 = (n_rows + kTile - 1) / kTile;
    const int per_lane = (n_rows + 32 * tiles0 - 1) / (32 * tiles0);
    const int tile_rows = 32 * per_lane;
    const int n_tiles = (n_rows + tile_rows - 1) / tile_rows;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int r0 = tile * tile_rows + lane * per_lane;
      const int nr = min(max(n_rows - r0, 0), per_lane);
      const bool has_in = tile > 0, has_out = tile + 1 < n_tiles;
      const int2* cin = carry + ((size_t)cand * 2 + (tile & 1)) * R;
      int2* cout = carry + ((size_t)cand * 2 + ((tile + 1) & 1)) * R;
      int off[kMaxRows], H[kMaxRows], F[kMaxRows];
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) {
        const int c = k < nr ? rf[r0 + k] : 0;
        off[k] = c < n_codes ? c : n_codes;
        H[k] = 0;
        F[k] = kNeg;
      }
      // the row above this lane's first row: its H at the previous column
      int h_up = 0;
      // what this lane hands down at the end of a step: its last row's H
      // and the E going into the row below
      int send_h = 0, send_e = kNeg;
      int tb = 0, tj = 0, ti = 0;  // the first best cell of this tile
      const int n_steps = n_cols + 31;
      for (int s = 0; s < n_steps; ++s) {
        int rh = __shfl_up_sync(kFull, send_h, 1);
        int re = __shfl_up_sync(kFull, send_e, 1);
        const int j = s - lane;
        if (j < 0 || j >= n_cols) continue;
        if (lane == 0) {
          rh = 0;
          re = kNeg;
          if (has_in) {
            const int2 v = cin[j];
            rh = v.x;
            re = v.y;
          }
        }
        const int* row = tab + (rd[j] < n_codes ? rd[j] : n_codes) * nc1;
        int diag = h_up;
        int e = re;
        send_h = rh;  // a lane past the last row passes both values on
#pragma unroll
        for (int k = 0; k < kMaxRows; ++k) {
          if (k >= nr) break;
          const int hp = H[k];
          const int f = __viaddmax_s32(hp, go, F[k] + ge);
          const int hne = __viaddmax_s32_relu(diag, row[off[k]], f);
          const int h = max(hne, e);
          e = __viaddmax_s32(hne, go, e + ge);
          diag = hp;
          H[k] = h;
          F[k] = f;
          send_h = h;
          if (h > tb) {
            tb = h;
            tj = j;
            ti = r0 + k;
          }
        }
        h_up = rh;
        send_e = e;
        if (lane == 31 && has_out) cout[j] = make_int2(send_h, send_e);
      }
      if (tb > 0 && beats(tb, tj, ti, best, bj, bi)) {
        best = tb;
        bj = tj;
        bi = ti;
      }
      // the scratch row lane 31 wrote is read by lane 0 in the next tile
      __syncwarp();
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int os = __shfl_xor_sync(kFull, best, d);
    const int oj = __shfl_xor_sync(kFull, bj, d);
    const int oi = __shfl_xor_sync(kFull, bi, d);
    if (beats(os, oj, oi, best, bj, bi)) {
      best = os;
      bj = oj;
      bi = oi;
    }
  }
  if (lane == 0) {
    out_score[cand] = best;
    out_end_ref[cand] = best > 0 ? bi + 1 : 0;
    out_end_read[cand] = best > 0 ? bj + 1 : 0;
  }
}

}  // namespace

extern "C" {

// rows of the subject a tile holds: windows wider than this need the
// scratch rows `carry` ([B][2][R] int2), narrower ones may pass NULL
int mp_sw_subst_tile_rows() { return kTile; }

// reads uint8 [B, R], refs uint8 [B, W], lengths int32 [B], subst int32
// [n_codes, n_codes] (1 <= n_codes <= 32), outputs int32 [B] each. Returns
// cudaGetLastError() after the launch.
int mp_sw_subst(const void* reads, const void* refs, const void* read_lens,
                const void* ref_lens, const void* subst, void* score, void* end_ref,
                void* end_read, void* carry, int B, int R, int W, int n_codes, int go,
                int ge, void* stream) {
  if (n_codes < 1 || n_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  if (W > kTile && carry == nullptr) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int blocks = (B + kWarps - 1) / kWarps;
    sw_subst_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const uint8_t*)refs, (const int*)read_lens,
        (const int*)ref_lens, (const int*)subst, n_codes, (int*)score, (int*)end_ref,
        (int*)end_read, (int2*)carry, B, R, W, go, ge);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
