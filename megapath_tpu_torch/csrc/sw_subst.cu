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
// What bounds it on this card: integer issue when the card is full. A
// candidate moves R + W + 20 bytes for read_len * ref_len cells, so memory
// is never the limit; each cell costs the SM about 12 lane-instructions
// (F an add and an add-max, the substitution score a shared-memory load, H
// without E one add-max-relu, H a max, the next row's E an add and an
// add-max, the running best a compare and three selects), at 64 integer
// lanes a clock, plus a step's shuffles shared by a lane's rows. A batch's
// longest candidates bound it instead when a warp walks one alone: a step
// costs its latency then (tools/kernel_turns.py --step-split), and a
// blastx batch padded to a long contig's frame holds a few candidates of
// ~10,000 columns among thousands of short ones.
//
// What the design does about that:
// - One warp walks a stripe of a candidate's subject rows as a skewed
//   wavefront: lane k owns P rows and works query column s - k at step s,
//   so the column's gap chain is the sequential recurrence E[i+1] = max(E[i]
//   + ge, H_noE[i] + go) down the lane's rows, the same values as the JAX
//   prefix max of H_noE + go - i * ge for any go and ge, and two
//   __shfl_up_sync a step hand the stripe's last H and its outgoing E to
//   lane k + 1. Each lane loads its own query codes, off the step's chain:
//   during a step it loads its next column's scores from the table, by the
//   code it loaded a step before (tools/kernel_turns.py --step-split,
//   NVIDIA H100, a lone warp: the shuffles take 41 clocks a step, a code
//   load and its table row loaded in the step add 33, a code handed down
//   by a third shuffle instead adds 103).
// - The rows a lane P (1 to kMaxRows) is a template constant, so a step's
//   rows are straight code scheduled across rows: 21 clocks a row for a
//   lone warp, against 60 for a loop that leaves at a row count known only
//   at run time (--step-split). A tail lane computes its rows past the
//   window from a zero table column and keeps them out of its best.
// - A persistent schedule, longest first: a grid of resident blocks only
//   takes work items in the order the wrapper sorted the candidates by
//   decreasing critical path n_cols * ceil(n_rows / 32), ties in index
//   order; block b's first item is item b, so the longest start on blocks
//   the card spreads over its SMs (with every item pulled from the
//   counter, the padded batch of tools/kernel_turns.py ran 1.36x longer),
//   and each later item is pulled from a global counter, zeroed on the
//   launch's stream before every launch. Outputs go to each candidate's
//   own index.
// - A long candidate takes a whole block: its rows are cut into kWarps
//   stripes, one a warp, and the warps walk it at once, warp w + 1 behind
//   warp w. Warp w's last row (H and the outgoing E per column) reaches
//   warp w + 1 through a ring of kRing columns in shared memory, guarded by
//   two block-scope counters a ring: the columns written (`done`) and the
//   columns read (`used`), each checked every kChunk steps by the one lane
//   that needs it. At each check the warp below loads the next chunk's
//   columns, one a lane, and lane 0 takes each column's by a shuffle, so
//   no step waits on the ring (nor on a tile's scratch row, read the same
//   way). Eight warps a block (2 rows a lane at W = 297) ran 1.12x slower
//   than four on the padded batch, with spills at 2 blocks an SM. "Long"
//   is the wrapper's rule (ops/protein_cuda.py): a critical path of at
//   least LONG_FACTOR times the batch's total over the card's resident
//   warps, that is a candidate that alone would outlast twice the even
//   share of the batch a warp gets. The first n_long items of the order
//   are the long ones; the rest go kWarps to a block, one a warp.
// - No width limit: a warp's stripe holds at most kTile = 32 x kMaxRows
//   rows, a block's kBlockTile = kWarps x kTile; a taller window is cut into
//   tiles (a warp's or a block's) of equal stripes walked one after another,
//   the tile's last row (H, outgoing E, per column) going to a scratch row
//   the next tile's first lane reads, two scratch rows a candidate used in
//   turns.
// - Exact ties: each lane keeps the first of its best cells in a tile
//   (strict >, in column-then-row order) and merges it into its best by
//   the full key (score, column, row); lanes, warps and tiles merge by the
//   same key.
// - The substitution table sits in shared memory, loaded once a block,
//   with a zero row and column for codes >= n_codes; a lane keeps its rows'
//   table offsets, H and F in registers.
// - A ring wait that outlasts kSpinClocks traps: a fault shows as a failed
//   launch, never as a card that hangs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps a block: kWarps short candidates or one long one
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// subject rows a lane holds in a tile: a warp's tile is up to 512 rows
constexpr int kMaxRows = 16;
constexpr int kTile = 32 * kMaxRows;
constexpr int kBlockTile = kWarps * kTile;
constexpr int kMaxCodes = 32;
// NEG of ops/dp.py: E into a tile's first row and F before the first column
constexpr int kNeg = -1000000;
// steps between the ring counters' checks (a warp's width: the warp loads
// the next chunk's columns of the row above, one a lane, at each check);
// the columns of the ring above, from a chunk's first, written before the
// chunk starts (the two chunks the warp holds), and before the first chunk
// starts (one more, so that a warp that keeps pace with the warp above
// never waits on it again); the columns a ring holds
constexpr int kChunk = 32;
constexpr int kLead = 2 * kChunk;
constexpr int kStartLead = 3 * kChunk;
constexpr int kRing = 8 * kChunk;
constexpr long long kSpinClocks = 1LL << 33;  // ~4 s at 1.98 GHz

// does (s, j, i) beat (bs, bj, bi): the larger score, then the lower
// column, then the lower row
__device__ __forceinline__ bool beats(int s, int j, int i, int bs, int bj, int bi) {
  return s > bs || (s == bs && (j < bj || (j == bj && i < bi)));
}

struct Best {
  int s = 0, j = 0, i = 0;
  __device__ __forceinline__ void merge(int os, int oj, int oi) {
    if (beats(os, oj, oi, s, j, i)) {
      s = os;
      j = oj;
      i = oi;
    }
  }
  // the warp's best by the full key, in every lane
  __device__ __forceinline__ void reduce_warp() {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      merge(__shfl_xor_sync(kFull, s, d), __shfl_xor_sync(kFull, j, d),
            __shfl_xor_sync(kFull, i, d));
    }
  }
};

// a ring between warp w and warp w + 1 of a long candidate's block: the
// last row's H and outgoing E, by column % kRing
struct Ring {
  int2 hv[kRing];
};

struct Shared {
  int tab[(kMaxCodes + 1) * (kMaxCodes + 1)];
  Ring ring[kWarps - 1];
  int done[kWarps - 1];  // columns ring[w] holds, written by warp w's lane 31
  int used[kWarps - 1];  // columns of ring[w] read by warp w + 1's lane 0
  int warp_best[kWarps][3];
  int item;
};

// where a stripe's lane 0 takes the row above from: none (the window's
// first row), a scratch row of global memory, or the ring from the warp
// above; and where its lane 31 puts the stripe's last row
enum { kInNone, kInCarry, kInRing };
enum { kOutNone, kOutCarry, kOutRing };

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *(const volatile int*)p;
}

__device__ __forceinline__ void st_volatile(int* p, int v) { *(volatile int*)p = v; }

// spin until *p >= want, trapping after kSpinClocks (one lane of a warp
// spins, and a long candidate's warps share an SM with few others)
__device__ __forceinline__ void wait_at_least(const int* p, int want) {
  if (ld_volatile(p) >= want) return;
  const long long t0 = clock64();
  while (ld_volatile(p) < want) {
    if (clock64() - t0 > kSpinClocks) __trap();
  }
}

struct Stripe {
  const uint8_t* rd;  // the candidate's query codes
  const uint8_t* rf;  // its subject codes
  int n_cols, n_rows;
  int row0, per_lane;  // the stripe: rows row0 + lane * per_lane, per_lane of them a lane
  int in, out;
  const int2* cin;  // kInCarry: the scratch row to read
  int2* cout;       // kOutCarry: the scratch row to write
  int up;           // kInRing: the ring from the warp above (sh.ring[up])
  int down;         // kOutRing: the ring to the warp below
};

// One warp walks a stripe of a candidate's rows over all its columns, P
// rows a lane, and merges each lane's first best cell of the stripe into
// `best`. Rows past n_rows (a tail lane's) are computed like the others,
// from a zero table column, and kept out of the best: nothing reads them,
// since only a stripe that holds every one of its rows hands its last row
// on. With P a constant the rows' loop is straight code the compiler can
// schedule across rows. Nothing a step waits on but the two shuffles is
// loaded in that step: a lane's scores for its next column are loaded
// during this one, from the code it loaded a step before, and the row
// above comes to lane 0 by shuffle from 32 columns the warp loaded a
// chunk ahead.
template <int P>
__device__ __forceinline__ void walk(Shared& sh, int n_codes, const Stripe& st, int go,
                                     int ge, int lane, Best& best) {
  const int nc1 = n_codes + 1;
  const int n_cols = st.n_cols;
  const int r0 = st.row0 + lane * P;
  const int nr = min(max(st.n_rows - r0, 0), P);
  const bool from_ring = st.in == kInRing, has_in = st.in != kInNone;
  const int* in_row = from_ring ? (const int*)sh.ring[st.up].hv : (const int*)st.cin;
  const int in_mask = from_ring ? kRing - 1 : 0x7fffffff;
  // the row above, (H, outgoing E) of columns s - s % 32 + lane (in_cur)
  // and 32 columns on (in_next), from the ring or the scratch row
  int2 in_cur = make_int2(0, kNeg), in_next = make_int2(0, kNeg);
  // this lane's scores for its column j (sc), the code of column j + 1
  int off[P], H[P], F[P], sc[P];
  const auto code = [&](int j) {
    const int c = j < n_cols ? st.rd[j] : n_codes;
    return c < n_codes ? c : n_codes;
  };
  const int* row = sh.tab + code(0) * nc1;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int c = k < nr ? st.rf[r0 + k] : n_codes;
    off[k] = c < n_codes ? c : n_codes;
    H[k] = 0;
    F[k] = kNeg;
    sc[k] = row[off[k]];
  }
  int code1 = code(1);
  // the row above this lane's first row: its H at the previous column
  int h_up = 0;
  // what this lane hands down at the end of a step: its last row's H and
  // the E going into the row below
  int send_h = 0, send_e = kNeg;
  int tb = 0, tj = 0, ti = 0;  // the first best cell of this stripe
  const int n_steps = n_cols + 31;
  for (int s = 0; s < n_steps; ++s) {
    if ((s & (kChunk - 1)) == 0) {
      // lane 31 has written columns < s - 31; it writes up to s + kChunk - 32
      // in the next kChunk steps, over columns kRing before them
      if (st.out == kOutRing && lane == 31) {
        __threadfence_block();
        st_volatile(&sh.done[st.down], min(max(s - 31, 0), n_cols));
        wait_at_least(&sh.used[st.down], min(s + kChunk - 31 - kRing, n_cols));
        __threadfence_block();
      }
      // the warp has loaded the ring's columns < s; it loads up to
      // s + 2 * kChunk - 1 now
      if (from_ring) {
        if (lane == 0) {
          __threadfence_block();
          st_volatile(&sh.used[st.up], min(s, n_cols));
          wait_at_least(&sh.done[st.up], min(n_cols, s + (s == 0 ? kStartLead : kLead)));
          __threadfence_block();
        }
        __syncwarp();
      }
      if (has_in) {
        const int j0 = s + lane, j1 = s + kChunk + lane;
        if (s == 0) {
          in_next = j0 < n_cols ? *(const int2*)(in_row + 2 * (j0 & in_mask)) : in_next;
        }
        in_cur = in_next;
        if (j1 < n_cols) in_next = *(const int2*)(in_row + 2 * (j1 & in_mask));
      }
    }
    int rh = __shfl_up_sync(kFull, send_h, 1);
    int re = __shfl_up_sync(kFull, send_e, 1);
    int th = 0, te = kNeg;
    if (has_in) {
      th = __shfl_sync(kFull, in_cur.x, s & 31);
      te = __shfl_sync(kFull, in_cur.y, s & 31);
    }
    const int j = s - lane;
    if (j < 0 || j >= n_cols) continue;
    if (lane == 0) {
      rh = th;
      re = te;
    }
    const int* next = sh.tab + code1 * nc1;
    int diag = h_up;
    int e = re;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int score = sc[k];
      sc[k] = next[off[k]];
      const int hp = H[k];
      const int f = __viaddmax_s32(hp, go, F[k] + ge);
      const int hne = __viaddmax_s32_relu(diag, score, f);
      const int h = max(hne, e);
      e = __viaddmax_s32(hne, go, e + ge);
      diag = hp;
      H[k] = h;
      F[k] = f;
      if (h > tb && k < nr) {
        tb = h;
        tj = j;
        ti = r0 + k;
      }
    }
    code1 = code(j + 2);
    h_up = rh;
    send_h = H[P - 1];
    send_e = e;
    if (lane == 31) {
      if (st.out == kOutRing) {
        sh.ring[st.down].hv[j & (kRing - 1)] = make_int2(send_h, send_e);
      } else if (st.out == kOutCarry) {
        st.cout[j] = make_int2(send_h, send_e);
      }
    }
  }
  if (st.out == kOutRing && lane == 31) {
    __threadfence_block();
    st_volatile(&sh.done[st.down], n_cols);
  }
  if (tb > 0) best.merge(tb, tj, ti);
}

// walk<per_lane>: the rows a lane, 1 to kMaxRows, as a constant
__device__ __forceinline__ void walk_rows(Shared& sh, int n_codes, const Stripe& st, int go,
                                          int ge, int lane, Best& best) {
  switch (st.per_lane) {
#define MP_WALK(P)                               \
  case P:                                        \
    walk<P>(sh, n_codes, st, go, ge, lane, best); \
    break;
    MP_WALK(1) MP_WALK(2) MP_WALK(3) MP_WALK(4) MP_WALK(5) MP_WALK(6) MP_WALK(7) MP_WALK(8)
    MP_WALK(9) MP_WALK(10) MP_WALK(11) MP_WALK(12) MP_WALK(13) MP_WALK(14) MP_WALK(15)
    MP_WALK(16)
#undef MP_WALK
  }
}

__device__ __forceinline__ void put(int cand, const Best& b, int* out_score, int* out_end_ref,
                                    int* out_end_read) {
  out_score[cand] = b.s;
  out_end_ref[cand] = b.s > 0 ? b.i + 1 : 0;
  out_end_read[cand] = b.s > 0 ? b.j + 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
sw_subst_kernel(const uint8_t* __restrict__ reads, const uint8_t* __restrict__ refs,
                const int* __restrict__ read_lens, const int* __restrict__ ref_lens,
                const int* __restrict__ subst, int n_codes, int* __restrict__ out_score,
                int* __restrict__ out_end_ref, int* __restrict__ out_end_read,
                int2* __restrict__ carry, const int* __restrict__ order,
                int* __restrict__ sched, int B, int R, int W, int go, int ge) {
  __shared__ Shared sh;
  const int nc1 = n_codes + 1;
  for (int t = threadIdx.x; t < nc1 * nc1; t += blockDim.x) {
    const int a = t / nc1, b = t % nc1;
    sh.tab[t] = (a < n_codes && b < n_codes) ? subst[a * n_codes + b] : 0;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // sched[0] the item counter, sched[1] the long candidates at the front
  // of `order`
  const int n_long = min(max(sched[1], 0), B);
  const int n_items = n_long + (B - n_long + kWarps - 1) / kWarps;
  // a block's first item is its own index, so the first items of the
  // order, the longest, start one to a block on blocks the card spreads
  // over its SMs; later items come from the counter as blocks free up
  for (int first = 1;; first = 0) {
    if (threadIdx.x == 0) sh.item = first ? blockIdx.x : gridDim.x + atomicAdd(&sched[0], 1);
    if (threadIdx.x < kWarps - 1) {
      sh.done[threadIdx.x] = 0;
      sh.used[threadIdx.x] = 0;
    }
    __syncthreads();
    const int item = sh.item;
    if (item >= n_items) return;
    const bool is_long = item < n_long;
    const int slot = is_long ? item : n_long + (item - n_long) * kWarps + warp;
    const int cand = slot < B ? order[slot] : -1;
    const int n_cols = cand < 0 ? 0 : min(max(read_lens[cand], 0), R);
    const int n_rows = cand < 0 ? 0 : min(max(ref_lens[cand], 0), W);
    Stripe st;
    if (cand >= 0) {
      st.rd = reads + (size_t)cand * R;
      st.rf = refs + (size_t)cand * W;
    }
    st.n_cols = n_cols;
    st.n_rows = n_rows;
    Best best;
    if (is_long) {
      // the block's warps walk the candidate's rows a block tile at a time
      if (n_cols > 0 && n_rows > 0) {
        const int tiles0 = (n_rows + kBlockTile - 1) / kBlockTile;
        st.per_lane = (n_rows + 32 * kWarps * tiles0 - 1) / (32 * kWarps * tiles0);
        const int stripe = 32 * st.per_lane;
        const int tile_rows = kWarps * stripe;
        const int n_tiles = (n_rows + tile_rows - 1) / tile_rows;
        st.up = warp - 1;
        st.down = warp;
        for (int tile = 0; tile < n_tiles; ++tile) {
          const int t0 = tile * tile_rows;
          // the warps whose stripes hold rows of this tile
          const int last = min(kWarps, (n_rows - t0 + stripe - 1) / stripe) - 1;
          if (warp <= last) {
            st.row0 = t0 + warp * stripe;
            st.in = warp > 0 ? kInRing : (tile > 0 ? kInCarry : kInNone);
            st.out = warp < last ? kOutRing : (tile + 1 < n_tiles ? kOutCarry : kOutNone);
            st.cin = carry + ((size_t)cand * 2 + (tile & 1)) * R;
            st.cout = carry + ((size_t)cand * 2 + ((tile + 1) & 1)) * R;
            walk_rows(sh, n_codes, st, go, ge, lane, best);
          }
          // the scratch row is read by the next tile's first warp; the
          // rings start over
          __syncthreads();
          if (threadIdx.x < kWarps - 1) {
            sh.done[threadIdx.x] = 0;
            sh.used[threadIdx.x] = 0;
          }
          __syncthreads();
        }
      }
      best.reduce_warp();
      if (lane == 0) {
        sh.warp_best[warp][0] = best.s;
        sh.warp_best[warp][1] = best.j;
        sh.warp_best[warp][2] = best.i;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < kWarps; ++w) {
          best.merge(sh.warp_best[w][0], sh.warp_best[w][1], sh.warp_best[w][2]);
        }
        put(cand, best, out_score, out_end_ref, out_end_read);
      }
    } else if (cand >= 0) {
      // one warp a candidate, tiles of at most kTile rows one after another
      if (n_cols > 0 && n_rows > 0) {
        const int tiles0 = (n_rows + kTile - 1) / kTile;
        const int per_lane = (n_rows + 32 * tiles0 - 1) / (32 * tiles0);
        const int tile_rows = 32 * per_lane;
        const int n_tiles = (n_rows + tile_rows - 1) / tile_rows;
        st.per_lane = per_lane;
        for (int tile = 0; tile < n_tiles; ++tile) {
          st.row0 = tile * tile_rows;
          st.in = tile > 0 ? kInCarry : kInNone;
          st.out = tile + 1 < n_tiles ? kOutCarry : kOutNone;
          st.cin = carry + ((size_t)cand * 2 + (tile & 1)) * R;
          st.cout = carry + ((size_t)cand * 2 + ((tile + 1) & 1)) * R;
          walk_rows(sh, n_codes, st, go, ge, lane, best);
          // the scratch row lane 31 wrote is read by lane 0 in the next tile
          __syncwarp();
        }
      }
      best.reduce_warp();
      if (lane == 0) put(cand, best, out_score, out_end_ref, out_end_read);
    }
    // sh.item, the counters and warp_best are rewritten for the next item
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// rows of the subject a warp's tile holds: windows wider than this need
// the scratch rows `carry` ([B][2][R] int2), narrower ones may pass NULL
int mp_sw_subst_tile_rows() { return kTile; }

// What a launch gets on the current device: out[0] registers a thread,
// out[1] static shared memory a block in bytes, out[2] resident blocks an
// SM, out[3] SMs, out[4] local memory a thread in bytes (spills), out[5]
// warps a block. Returns a CUDA error code.
int mp_sw_subst_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sw_subst_kernel);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, per_sm = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sw_subst_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = per_sm;
  out[3] = sms;
  out[4] = (int)attr.localSizeBytes;
  out[5] = kWarps;
  return 0;
}

// reads uint8 [B, R], refs uint8 [B, W], lengths int32 [B], subst int32
// [n_codes, n_codes] (1 <= n_codes <= 32), outputs int32 [B] each; order
// int32 [B] a permutation of the candidates, longest first, and sched
// int32 [2]: the item counter (zeroed here, on `stream`) and the number of
// long candidates at the front of `order`. `blocks` is the grid, at most
// the resident blocks mp_sw_subst_occupancy gives. Returns
// cudaGetLastError() after the launch.
int mp_sw_subst(const void* reads, const void* refs, const void* read_lens,
                const void* ref_lens, const void* subst, void* score, void* end_ref,
                void* end_read, void* carry, const void* order, void* sched, int B, int R,
                int W, int n_codes, int go, int ge, int blocks, void* stream) {
  if (n_codes < 1 || n_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  if (W > kTile && carry == nullptr) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(sched, 0, sizeof(int), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    sw_subst_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const uint8_t*)refs, (const int*)read_lens,
        (const int*)ref_lens, (const int*)subst, n_codes, (int*)score, (int*)end_ref,
        (int*)end_read, (int2*)carry, (const int*)order, (int*)sched, B, R, W, go, ge);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
