// MMP seed walk over the FM index, one thread per read end, for Hopper
// (sm_90a).
//
// Replaces the XLA program `device_mmp_seed`
// (megapath_tpu/align/seeding_jax.py:339-797), the soap4 MMP state machine
// (soap4/DV-DPfunctions.cpp mmp<0>/mmp<2>) that the TPU runs as one
// lockstep while_loop over all walkers. Per walker (a read, or its
// reverse complement, consumed back to front): a fresh walker jumps k
// chars by the k-mer table; an extending walker prepends one char by two
// rank queries; CHECK_AND_SET_LAST records the state before a narrowing
// step; a failed extension emits a seed with the reseed rollback and
// restarts with overlap; seeds go into at most `max_seeds` slots. The
// bounds are the JAX walk's: the charged-step limit, the progress kill
// and the one-shot sibling cull between a read end's two strand walkers.
// The seeds are equal to the JAX walk's in either table layout: that
// walk's paired/classic rows and its two-phase stall were TPU gather-unit
// choices and are not copied.
//
// What bounds it on this card: dependent loads. Each step of a walker is
// one or two 64-byte row fetches whose address depends on the previous
// step, so a walker is a chain of ~L to ~3L latency-bound loads (the
// occ/LUT tables of a 512 Mbp shard are far beyond L2; the toy shard's
// fit in it). The arithmetic is a few dozen integer operations per step.
//
// What the design does about that: one thread per read end, holding both
// strand walkers (rows i and half+i of the walker matrix), so each thread
// has two independent load chains in flight, the sibling latch, freeze
// and kill stay in the thread's registers, and thousands of threads hide
// each other's latency. There is no lockstep width to compact: a thread
// that is done retires, where the TPU needed the staged compaction. A
// per-thread iteration counter stands in for the JAX loop's global step;
// a frozen walker spends iterations and no charged steps, as it does
// there. One occ row per 128-char block holds the 4 checkpoints and the 8
// packed BWT words, so a rank query is one row fetch plus 8 popcounts.
//
// Float32 is part of the contract: the reseed test `sl*ratio < last_len`
// and the progress kill `steps > ratio*i + base` are computed in float32
// by the JAX walk. __fmul_rn/__fadd_rn keep each rounding (no FMA
// contraction), and this file is built with -fmad=false besides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowWords = 16;  // occ[4] | words[8] | pad[4]

struct Fm {
  const uint32_t* rows;  // [n_blocks + 1][16]
  const int32_t* lut_lo;  // [4^k], big-endian k-mer key
  const int32_t* lut_hi;
  const int32_t* counts;  // [5]
  int n_rows;  // n + 1 full-BWT rows
  int primary;
  int lut_k;
};

struct Params {
  int min_len, reseed_len, sa_thr, reseed_abs_diff, good_seed_len, T0;
  float reseed_ratio, kill_ratio, kill_base;
  int kill_on, max_seeds, limit, charge_limit;  // charge_limit < 0: none
};

struct Walker {
  int i, lo, hi, seed_len, last_lo, last_hi, last_len, n_seeds, steps, sib;
  bool active;
};

struct Out {
  int32_t* off;
  int32_t* len;
  int32_t* lo;
  int32_t* cnt;
};

// rank of char c among the first `rel` chars (0..128) of a block, plus
// the block's checkpoint: one row fetch, 8 popcounts
__device__ __forceinline__ int occ_in_row(const uint32_t* row, int rel,
                                          int c) {
  const uint4 occ = *reinterpret_cast<const uint4*>(row);
  const uint4 wa = *reinterpret_cast<const uint4*>(row + 4);
  const uint4 wb = *reinterpret_cast<const uint4*>(row + 8);
  const uint32_t words[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  const uint32_t base = c == 0 ? occ.x : c == 1 ? occ.y : c == 2 ? occ.z
                                                                  : occ.w;
  const uint32_t pat = (uint32_t)c * 0x55555555u;
  int cnt = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint32_t x = ~(words[t] ^ pat);
    const uint32_t m = x & (x >> 1) & 0x55555555u;
    const int k = min(max(rel - 16 * t, 0), 16);
    const uint32_t mask = k >= 16 ? 0xffffffffu : ((1u << (2 * k)) - 1u);
    cnt += __popc(m & mask);
  }
  return (int)base + cnt;
}

__device__ __forceinline__ int occ_full(const Fm& fm, int row, int c) {
  const int adj = row - (row > fm.primary ? 1 : 0);
  return occ_in_row(fm.rows + (size_t)(adj >> 7) * kRowWords, adj & 127, c);
}

// CHECK_AND_ADD_RANGE for a walker whose interval would empty (or whose
// walk is exhausted, at_end): reseed rollback, store the seed if there is
// room, and (mid-walk) restart with overlap
__device__ __forceinline__ void emit(Walker& w, bool at_end, int len,
                                     const Fm& fm, const Params& p,
                                     const Out& out, size_t slot0) {
  int sl = w.seed_len;
  const bool rb =
      sl >= p.min_len && sl >= p.reseed_len &&
      (w.last_hi - w.last_lo) <= p.sa_thr &&
      ((sl - w.last_len) <= p.reseed_abs_diff ||
       __fmul_rn(__int2float_rn(sl), p.reseed_ratio) <
           __int2float_rn(w.last_len));
  const int diff = rb ? sl - w.last_len : 0;
  const int elo = rb ? w.last_lo : w.lo;
  const int ehi = rb ? w.last_hi : w.hi;
  sl = rb ? w.last_len : sl;
  if (sl >= p.min_len && w.n_seeds < p.max_seeds) {
    const size_t s = slot0 + w.n_seeds;
    out.off[s] = len - w.i;
    out.len[s] = sl;
    out.lo[s] = elo;
    out.cnt[s] = min(ehi - elo, p.sa_thr + 1);
    ++w.n_seeds;
  }
  if (at_end) {
    w.seed_len = sl;
  } else {
    w.i -= diff + min(sl, p.min_len) - 1;
    w.lo = 0;
    w.hi = fm.n_rows;
    w.seed_len = 0;
    w.last_lo = 0;
    w.last_hi = fm.n_rows;
    w.last_len = 0;
  }
}

// one iteration of the walk body for one walker, after the kill and the
// sibling cull decided `active` and `pause`
__device__ __forceinline__ void step(Walker& w, bool pause, int len,
                                     const uint8_t* __restrict__ seq, int L,
                                     const Fm& fm, const Params& p,
                                     const Out& out, size_t slot0) {
  const bool act0 = w.active;
  bool fresh = act0 && w.seed_len == 0 && !pause;
  bool ext = act0 && w.seed_len != 0 && !pause;
  const bool die = fresh && (len - w.i) < p.min_len;
  fresh = fresh && !die;
  const bool done = ext && w.i >= len;
  ext = ext && !done;
  bool active = act0 && !die && !done;
  if (act0 && !pause) ++w.steps;  // the charged clock

  int nlo = 0, nhi = 0;
  if (fresh || ext) {
    const int jj = min(max(len - 1 - w.i, 0), L - 1);
    const int c = seq[jj];
    if (fresh && fm.lut_k) {
      // big-endian k-mer key starting at len - i - k, A past the row end
      const int j0 = min(max(len - w.i - fm.lut_k, 0), L - 1);
      int key = 0;
      for (int t = 0; t < fm.lut_k; ++t) {
        key = key * 4 + (j0 + t < L ? (int)seq[j0 + t] : 0);
      }
      nlo = fm.lut_lo[key];
      nhi = fm.lut_hi[key];
    } else if (fresh) {
      nlo = fm.counts[c];
      nhi = fm.counts[c + 1];
    } else {
      const int cc = fm.counts[c];
      nlo = cc + occ_full(fm, w.lo, c);
      nhi = cc + occ_full(fm, w.hi, c);
    }
  }
  const bool ok = nlo < nhi;
  if (ext && ok && w.seed_len >= p.min_len && (nhi - nlo) < (w.hi - w.lo)) {
    w.last_lo = w.lo;  // CHECK_AND_SET_LAST
    w.last_hi = w.hi;
    w.last_len = w.seed_len;
  }
  if ((fresh || ext) && ok) {
    const int jump = fm.lut_k ? fm.lut_k : 1;
    w.lo = nlo;
    w.hi = nhi;
    w.seed_len = fresh ? jump : w.seed_len + 1;
    w.i += fresh ? jump : 1;
  }
  w.active = active;
  if (fresh && !ok) w.i += 1;  // empty bucket: net advance of one char
  if (done || (ext && !ok)) emit(w, done, len, fm, p, out, slot0);
  // a walker whose slots are full can store nothing more
  w.active = w.active && w.n_seeds < p.max_seeds;
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
mmp_seed_kernel(const uint8_t* __restrict__ walkers,
                const int32_t* __restrict__ lens, Fm fm, Params p, Out out,
                int32_t* __restrict__ n_seeds_out, int n_threads, int half,
                int L, int S) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_threads) return;
  // NW = 2: walkers t and half + t, a read end and its reverse complement
  int wid[NW], len[NW];
  Walker w[NW];
#pragma unroll
  for (int s = 0; s < NW; ++s) {
    wid[s] = t + s * half;
    len[s] = lens[wid[s]];
    w[s] = Walker{0, 0, fm.n_rows, 0, 0, fm.n_rows, 0, 0, 0, -1,
                  len[s] >= p.min_len};
  }
  const bool sibling = NW == 2 && p.T0 > 0;

  for (int it = 0; it < p.limit; ++it) {
    bool any = false;
#pragma unroll
    for (int s = 0; s < NW; ++s) any = any || w[s].active;
    if (!any) break;
#pragma unroll
    for (int s = 0; s < NW; ++s) {
      Walker& v = w[s];
      if (p.charge_limit >= 0) {
        v.active = v.active && (v.steps < p.charge_limit || v.i >= len[s]);
      }
      if (p.kill_on) {
        const float bound = __fadd_rn(
            __fmul_rn(p.kill_ratio, __int2float_rn(v.i)), p.kill_base);
        if (__int2float_rn(v.steps) > bound) v.active = false;
      }
    }
    bool pause[NW];
#pragma unroll
    for (int s = 0; s < NW; ++s) pause[s] = false;
    if (sibling) {
      // one-shot latch at charged step T0 or at retirement: bit 0 probe
      // (a >= good_seed_len extension), bit 1 victim (nothing found yet)
#pragma unroll
      for (int s = 0; s < NW; ++s) {
        Walker& v = w[s];
        if (v.sib < 0 && (v.steps >= p.T0 || !v.active)) {
          const bool probe = v.seed_len >= p.good_seed_len;
          const bool victim = v.active && v.n_seeds == 0 &&
                              v.last_len == 0 && v.seed_len < p.min_len;
          v.sib = (probe ? 1 : 0) | (victim ? 2 : 0);
        }
      }
      bool kill[NW];
#pragma unroll
      for (int s = 0; s < NW; ++s) {
        const int other = w[NW - 1 - s].sib;
        const bool mine = w[s].active && w[s].sib >= 0 && (w[s].sib & 2);
        kill[s] = mine && other >= 0 && (other & 1);
        pause[s] = mine && other < 0;  // frozen until the sibling latches
      }
#pragma unroll
      for (int s = 0; s < NW; ++s) w[s].active = w[s].active && !kill[s];
    }
#pragma unroll
    for (int s = 0; s < NW; ++s) {
      step(w[s], pause[s], len[s], walkers + (size_t)wid[s] * L, L, fm, p,
           out, (size_t)wid[s] * S);
    }
  }
#pragma unroll
  for (int s = 0; s < NW; ++s) {
    // a walker that ran out of iterations with a live seed at the end
    Walker& v = w[s];
    if (v.active && v.seed_len > 0 && v.i >= len[s]) {
      emit(v, true, len[s], fm, p, out, (size_t)wid[s] * S);
    }
    n_seeds_out[wid[s]] = v.n_seeds;
    for (int k = v.n_seeds; k < S; ++k) {  // empty slots read as zeros
      const size_t o = (size_t)wid[s] * S + k;
      out.off[o] = 0;
      out.len[o] = 0;
      out.lo[o] = 0;
      out.cnt[o] = 0;
    }
  }
}

}  // namespace

// Runs the walk on `stream` for Wn walkers (uint8 [Wn, L] codes, int32
// lengths). With Wn even, rows w and Wn/2 + w are one read end's two
// strand walkers (the sibling cull runs when T0 > 0); with Wn odd every
// walker runs alone and the cull is off, as in the JAX walk. Writes the
// int32 slot arrays [Wn, S] (offset, length, SA lo, capped count; zeros
// past n_seeds) and n_seeds [Wn]. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments outside the contract.
// Allocates nothing.
extern "C" int mp_mmp_seed(
    const void* walkers, const void* lens, const void* rows,
    const void* lut_lo, const void* lut_hi, const void* counts,
    void* out_off, void* out_len, void* out_lo, void* out_cnt,
    void* n_seeds, int Wn, int L, int S, int n_rows, int primary, int lut_k,
    int min_len, int reseed_len, int sa_thr, int reseed_abs_diff,
    int good_seed_len, int T0, float reseed_ratio, int kill_on,
    float kill_ratio, float kill_base, int limit, int charge_limit,
    void* stream) {
  if (Wn <= 0 || L <= 0 || S <= 0 || lut_k < 0 || lut_k > 15 ||
      (lut_k > 0 && (lut_lo == nullptr || lut_hi == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Fm fm{static_cast<const uint32_t*>(rows),
              static_cast<const int32_t*>(lut_lo),
              static_cast<const int32_t*>(lut_hi),
              static_cast<const int32_t*>(counts), n_rows, primary, lut_k};
  const Params p{min_len, reseed_len, sa_thr, reseed_abs_diff,
                 good_seed_len, T0, reseed_ratio, kill_ratio, kill_base,
                 kill_on, S, limit, charge_limit};
  const Out out{static_cast<int32_t*>(out_off), static_cast<int32_t*>(out_len),
                static_cast<int32_t*>(out_lo), static_cast<int32_t*>(out_cnt)};
  const auto* wk = static_cast<const uint8_t*>(walkers);
  const auto* ln = static_cast<const int32_t*>(lens);
  auto* ns = static_cast<int32_t*>(n_seeds);
  auto st = static_cast<cudaStream_t>(stream);
  if (Wn % 2 == 0) {
    const int n = Wn / 2;
    mmp_seed_kernel<2><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        wk, ln, fm, p, out, ns, n, n, L, S);
  } else {
    mmp_seed_kernel<1><<<(Wn + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        wk, ln, fm, p, out, ns, Wn, 0, L, S);
  }
  return (int)cudaGetLastError();
}
