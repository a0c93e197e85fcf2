// MMP seed walk over the FM index, one thread per strand walker, for
// Hopper (sm_90a).
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
// What bounds it on this card: the latency of dependent loads. A walker
// is a chain of up to 3L + 64 iterations, and each step's table rows
// (two 64-byte occ rows, or the k-mer table's two words) are addressed by
// the previous step's result. The bytes are a small fraction of the
// card's rate; a launch costs its longest chain times the time of one
// iteration, and small launches (the exact rescue's) are that chain
// alone. The arithmetic is a few dozen integer operations a step.
//
// What the design does about that: one dependent round trip an
// iteration.
// - One thread per strand walker. A read end's two walkers sit in
//   adjacent lanes (2t, 2t + 1); the one-shot sibling latch, the freeze
//   and the kill are one __shfl_xor_sync(., 1) an iteration. So that the
//   shuffle never runs diverged, the warp's walkers loop together until
//   the last is done; a walker that is done changes nothing more, so each
//   keeps the JAX loop's results. An odd walker count, or a walk without
//   the cull, runs every walker alone.
// - Everything but the table rows is on the chip: the read is packed 2
//   bits a char into shared memory once (at most 64 words for L <= 1023),
//   so the next char is a shared load and the k-mer key two words and a
//   shift; `counts` is in shared memory and the scalars are kernel
//   parameters (constant memory).
// - An iteration issues all its table loads together, through the
//   read-only path (`const __restrict__`, __ldg): the lo row and the hi
//   row (or the two k-mer table words) are both in flight before either
//   is used.
// - Seed slots are staged in shared memory (S <= 16, the engine's
//   max_seeds) and written out once at the end, so nothing is stored to
//   device memory inside the loop.
// - 64-thread blocks, so that a small launch (the exact rescue's ~1,000
//   walkers) spreads over ~16 SMs rather than 4.
// A per-thread iteration counter stands in for the JAX loop's global
// step; a frozen walker spends iterations and no charged steps, as there.
//
// Float32 is part of the contract: the reseed test `sl*ratio < last_len`
// and the progress kill `steps > ratio*i + base` are computed in float32
// by the JAX walk. __fmul_rn/__fadd_rn keep each rounding (no FMA
// contraction), and this file is built with -fmad=false besides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRowWords = 16;  // occ[4] | words[8] | pad[4]
constexpr int kMaxSeeds = 16;  // seed slots a walker, staged in shared memory

struct Fm {
  const uint32_t* __restrict__ rows;  // [n_blocks + 1][16]
  const int32_t* __restrict__ lut_lo;  // [4^k], big-endian k-mer key
  const int32_t* __restrict__ lut_hi;
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

// A walker's seed slots in shared memory: field f of slot s is
// f_[f][s * kThreads].
struct Slots {
  int32_t* f_[4];
  __device__ __forceinline__ int32_t& at(int f, int s) const {
    return f_[f][s * kThreads];
  }
  __device__ __forceinline__ void put(int s, int off, int len, int lo,
                                      int cnt) const {
    at(0, s) = off;
    at(1, s) = len;
    at(2, s) = lo;
    at(3, s) = cnt;
  }
};

// rank of char c among the first `rel` chars (0..128) of a block, plus
// the block's checkpoint, from the row's loaded words: a word's chars
// equal to c are the 1-bits of x & (x >> 1) & 0x55555555 with x = ~(w ^
// c * 0x55555555), and the first 2 * rel bits of the row count
__device__ __forceinline__ int occ_in_row(const uint4& occ, const uint4& wa,
                                          const uint4& wb, int rel, int c) {
  const uint32_t words[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  const uint32_t base = c == 0 ? occ.x : c == 1 ? occ.y : c == 2 ? occ.z
                                                                  : occ.w;
  const uint32_t pat = (uint32_t)c * 0x55555555u;
  int cnt = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint32_t x = ~(words[t] ^ pat);
    // the low min(max(2 * rel - 32 t, 0), 32) bits
    const uint32_t mask =
        __funnelshift_lc(0xffffffffu, 0u, __viaddmax_s32(2 * rel, -32 * t, 0));
    cnt += __popc(x & (x >> 1) & 0x55555555u & mask);
  }
  return (int)base + cnt;
}

// the occ row of full-BWT row `row` and the row's offset in it
__device__ __forceinline__ const uint4* occ_row(const Fm& fm, int row,
                                                int& rel) {
  const int adj = row - (row > fm.primary ? 1 : 0);
  rel = adj & 127;
  return reinterpret_cast<const uint4*>(fm.rows +
                                        (size_t)(adj >> 7) * kRowWords);
}

// CHECK_AND_ADD_RANGE for a walker whose interval would empty (or whose
// walk is exhausted, at_end): reseed rollback, store the seed if there is
// room, and (mid-walk) restart with overlap
__device__ __forceinline__ void emit(Walker& w, bool at_end, int len,
                                     const Fm& fm, const Params& p,
                                     const Slots& out) {
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
    out.put(w.n_seeds, len - w.i, sl, elo, min(ehi - elo, p.sa_thr + 1));
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
// sibling cull decided `active` and `pause`; `seq` is the walker's packed
// read (word q at seq[q * kThreads], char t of a word at bits 30 - 2t)
__device__ __forceinline__ void step(Walker& w, bool pause, int len,
                                     const uint32_t* seq, int L,
                                     const int32_t* counts, const Fm& fm,
                                     const Params& p, const Slots& out) {
  const bool act0 = w.active;
  bool fresh = act0 && w.seed_len == 0 && !pause;
  bool ext = act0 && w.seed_len != 0 && !pause;
  const bool die = fresh && (len - w.i) < p.min_len;
  fresh = fresh && !die;
  const bool done = ext && w.i >= len;
  ext = ext && !done;
  const bool active = act0 && !die && !done;
  if (act0 && !pause) ++w.steps;  // the charged clock

  int nlo = 0, nhi = 0;
  if (fresh || ext) {
    // this iteration's table loads, one group for every walker that steps:
    // both occ rows (a fresh walker's lo/hi are 0 and n_rows, valid rows)
    // and both k-mer table words (an extending walker's key is in range)
    int rel_lo, rel_hi;
    const uint4* rl = occ_row(fm, w.lo, rel_lo);
    const uint4* rh = occ_row(fm, w.hi, rel_hi);
    const uint4 lo0 = __ldg(rl), lo1 = __ldg(rl + 1), lo2 = __ldg(rl + 2);
    const uint4 hi0 = __ldg(rh), hi1 = __ldg(rh + 1), hi2 = __ldg(rh + 2);
    int klo = 0, khi = 0;
    if (fm.lut_k) {
      // big-endian k-mer key starting at len - i - k, A past the row end
      const int j0 = min(max(len - w.i - fm.lut_k, 0), L - 1);
      const uint64_t v = ((uint64_t)seq[(j0 >> 4) * kThreads] << 32) |
                         seq[((j0 >> 4) + 1) * kThreads];
      const int sh = 64 - 2 * (j0 & 15) - 2 * fm.lut_k;
      const int key = (int)((v >> sh) & ((1ull << (2 * fm.lut_k)) - 1ull));
      klo = __ldg(fm.lut_lo + key);
      khi = __ldg(fm.lut_hi + key);
    }
    const int jj = min(max(len - 1 - w.i, 0), L - 1);
    const int c = (int)((seq[(jj >> 4) * kThreads] >> (30 - 2 * (jj & 15))) &
                        3u);
    const int cc = counts[c];
    if (ext) {
      nlo = cc + occ_in_row(lo0, lo1, lo2, rel_lo, c);
      nhi = cc + occ_in_row(hi0, hi1, hi2, rel_hi, c);
    } else if (fm.lut_k) {
      nlo = klo;
      nhi = khi;
    } else {
      nlo = cc;
      nhi = counts[c + 1];
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
  if (done || (ext && !ok)) emit(w, done, len, fm, p, out);
  // a walker whose slots are full can store nothing more
  w.active = w.active && w.n_seeds < p.max_seeds;
}

// kPair: walkers t and half + t (a read end's two strands) in lanes 2t
// and 2t + 1, with the sibling cull; otherwise walker t in thread t.
template <bool kPair>
__global__ void __launch_bounds__(kThreads)
mmp_seed_kernel(const uint8_t* __restrict__ walkers,
                const int32_t* __restrict__ lens,
                const int32_t* __restrict__ counts_in, Fm fm, Params p,
                int32_t* __restrict__ out_off, int32_t* __restrict__ out_len,
                int32_t* __restrict__ out_lo, int32_t* __restrict__ out_cnt,
                int32_t* __restrict__ n_seeds_out, int Wn, int L) {
  extern __shared__ uint32_t smem[];
  const int n_words = (L + 15) / 16 + 1;  // + a zero word past the read
  uint32_t* seq_all = smem;  // [n_words][kThreads]
  int32_t* stage = reinterpret_cast<int32_t*>(smem + n_words * kThreads);
  __shared__ int32_t counts[5];
  const int tid = threadIdx.x;
  const int half = Wn / 2;
  auto walker_of = [&](int t) {
    return kPair ? (t >> 1) + (t & 1) * half : t;
  };
  if (tid < 5) counts[tid] = counts_in[tid];

  // pack the block's reads, 16 chars a word; consecutive threads take
  // consecutive words of one read, so the byte loads coalesce
  const int t0 = blockIdx.x * kThreads;
  for (int item = tid; item < kThreads * n_words; item += kThreads) {
    const int u = item / n_words, q = item % n_words;
    uint32_t word = 0;
    if (t0 + u < Wn) {
      const uint8_t* row = walkers + (size_t)walker_of(t0 + u) * L;
      for (int t = 0; t < 16 && 16 * q + t < L; ++t) {
        word |= ((uint32_t)__ldg(row + 16 * q + t) & 3u) << (30 - 2 * t);
      }
    }
    seq_all[q * kThreads + u] = word;
  }
  __syncthreads();
  const int t = t0 + tid;
  // the warp's lanes that walk (with kPair and Wn even, both lanes of a
  // pair)
  const unsigned live = __ballot_sync(0xffffffffu, t < Wn);
  if (t >= Wn) return;

  const int wid = walker_of(t);
  const int len = lens[wid];
  const uint32_t* seq = seq_all + tid;
  const int S = p.max_seeds;
  int32_t* const outs[4] = {out_off, out_len, out_lo, out_cnt};
  Slots out;
#pragma unroll
  for (int f = 0; f < 4; ++f) out.f_[f] = stage + (f * S) * kThreads + tid;
  Walker w{0, 0, fm.n_rows, 0, 0, fm.n_rows, 0, 0, 0, -1, len >= p.min_len};

  // with the cull, a walker that is done runs on (changing nothing more)
  // until the warp's last one is, so the pair's shuffle runs converged
  for (int it = 0; it < p.limit; ++it) {
    if (!(kPair ? __any_sync(live, w.active) : w.active)) break;
    if (p.charge_limit >= 0) {
      w.active = w.active && (w.steps < p.charge_limit || w.i >= len);
    }
    if (p.kill_on) {
      const float bound = __fadd_rn(
          __fmul_rn(p.kill_ratio, __int2float_rn(w.i)), p.kill_base);
      if (__int2float_rn(w.steps) > bound) w.active = false;
    }
    bool pause = false;
    if (kPair) {
      // one-shot latch at charged step T0 or at retirement: bit 0 probe
      // (a >= good_seed_len extension), bit 1 victim (nothing found yet)
      if (w.sib < 0 && (w.steps >= p.T0 || !w.active)) {
        const bool probe = w.seed_len >= p.good_seed_len;
        const bool victim = w.active && w.n_seeds == 0 && w.last_len == 0 &&
                            w.seed_len < p.min_len;
        w.sib = (probe ? 1 : 0) | (victim ? 2 : 0);
      }
      const int other = __shfl_xor_sync(live, w.sib, 1);
      const bool mine = w.active && w.sib >= 0 && (w.sib & 2);
      pause = mine && other < 0;  // frozen until the sibling latches
      w.active = w.active && !(mine && other >= 0 && (other & 1));
    }
    step(w, pause, len, seq, L, counts, fm, p, out);
  }
  // a walker that ran out of iterations with a live seed at the end
  if (w.active && w.seed_len > 0 && w.i >= len) emit(w, true, len, fm, p, out);
  n_seeds_out[wid] = w.n_seeds;
  const size_t o = (size_t)wid * S;
  for (int k = 0; k < S; ++k) {  // empty slots read as zeros
    const bool full = k < w.n_seeds;
#pragma unroll
    for (int f = 0; f < 4; ++f) outs[f][o + k] = full ? out.at(f, k) : 0;
  }
}

template <bool kPair>
cudaError_t launch(const uint8_t* wk, const int32_t* ln, const int32_t* counts,
                   const Fm& fm, const Params& p, int32_t* off, int32_t* len,
                   int32_t* lo, int32_t* cnt, int32_t* ns, int Wn, int L,
                   cudaStream_t st) {
  const size_t words = (size_t)((L + 15) / 16 + 1) * kThreads;
  // the packed reads, and the staged slots: at most 33 KB for L <= 1023
  const size_t smem = (words + (size_t)4 * p.max_seeds * kThreads) * 4;
  mmp_seed_kernel<kPair><<<(Wn + kThreads - 1) / kThreads, kThreads, smem,
                           st>>>(wk, ln, counts, fm, p, off, len, lo, cnt,
                                 ns, Wn, L);
  return cudaGetLastError();
}

}  // namespace

// Runs the walk on `stream` for Wn walkers (uint8 [Wn, L] codes 0..3,
// int32 lengths). With Wn even and T0 > 0, rows w and Wn/2 + w are one
// read end's two strand walkers and the sibling cull runs; otherwise every
// walker runs alone, as in the JAX walk. S is 1..16. Writes the int32
// slot arrays [Wn, S] (offset, length, SA lo, capped count; zeros past
// n_seeds) and n_seeds [Wn]. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments outside the contract. Allocates
// nothing.
extern "C" int mp_mmp_seed(
    const void* walkers, const void* lens, const void* rows,
    const void* lut_lo, const void* lut_hi, const void* counts,
    void* out_off, void* out_len, void* out_lo, void* out_cnt,
    void* n_seeds, int Wn, int L, int S, int n_rows, int primary, int lut_k,
    int min_len, int reseed_len, int sa_thr, int reseed_abs_diff,
    int good_seed_len, int T0, float reseed_ratio, int kill_on,
    float kill_ratio, float kill_base, int limit, int charge_limit,
    void* stream) {
  if (Wn <= 0 || L <= 0 || L > 1023 || S <= 0 || S > kMaxSeeds ||
      lut_k < 0 || lut_k > 15 ||
      (lut_k > 0 && (lut_lo == nullptr || lut_hi == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Fm fm{static_cast<const uint32_t*>(rows),
              static_cast<const int32_t*>(lut_lo),
              static_cast<const int32_t*>(lut_hi), n_rows, primary, lut_k};
  const Params p{min_len, reseed_len, sa_thr, reseed_abs_diff,
                 good_seed_len, T0, reseed_ratio, kill_ratio, kill_base,
                 kill_on, S, limit, charge_limit};
  const auto* wk = static_cast<const uint8_t*>(walkers);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* ct = static_cast<const int32_t*>(counts);
  auto* o0 = static_cast<int32_t*>(out_off);
  auto* o1 = static_cast<int32_t*>(out_len);
  auto* o2 = static_cast<int32_t*>(out_lo);
  auto* o3 = static_cast<int32_t*>(out_cnt);
  auto* ns = static_cast<int32_t*>(n_seeds);
  auto st = static_cast<cudaStream_t>(stream);
  const bool pair = Wn % 2 == 0 && T0 > 0;
  const cudaError_t err =
      pair ? launch<true>(wk, ln, ct, fm, p, o0, o1, o2, o3, ns, Wn, L, st)
           : launch<false>(wk, ln, ct, fm, p, o0, o1, o2, o3, ns, Wn, L, st);
  return (int)err;
}
