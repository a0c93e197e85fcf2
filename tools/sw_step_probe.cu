// Where a step of the protein DP's wavefront (megapath_tpu_torch/csrc/
// sw_subst.cu) spends its clocks, for `tools/kernel_turns.py --step-split`.
//
// One warp, alone on the card, walks one candidate's n_cols query columns
// over 32 * kRows subject rows with the step of the kernel, cut into parts
// by the template switches; lane 0 reads clock64() around the loop, so
// elapsed clocks over (n_cols + 31) steps is a step's latency when nothing
// hides it (a long candidate's warp in a padded blastx batch runs so):
// - kPart 0: the two __shfl_up_sync that hand H and E down, nothing else;
// - kPart 1: the one-warp kernel's step (commit 9a55593): the shuffles,
//   then each lane loads its query code from global memory and the table
//   row it selects, then kRows rows;
// - kPart 2: the code travels down the wavefront as a third shuffle, lane 0
//   takes it from a register of 32 prefetched codes by one more shuffle,
//   then the table row and kRows rows;
// - kPart 3: kPart 1 with the rows as that kernel wrote them: arrays of 16
//   and a loop that leaves at the lane's row count, kRows, known only at
//   run time.
// With kRows = 0 a part's step still reads the table row its code selects
// and adds one entry into what it hands down, so the load chain is timed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -1000000;

template <int kPart, int kRows>
__global__ void __launch_bounds__(32)
step_probe(const uint8_t* __restrict__ rd, const uint8_t* __restrict__ rf,
           const int* __restrict__ subst, int n_codes, int n_cols, int go, int ge,
           int nr, long long* __restrict__ clocks, int* __restrict__ sink) {
  __shared__ int tab[33 * 33];
  const int nc1 = n_codes + 1;
  for (int t = threadIdx.x; t < nc1 * nc1; t += 32) {
    const int a = t / nc1, b = t % nc1;
    tab[t] = (a < n_codes && b < n_codes) ? subst[a * n_codes + b] : 0;
  }
  __syncwarp();
  const int lane = threadIdx.x;
  // kPart 3 holds 16 rows and walks nr of them
  constexpr int kHeld = kPart == 3 ? 16 : (kRows > 0 ? kRows : 1);
  constexpr int kWalk = kPart == 3 ? 16 : kRows;
  int off[kHeld], H[kHeld], F[kHeld];
#pragma unroll
  for (int k = 0; k < kWalk; ++k) {
    const int c = rf[lane * kRows + k];
    off[k] = c < n_codes ? c : n_codes;
    H[k] = 0;
    F[k] = kNeg;
  }
  int h_up = 0, send_h = 0, send_e = kNeg, send_c = 0, tb = 0, tj = 0;
  int q_cur = lane < n_cols ? rd[lane] : 0;
  int q_next = 32 + lane < n_cols ? rd[32 + lane] : 0;
  const int n_steps = n_cols + 31;
  __syncwarp();
  const long long t0 = clock64();
  for (int s = 0; s < n_steps; ++s) {
    int qc = 0;
    if (kPart == 2) {
      if ((s & 31) == 0 && s > 0) {
        q_cur = q_next;
        q_next = s + 32 + lane < n_cols ? rd[s + 32 + lane] : 0;
      }
      qc = __shfl_sync(kFull, q_cur, s & 31);
    }
    int rh = __shfl_up_sync(kFull, send_h, 1);
    int re = __shfl_up_sync(kFull, send_e, 1);
    int rc = kPart == 2 ? __shfl_up_sync(kFull, send_c, 1) : 0;
    const int j = s - lane;
    if (j < 0 || j >= n_cols) continue;
    if (lane == 0) {
      rh = 0;
      re = kNeg;
      rc = qc < n_codes ? qc : n_codes;
    }
    if (kPart == 0) {
      send_h = max(rh, 0) + (j & 1);
      send_e = max(re, send_h);
      continue;
    }
    if (kPart == 1 || kPart == 3) rc = rd[j] < n_codes ? rd[j] : n_codes;
    const int* row = tab + rc * nc1;
    int diag = h_up, e = re;
    send_h = rh;
    if (kRows == 0) send_h = max(rh + row[lane & 7], 0);
#pragma unroll
    for (int k = 0; k < kWalk; ++k) {
      if (kPart == 3 && k >= nr) break;
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
      }
    }
    h_up = rh;
    send_e = e;
    send_c = rc;
  }
  const long long t1 = clock64();
  if (lane == 0) clocks[0] = t1 - t0;
  sink[lane] = tb + tj + send_h + send_e;
}

template <int kPart>
int launch(int rows, const uint8_t* rd, const uint8_t* rf, const int* subst, int n_codes,
           int n_cols, int go, int ge, long long* clocks, int* sink, cudaStream_t st) {
#define MP_PROBE_ROWS(R)                                                                  \
  case R:                                                                                 \
    step_probe<kPart, R><<<1, 32, 0, st>>>(rd, rf, subst, n_codes, n_cols, go, ge, R,      \
                                           clocks, sink);                                 \
    break;
  switch (rows) {
    MP_PROBE_ROWS(0)
    MP_PROBE_ROWS(1)
    MP_PROBE_ROWS(2)
    MP_PROBE_ROWS(3)
    MP_PROBE_ROWS(4)
    MP_PROBE_ROWS(8)
    MP_PROBE_ROWS(10)
    MP_PROBE_ROWS(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MP_PROBE_ROWS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rd uint8 [n_cols], rf uint8 [32 * rows], subst int32 [n_codes, n_codes]
// (n_codes <= 32), clocks int64 [1], sink int32 [32]; part 0 to 3, rows
// one of 0, 1, 2, 3, 4, 8, 10, 16. Returns cudaGetLastError().
int mp_step_probe(int part, int rows, const void* rd, const void* rf, const void* subst,
                  int n_codes, int n_cols, int go, int ge, void* clocks, void* sink,
                  void* stream) {
  if (n_codes < 1 || n_codes > 32) return (int)cudaErrorInvalidValue;
  auto args = [&](auto fn) {
    return fn(rows, (const uint8_t*)rd, (const uint8_t*)rf, (const int*)subst, n_codes, n_cols,
              go, ge, (long long*)clocks, (int*)sink, (cudaStream_t)stream);
  };
  switch (part) {
    case 0: return args(launch<0>);
    case 1: return args(launch<1>);
    case 2: return args(launch<2>);
    case 3: return args(launch<3>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
