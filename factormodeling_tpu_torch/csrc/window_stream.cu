// Trailing-window streaming ops over [R, D, N] panels: the linear-decay mean,
// the fractional average-tie rank of the newest element, and the ddof=1 std
// and z-score; float and double.
//
// Replaces the Pallas kernel factormodeling_tpu/ops/_pallas_window.py
// (_streaming_call with _decay_step, _rank_step and _moment_step). Per output
// cell (r, t, c) every form walks the W lags j = 0 (the cell itself) .. W - 1
// in that order, as the TPU kernel does:
//   decay:  acc += (W - j) * (valid ? x : 0);  out = acc / (W (W + 1) / 2)
//   rank:   less += x[t-j] < x[t];  eq += x[t-j] == x[t];
//           out = (less + 0.5 (eq + 1)) / W   (NaN compares false; -0 == +0)
//   std:    pass 1: s1, min, max over the lags; mean = s1 / W
//           pass 2: s2 += (x - mean)^2 over the lags; var = s2 / (W - 1)
//           var = 0 when min == max, both finite (a constant window);
//           out = sqrt(var)   (NaN for W = 1)
//   zscore: (x[t] - mean) / std, std == 0 -> NaN
// and every output is NaN unless all W lags are valid (min_periods = W), so
// the moments of a defined output never meet a NaN lag. Rows above date 0
// read as NaN, so the first W - 1 dates are NaN, and all of them when W > D.
// Products, sums, quotients and square roots use the round-to-nearest
// intrinsics, so no multiply-add is contracted and the results equal the
// plain PyTorch versions' operation for operation.
//
// Bound on an H100: operations. A float32 panel at D = 5040, N = 5000 moves
// 0.2 GB (each input read once, each output written once: 0.06 ms at
// 3.35 TB/s). What the inputs need per lag and cell is the form's own
// arithmetic (decay: a multiply and an add; rank: two compares and two
// adds; std / zscore: an add, a min and a max, then a subtract, a multiply
// and an add), and per input cell one valid test (and, for the decay, the
// select of 0): 7.6 GFLOP for the decay at W = 150, 0.11 ms at 67 TFLOP/s.
// That figure counts a fused multiply-add as two operations; with the
// multiply and the add rounded apart, each is an instruction of its own, so
// the reachable floor is twice that, ~0.23 ms.
//
// Design. The TPU kernel carries the last W rows from one date tile to the
// next in VMEM, which works because its grid runs in order; CUDA blocks do not,
// so each block reads the W - 1 rows of history above its tile itself (a halo,
// served by L1/L2). One thread owns one column (consecutive threads take
// consecutive columns, so each load is one coalesced transaction per warp) and
// WIN_ROWS consecutive dates t0 .. t0 + WIN_ROWS - 1. It walks the dates s
// from t0 + WIN_ROWS - 1 down to t0 - W + 1, loads x[s] once into a register
// and applies it to every one of its outputs whose window holds s; for each
// output the lags then arrive in the order j = 0, 1, .., W - 1. The walk has
// three parts (window_walk): the top ramp (the WIN_ROWS - 1 dates above t0,
// which only the later outputs take), the middle (W - WIN_ROWS + 1 dates that
// every output takes) and the bottom ramp (the last WIN_ROWS - 1 dates, which
// only the earlier outputs take). The ramps are unrolled, so which outputs
// take a date is known at compile time; the middle has no range test at all.
// No weight is converted from an integer per lag: the top ramp's weights
// W - j are computed once, the bottom ramp's are compile-time constants, and
// the middle, unrolled by WIN_ROWS dates, takes them from 2 WIN_ROWS - 1
// float subtractions per block (every integer below 2^24 and its differences
// are exact in float, so each weight is the value (T)(W - j) it replaces).
// The valid test runs once per loaded date: a NaN above t0 invalidates the
// outputs from its own date on, and the newest NaN at or below t0 the outputs
// whose window reaches down to it, so two integers replace the per-output
// counts. One pointer walks the column down a date a load, and a tile whose
// walk stays on the panel (all but the first (W - 1) / WIN_ROWS tiles of a
// column and its last) tests no date's range at all. A window shorter than
// the tile (W < WIN_ROWS) takes a short walk with a range test per lag and a
// bit mask of invalid outputs. The loads per output are
// (W + WIN_ROWS - 1) / WIN_ROWS, no shared memory is sized against W, and
// any window length runs. The moment forms walk the window twice (the
// second pass needs the mean). The tile: at D = 5040, N = 5000, W = 150 the
// decay took 0.39-0.40 ms with 16 dates a thread against 0.49 with 8 and
// 0.44-0.56 with 32 (64-256 columns a block within 2.4% of each other), and
// summed over the decay sweep's 17 launches at D = 1332, N = 1000 0.69-0.76
// ms against 0.73-0.76 and 0.79-0.85 (python -m
// factormodeling_tpu_torch.tile_sweep, NVIDIA H100 80GB HBM3, 700 W).
//
// Prediction for this walk, written before its first run on the card: at
// D = 5040, N = 5000, W = 150 in float32 the decay form takes 0.35-0.6 ms
// (the earlier walk, with a range test, an int-to-float conversion and a
// count per lag and output: 1.5758 ms). Measured: 0.52 ms, then 0.39 ms
// with the running pointer and the unchecked tiles (chip_smoke.py, NVIDIA
// H100 80GB HBM3, 700 W); the middle loop holds no I2F and 37 ISETP for
// 256 (date, output) pairs (cuobjdump -sass).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WIN_THREADS 128  // columns per block
#define WIN_ROWS 16      // consecutive dates per thread

enum { FORM_DECAY = 0, FORM_RANK = 1, FORM_STD = 2, FORM_ZSCORE = 3 };

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float sqrt_(float a) {
    return __fsqrt_rn(a);
  }
  static __device__ __forceinline__ float nan() {
    return __int_as_float(0x7fc00000);
  }
  static __device__ __forceinline__ float inf() {
    return __int_as_float(0x7f800000);
  }
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double sqrt_(double a) {
    return __dsqrt_rn(a);
  }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};

// The value under the column pointer q (NaN where the date is off the
// panel, which only a tile at the panel's edge meets: CHECK), then one date
// back.
template <bool CHECK, typename T>
__device__ __forceinline__ T load_back(const T*& q, int N, bool on_panel) {
  const T v = !CHECK || on_panel ? __ldg(q) : Arith<T>::nan();
  q -= N;
  return v;
}

// One block of the middle: the dates t0 - d0 - u, u = 0 .. WIN_ROWS - 1 (the
// first `count` of them in the TAIL form), each taken by every output k at
// lag d0 + u + k with weight base - (u + k), base = W - d0.
template <bool TAIL, bool CHECK, typename T, class Pair>
__device__ __forceinline__ void middle_block(const T*& q, int N, int t0,
                                             int d0, int count, T base,
                                             int& lo_nan, Pair& pair) {
  using A = Arith<T>;
  T w[2 * WIN_ROWS - 1];
#pragma unroll
  for (int o = 0; o < 2 * WIN_ROWS - 1; ++o) w[o] = A::sub(base, T(o));
#pragma unroll
  for (int u = 0; u < WIN_ROWS; ++u) {
    if (TAIL && u >= count) break;
    const int s = t0 - d0 - u;
    const T v = load_back<CHECK>(q, N, s >= 0);
    const bool nan_ = isnan(v);
    lo_nan = nan_ ? max(lo_nan, s) : lo_nan;
    const T vz = nan_ ? T(0) : v;
#pragma unroll
    for (int k = 0; k < WIN_ROWS; ++k) pair(k, w[u + k], v, vz);
  }
}

// The walk of one thread's tile for W >= WIN_ROWS: for each date s from
// t0 + WIN_ROWS - 1 down to t0 - W + 1 it calls pair(k, weight, v, vz) for
// every output k whose window holds s (weight = W - j as T for the lag j,
// v the value, vz the value or 0 where it is NaN), so each output takes its
// lags in the order j = 0 .. W - 1. One pointer walks the column down a
// date a load. Returns the mask of outputs whose window holds a NaN (or a
// date above 0). CHECK: some date of the walk is off the panel.
template <bool CHECK, typename T, class Pair>
__device__ __forceinline__ unsigned walk_long(const T* __restrict__ xc, int N,
                                              int D, int t0, int W,
                                              Pair& pair) {
  using A = Arith<T>;
  constexpr int R = WIN_ROWS;
  const T Wf = (T)W;
  const T* q = xc + (int64_t)(t0 + R - 1) * N;
  // top ramp: date t0 + R - 1 - i is lag k - (R - 1 - i) of outputs
  // k >= R - 1 - i; a NaN there invalidates those outputs
  T wj[R - 1];
#pragma unroll
  for (int j = 0; j < R - 1; ++j) wj[j] = A::sub(Wf, T(j));
  int top_bad = R;
#pragma unroll
  for (int i = 0; i < R - 1; ++i) {
    const T v = load_back<CHECK>(q, N, t0 + R - 1 - i < D);
    const bool nan_ = isnan(v);
    top_bad = nan_ ? R - 1 - i : top_bad;
    const T vz = nan_ ? T(0) : v;
#pragma unroll
    for (int k = R - 1 - i; k < R; ++k) pair(k, wj[k - (R - 1 - i)], v, vz);
  }
  // middle: dates t0 - d, d = 0 .. W - R, lag d + k of every output; the
  // newest NaN at or below t0 invalidates outputs k <= lo_nan - t0 + W - 1
  int lo_nan = t0 - W;
  const int mid = W - R + 1;
  T base = Wf;
  int d0 = 0;
  for (; d0 + R <= mid; d0 += R) {
    middle_block<false, CHECK>(q, N, t0, d0, R, base, lo_nan, pair);
    base = A::sub(base, T(R));
  }
  if (d0 < mid)
    middle_block<true, CHECK>(q, N, t0, d0, mid - d0, base, lo_nan, pair);
  // bottom ramp: date t0 - mid - m is lag W - R + 1 + m + k, weight
  // R - 1 - m - k, of outputs k <= R - 2 - m
#pragma unroll
  for (int m = 0; m < R - 1; ++m) {
    const int s = t0 - mid - m;
    const T v = load_back<CHECK>(q, N, s >= 0);
    const bool nan_ = isnan(v);
    lo_nan = nan_ ? max(lo_nan, s) : lo_nan;
    const T vz = nan_ ? T(0) : v;
#pragma unroll
    for (int k = 0; k <= R - 2 - m; ++k) pair(k, T(R - 1 - m - k), v, vz);
  }
  const int cut = lo_nan - t0 + W - 1;
  unsigned bad = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) bad |= (unsigned)(k >= top_bad || k <= cut) << k;
  return bad;
}

// The walk for W < WIN_ROWS: the same dates and order with a range test per
// lag; a NaN at date s invalidates outputs s - t0 .. s - t0 + W - 1, kept as
// bits k + W - 1 of a 64-bit mask.
template <typename T, class Pair>
__device__ __forceinline__ unsigned walk_short(const T* __restrict__ xc,
                                               int N, int D, int t0, int W,
                                               Pair& pair) {
  using A = Arith<T>;
  constexpr int R = WIN_ROWS;
  const unsigned long long wmask = (1ull << W) - 1;
  unsigned long long badm = 0;
  T b = (T)(W + R - 1);  // W - j + k at step i is W + R - 1 - i
  for (int i = 0; i < R + W - 1; ++i) {
    const int s = t0 + R - 1 - i;
    const T v = (s >= 0 && s < D) ? __ldg(xc + (int64_t)s * N) : A::nan();
    const bool nan_ = isnan(v);
    if (nan_) badm |= wmask << (R + W - 2 - i);
    const T vz = nan_ ? T(0) : v;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = k + i - (R - 1);
      if (j >= 0 && j < W) pair(k, A::sub(b, T(k)), v, vz);
    }
    b = A::sub(b, T(1));
  }
  unsigned bad = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) bad |= (unsigned)((badm >> (k + W - 1)) & 1) << k;
  return bad;
}

template <typename T, class Pair>
__device__ __forceinline__ unsigned window_walk(const T* __restrict__ xc,
                                                int N, int D, int t0, int W,
                                                Pair& pair) {
  if (W < WIN_ROWS) return walk_short<T>(xc, N, D, t0, W, pair);
  // most tiles walk dates on the panel only: no range test at all
  if (t0 - W + 1 >= 0 && t0 + WIN_ROWS - 1 < D)
    return walk_long<false, T>(xc, N, D, t0, W, pair);
  return walk_long<true, T>(xc, N, D, t0, W, pair);
}

template <typename T>
struct DecayPair {
  T acc[WIN_ROWS];
  __device__ __forceinline__ void operator()(int k, T w, T, T vz) {
    acc[k] = Arith<T>::add(acc[k], Arith<T>::mul(w, vz));
  }
};

template <typename T>
struct RankPair {
  T cur[WIN_ROWS];
  int less[WIN_ROWS], eq[WIN_ROWS];
  __device__ __forceinline__ void operator()(int k, T, T v, T) {
    less[k] += v < cur[k];
    eq[k] += v == cur[k];
  }
};

template <typename T>
struct MomentPair {  // pass 1
  T s1[WIN_ROWS], mn[WIN_ROWS], mx[WIN_ROWS];
  __device__ __forceinline__ void operator()(int k, T, T v, T) {
    s1[k] = Arith<T>::add(s1[k], v);
    mn[k] = v < mn[k] ? v : mn[k];
    mx[k] = v > mx[k] ? v : mx[k];
  }
};

template <typename T>
struct SquarePair {  // pass 2
  T mean[WIN_ROWS], s2[WIN_ROWS];
  __device__ __forceinline__ void operator()(int k, T, T v, T) {
    const T dev = Arith<T>::sub(v, mean[k]);
    s2[k] = Arith<T>::add(s2[k], Arith<T>::mul(dev, dev));
  }
};

template <typename T, int FORM>
__global__ void __launch_bounds__(WIN_THREADS)
window_stream_kernel(const T* __restrict__ x, T* __restrict__ out, int D,
                     int N, int W, int col_blocks, int row_blocks) {
  using A = Arith<T>;
  constexpr int R = WIN_ROWS;
  const int64_t b = blockIdx.x;
  const int cb = (int)(b % col_blocks);
  const int64_t rest = b / col_blocks;
  const int t0 = (int)(rest % row_blocks) * R;
  const int64_t r = rest / row_blocks;
  const int c = cb * WIN_THREADS + threadIdx.x;
  if (c >= N) return;
  const T* xc = x + r * (int64_t)D * N + c;
  T* oc = out + r * (int64_t)D * N + c;
  const T NaN = A::nan();

  if (FORM == FORM_DECAY) {
    DecayPair<T> p;
#pragma unroll
    for (int k = 0; k < R; ++k) p.acc[k] = T(0);
    const unsigned bad = window_walk<T>(xc, N, D, t0, W, p);
    const T denom = (T)((double)W * (double)(W + 1) / 2.0);
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (t0 + k < D)
        oc[(int64_t)(t0 + k) * N] =
            (bad >> k) & 1 ? NaN : A::div(p.acc[k], denom);
  } else if (FORM == FORM_RANK) {
    RankPair<T> p;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      p.cur[k] = t0 + k < D ? __ldg(xc + (int64_t)(t0 + k) * N) : NaN;
      p.less[k] = p.eq[k] = 0;
    }
    const unsigned bad = window_walk<T>(xc, N, D, t0, W, p);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      // the counts are exact in T; only the division rounds
      const T pct = A::div(A::add((T)p.less[k],
                                  A::mul(T(0.5), A::add((T)p.eq[k], T(1)))),
                           (T)W);
      if (t0 + k < D) oc[(int64_t)(t0 + k) * N] = (bad >> k) & 1 ? NaN : pct;
    }
  } else {  // FORM_STD, FORM_ZSCORE
    MomentPair<T> p;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      p.s1[k] = T(0);
      p.mn[k] = A::inf();
      p.mx[k] = -A::inf();
    }
    const unsigned bad = window_walk<T>(xc, N, D, t0, W, p);
    SquarePair<T> q;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      q.mean[k] = A::div(p.s1[k], (T)W);
      q.s2[k] = T(0);
    }
    if (W > 1) window_walk<T>(xc, N, D, t0, W, q);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      T var;
      if (W <= 1) {
        var = NaN;  // ddof=1 with one observation
      } else {
        var = A::div(q.s2[k], (T)(W - 1));
        if (p.mn[k] == p.mx[k] && isfinite(p.mn[k]) && isfinite(p.mx[k]))
          var = T(0);
      }
      const T sd = A::sqrt_(var);
      T o = sd;
      if (FORM == FORM_ZSCORE) {
        const T cur = t0 + k < D ? __ldg(xc + (int64_t)(t0 + k) * N) : NaN;
        o = A::div(A::sub(cur, q.mean[k]), sd == T(0) ? NaN : sd);
      }
      if (t0 + k < D) oc[(int64_t)(t0 + k) * N] = (bad >> k) & 1 ? NaN : o;
    }
  }
}

template <typename T, int FORM>
static int launch_form(const T* x, T* out, long long R, int D, int N, int W,
                       cudaStream_t stream) {
  const int col_blocks = (N + WIN_THREADS - 1) / WIN_THREADS;
  const int row_blocks = (D + WIN_ROWS - 1) / WIN_ROWS;
  const long long blocks = R * (long long)col_blocks * row_blocks;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  window_stream_kernel<T, FORM><<<(unsigned)blocks, WIN_THREADS, 0, stream>>>(
      x, out, D, N, W, col_blocks, row_blocks);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* x, T* out, int form, long long R, int D, int N,
                  int W, void* stream) {
  if (R <= 0 || D <= 0 || N <= 0) return 0;
  if (W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case FORM_DECAY:
      return launch_form<T, FORM_DECAY>(x, out, R, D, N, W, s);
    case FORM_RANK:
      return launch_form<T, FORM_RANK>(x, out, R, D, N, W, s);
    case FORM_STD:
      return launch_form<T, FORM_STD>(x, out, R, D, N, W, s);
    case FORM_ZSCORE:
      return launch_form<T, FORM_ZSCORE>(x, out, R, D, N, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fm_window_stream_f32(const float* x, float* out, int form,
                                    long long R, int D, int N, int W,
                                    void* stream) {
  return launch<float>(x, out, form, R, D, N, W, stream);
}

extern "C" int fm_window_stream_f64(const double* x, double* out, int form,
                                    long long R, int D, int N, int W,
                                    void* stream) {
  return launch<double>(x, out, form, R, D, N, W, stream);
}
