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
//   std:    pass 1: s1, min, max over the valid lags; mean = s1 / W
//           pass 2: s2 += (x - mean)^2 over the valid lags; var = s2 / (W - 1)
//           var = 0 when min == max, both finite (a constant window);
//           out = sqrt(var)   (NaN for W = 1)
//   zscore: (x[t] - mean) / std, std == 0 -> NaN
// and every output is NaN unless all W lags are valid (min_periods = W).
// Rows above date 0 read as NaN, so the first W - 1 dates are NaN, and all of
// them when W > D. Products, sums, quotients and square roots use the
// round-to-nearest intrinsics, so no multiply-add is contracted and the
// results equal the plain PyTorch versions' operation for operation.
//
// Bound on an H100: operations. A float32 panel at D = 5040, N = 5000 moves
// 0.2 GB (each input read once, each output written once: 0.06 ms at
// 3.35 TB/s), while every cell does 4-12 operations per lag over W = 150 lags
// (15-45 GFLOP: 0.2-0.7 ms at 67 TFLOP/s).
//
// Design. The TPU kernel carries the last W rows from one date tile to the
// next in VMEM, which works because its grid runs in order; CUDA blocks do not,
// so each block reads the W - 1 rows of history above its tile itself (a halo,
// served by L1/L2). One thread owns one column (consecutive threads take
// consecutive columns, so each load is one coalesced transaction per warp) and
// WIN_ROWS consecutive dates t0 .. t0 + WIN_ROWS - 1. It walks the dates s
// from t0 + WIN_ROWS - 1 down to t0 - W + 1, loads x[s] once into a register
// and applies it to every one of its outputs whose window holds s; for each
// output the lags then arrive in the order j = 0, 1, .., W - 1. The loads per
// output drop from W to (W + WIN_ROWS - 1) / WIN_ROWS, no shared memory is
// sized against W, and any window length runs. The moment forms read the
// window twice (the second pass needs the mean).
//
// Prediction, written before the first run on the card: at D = 5040,
// N = 5000, W = 150 in float32 the decay form takes 0.6-1.0 ms, the rank form
// 0.8-1.2 ms and the std / zscore forms 1.2-2.0 ms, 2-4x their bounds: the
// per-lag range test and the predicated updates of the 8 register outputs
// roughly double the operations the bound counts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WIN_THREADS 128  // columns per block
#define WIN_ROWS 8       // consecutive dates per thread

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

template <typename T, int FORM>
__global__ void __launch_bounds__(WIN_THREADS)
window_stream_kernel(const T* __restrict__ x, T* __restrict__ out, int D,
                     int N, int W, int col_blocks, int row_blocks) {
  using A = Arith<T>;
  const int64_t b = blockIdx.x;
  const int cb = (int)(b % col_blocks);
  const int64_t rest = b / col_blocks;
  const int t0 = (int)(rest % row_blocks) * WIN_ROWS;
  const int64_t r = rest / row_blocks;
  const int c = cb * WIN_THREADS + threadIdx.x;
  if (c >= N) return;
  const T* xc = x + r * (int64_t)D * N + c;
  T* oc = out + r * (int64_t)D * N + c;
  const T NaN = A::nan();
  // the value at date s of this column; NaN above date 0 and past the end
  auto at = [&](int s) -> T {
    return (s >= 0 && s < D) ? __ldg(xc + (int64_t)s * N) : NaN;
  };
  const int s_hi = t0 + WIN_ROWS - 1, s_lo = t0 - W + 1;

  T cur[WIN_ROWS];  // the outputs' own values (rank, zscore)
  int cnt[WIN_ROWS];
#pragma unroll
  for (int k = 0; k < WIN_ROWS; ++k) {
    cur[k] = (FORM == FORM_RANK || FORM == FORM_ZSCORE) ? at(t0 + k) : T(0);
    cnt[k] = 0;
  }

  if (FORM == FORM_DECAY) {
    T acc[WIN_ROWS];
#pragma unroll
    for (int k = 0; k < WIN_ROWS; ++k) acc[k] = T(0);
    for (int s = s_hi; s >= s_lo; --s) {
      const T v = at(s);
      const bool ok = !isnan(v);
      const T vz = ok ? v : T(0);
#pragma unroll
      for (int k = 0; k < WIN_ROWS; ++k) {
        const int j = t0 + k - s;  // the lag of date s for output t0 + k
        if (j >= 0 && j < W) {
          acc[k] = A::add(acc[k], A::mul((T)(W - j), vz));
          cnt[k] += ok;
        }
      }
    }
    const T denom = (T)((double)W * (double)(W + 1) / 2.0);
#pragma unroll
    for (int k = 0; k < WIN_ROWS; ++k)
      if (t0 + k < D)
        oc[(int64_t)(t0 + k) * N] = cnt[k] == W ? A::div(acc[k], denom) : NaN;
  } else if (FORM == FORM_RANK) {
    int less[WIN_ROWS], eq[WIN_ROWS];
#pragma unroll
    for (int k = 0; k < WIN_ROWS; ++k) less[k] = eq[k] = 0;
    for (int s = s_hi; s >= s_lo; --s) {
      const T v = at(s);
      const bool ok = !isnan(v);
#pragma unroll
      for (int k = 0; k < WIN_ROWS; ++k) {
        const int j = t0 + k - s;
        if (j >= 0 && j < W) {
          less[k] += v < cur[k];
          eq[k] += v == cur[k];
          cnt[k] += ok;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < WIN_ROWS; ++k) {
      // the counts are exact in T; only the division rounds
      const T pct = A::div(
          A::add((T)less[k], A::mul(T(0.5), A::add((T)eq[k], T(1)))), (T)W);
      if (t0 + k < D) oc[(int64_t)(t0 + k) * N] = cnt[k] == W ? pct : NaN;
    }
  } else {  // FORM_STD, FORM_ZSCORE
    T s1[WIN_ROWS], mn[WIN_ROWS], mx[WIN_ROWS];
#pragma unroll
    for (int k = 0; k < WIN_ROWS; ++k) {
      s1[k] = T(0);
      mn[k] = A::inf();
      mx[k] = -A::inf();
    }
    for (int s = s_hi; s >= s_lo; --s) {
      const T v = at(s);
      const bool ok = !isnan(v);
#pragma unroll
      for (int k = 0; k < WIN_ROWS; ++k) {
        const int j = t0 + k - s;
        if (j >= 0 && j < W && ok) {
          s1[k] = A::add(s1[k], v);
          cnt[k] += 1;
          mn[k] = v < mn[k] ? v : mn[k];
          mx[k] = v > mx[k] ? v : mx[k];
        }
      }
    }
    T mean[WIN_ROWS], s2[WIN_ROWS];
#pragma unroll
    for (int k = 0; k < WIN_ROWS; ++k) {
      mean[k] = A::div(s1[k], (T)W);
      s2[k] = T(0);
    }
    if (W > 1) {
      for (int s = s_hi; s >= s_lo; --s) {
        const T v = at(s);
        if (isnan(v)) continue;  // a NaN lag adds 0 (and gates the output)
#pragma unroll
        for (int k = 0; k < WIN_ROWS; ++k) {
          const int j = t0 + k - s;
          if (j >= 0 && j < W) {
            const T dev = A::sub(v, mean[k]);
            s2[k] = A::add(s2[k], A::mul(dev, dev));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < WIN_ROWS; ++k) {
      T var;
      if (W <= 1) {
        var = NaN;  // ddof=1 with one observation
      } else {
        var = A::div(s2[k], (T)(W - 1));
        if (mn[k] == mx[k] && isfinite(mn[k]) && isfinite(mx[k])) var = T(0);
      }
      const T sd = A::sqrt_(var);
      T o = sd;
      if (FORM == FORM_ZSCORE)
        o = A::div(A::sub(cur[k], mean[k]), sd == T(0) ? NaN : sd);
      if (t0 + k < D) oc[(int64_t)(t0 + k) * N] = cnt[k] == W ? o : NaN;
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
