// One ADMM segment of the box/L1 QP solver: seg_len iterations at a fixed
// rho in one launch, for B independent problems ("lanes"), one thread block
// per lane; float and double.
//
// Replaces the Pallas kernel factormodeling_tpu/ops/_pallas_admm.py
// (admm_segment, vmapped over lanes): the plain iteration, the safeguarded
// Anderson accelerator (m = anderson > 0), the iterations-to-converge tally
// (collect) and the plain tail of a solve's last segment. Per iteration:
//   rd = (rho (z - u) - q) / d
//   t  = V rd             (T dot products over N, one warp per row)
//   t2 = t kinv           (Woodbury inner inverse, T x T)
//   xt = rd - (t2 V) / d
//   x  = xt - (ge xt) mt + xb      (equality correction, K rows)
//   xr = relax x + (1 - relax) z;  w = xr + u
//   z' = clip(center + soft(w - center, thresh), lo, hi);  u' = w - z'
// then, under Anderson, on v = [z, u] (2N wide) with v_f = [z', u'] and
// g = v_f - v:
//   r = |g|; a residual above safeguard * (best r so far) drops the history
//   and rolls back to the best plain iterate vg; otherwise push the
//   difference rows (v - v_prev, g - g_prev) into the depth-m history S, Y
//   (newest first); gamma solves the masked m x m normal equations of Y
//   (relative ridge, pivot-free Gauss-Jordan, as ops/_linalg.py::aa_mix);
//   cand = v_f - gamma (S + Y); take cand when the history is non-empty, r
//   is the best so far, max(|x - z'|, rho dz) > conv_tol,
//   |cand - v_f| <= step_clamp r, cand is finite, and the iteration lies
//   outside the plain tail of a last segment.
// Stats per lane: dz = max |z' - z| of the last iteration, the accept and
// rollback tallies, and (collect) the first 1-based iteration with
// max(|x - z'|, rho dz) <= conv_tol.
//
// Bound on an H100: neither bytes nor operations. One segment at T = 60,
// N = 1000 moves about 0.6 MB in double and does about 7 MFLOP (Anderson at
// m = 5 adds about 1 MFLOP), a fraction of a microsecond at the card's
// rates; what it waits on is the serial chain of dependent iterations, each
// with two passes over V and a handful of block barriers (about ten under
// Anderson). Design: one block of 1024 threads per lane, so B lanes fill B
// SMs in one launch; the whole segment in one launch instead of ~15 small
// launches per iteration. V ([T, N], 480 KB in double at T = 60, N = 1000)
// stays in device memory, read through the read-only path (L1/L2-resident
// across iterations); kinv and the rd vector live in shared memory, z and u
// in registers of the thread that owns each coordinate (at most 4 per
// thread, hence N <= 4096). The Anderson history (S, Y: 2 m rows of 2N) and
// six 2N scratch rows do not fit beside kinv in shared memory at N = 4096,
// so they live in a per-lane device-memory workspace (160 KB for S and Y at
// m = 5, N = 1000 in double; L2-resident), each row element written by the
// thread that owns its coordinate; the 15 Gram entries and 5 right-hand
// sides of the m x m system are one warp each, and thread 0 solves it.

#include <cuda_runtime.h>
#include <math.h>

#define SEG_THREADS 1024
#define SEG_WARPS (SEG_THREADS / 32)
#define SEG_COLS 4      // coordinates per thread: N <= SEG_THREADS * SEG_COLS
#define SEG_KMAX 4      // equality rows (the leg constraints have 2)
#define AA_MMAX 8       // deepest Anderson history
#define RED_MAX 4       // values in one generic block reduction
#define FULL_MASK 0xffffffffu

// NaN-propagating max/min and sign, like jnp.maximum / minimum / sign.
template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T pmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T psign(T a) {
  return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a);  // sign(0)=0, sign(NaN)=NaN
}

// Block-wide reduction of NV values, value i a NaN-propagating max if bit i
// of is_max is set, else a sum; every thread gets the totals back in v.
template <typename T, int NV>
__device__ __forceinline__ void block_reduce(T (&v)[NV], unsigned is_max,
                                             T* s_red, T* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bool mx = (is_max >> i) & 1u;
    T x = v[i];
    for (int o = 16; o > 0; o >>= 1) {
      const T y = __shfl_down_sync(FULL_MASK, x, o);
      x = mx ? pmax(x, y) : x + y;
    }
    if (lane == 0) s_red[i * SEG_WARPS + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    const int i = threadIdx.x;
    const bool mx = (is_max >> i) & 1u;
    T acc = s_red[i * SEG_WARPS];
    for (int w = 1; w < SEG_WARPS; ++w)
      acc = mx ? pmax(acc, s_red[i * SEG_WARPS + w]) : acc + s_red[i * SEG_WARPS + w];
    s_out[i] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = s_out[i];
}

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static __device__ float tiny() { return 1.17549435e-38f; }
};
template <>
struct Eps<double> {
  static __device__ double tiny() { return 2.2250738585072014e-308; }
};

template <typename T, bool AA>
__global__ void __launch_bounds__(SEG_THREADS)
admm_segment_kernel(const T* __restrict__ d, const T* __restrict__ V,
                    const T* __restrict__ kinv, const T* __restrict__ mt,
                    const T* __restrict__ ge, const T* __restrict__ xb,
                    const T* __restrict__ q, const T* __restrict__ lo,
                    const T* __restrict__ hi, const T* __restrict__ center,
                    const T* __restrict__ thresh, const T* __restrict__ z0,
                    const T* __restrict__ u0, const T* __restrict__ rho_p,
                    T* __restrict__ x_out, T* __restrict__ z_out,
                    T* __restrict__ u_out, T* __restrict__ stats_out,
                    T* work, int Tw, int N, int K, int seg_len, T relax,
                    int m, int collect, int last, T safeguard, T step_clamp,
                    int plain_tail, T conv_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_kinv = reinterpret_cast<T*>(smem_raw);  // [Tw * Tw]
  T* s_rd = s_kinv + Tw * Tw;                  // [N]
  T* s_t = s_rd + N;                           // [Tw]
  T* s_t2 = s_t + Tw;                          // [Tw]
  __shared__ T s_red[SEG_KMAX * SEG_WARPS];    // the equality sums
  __shared__ T s_gred[RED_MAX * SEG_WARPS];    // generic reductions
  __shared__ T s_gout[RED_MAX];
  __shared__ T s_gram[AA_MMAX * (AA_MMAX + 1) / 2 + AA_MMAX];
  __shared__ T s_gamma[AA_MMAX];

  // this block's lane
  const int p = blockIdx.x;
  const size_t vo = (size_t)p * N;
  d += vo; xb += vo; q += vo; lo += vo; hi += vo; center += vo;
  thresh += vo; z0 += vo; u0 += vo; x_out += vo; z_out += vo; u_out += vo;
  V += (size_t)p * Tw * N;
  kinv += (size_t)p * Tw * Tw;
  mt += (size_t)p * K * N;
  ge += (size_t)p * K * N;
  stats_out += (size_t)p * 4;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T rho = __ldg(rho_p + p);
  const int n2 = 2 * N;

  // Anderson workspace rows of this lane: S[m], Y[m], then VP, GP, VG, VF,
  // G, CAND, each 2N; element h of a row is owned by coordinate h mod N
  T* S = nullptr;
  T* Y = nullptr;
  T *VP = nullptr, *GP = nullptr, *VG = nullptr, *VF = nullptr, *G = nullptr,
    *CAND = nullptr;
  if (AA) {
    S = work + (size_t)p * (2 * m + 6) * n2;
    Y = S + (size_t)m * n2;
    VP = Y + (size_t)m * n2;
    GP = VP + n2;
    VG = GP + n2;
    VF = VG + n2;
    G = VF + n2;
    CAND = G + n2;
  }

  for (int i = tid; i < Tw * Tw; i += SEG_THREADS) s_kinv[i] = kinv[i];

  T z[SEG_COLS], u[SEG_COLS];
#pragma unroll
  for (int c = 0; c < SEG_COLS; ++c) {
    const int j = tid + c * SEG_THREADS;
    z[c] = j < N ? z0[j] : T(0);
    u[c] = j < N ? u0[j] : T(0);
    if (seg_len == 0 && j < N) x_out[j] = z[c];   // x starts at z
    if (AA && j < N) {
      for (int r = 0; r < m; ++r) {
        S[(size_t)r * n2 + j] = S[(size_t)r * n2 + N + j] = T(0);
        Y[(size_t)r * n2 + j] = Y[(size_t)r * n2 + N + j] = T(0);
      }
      VP[j] = VP[N + j] = GP[j] = GP[N + j] = T(0);
      VG[j] = z[c];
      VG[N + j] = u[c];
    }
  }
  T dz = T(0), acc = T(0), rej = T(0), conv = T(0);
  T r_best = T(INFINITY);
  int hist = 0, head = 0;
  __syncthreads();

  for (int it = 0; it < seg_len; ++it) {
    // rd, shared by every warp's V-row dot products
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int j = tid + c * SEG_THREADS;
      if (j < N) s_rd[j] = (rho * (z[c] - u[c]) - __ldg(q + j)) / __ldg(d + j);
    }
    __syncthreads();

    // t = V rd: one warp per row of V
    for (int k = warp; k < Tw; k += SEG_WARPS) {
      const T* vk = V + (size_t)k * N;
      T a = T(0);
      for (int j = lane; j < N; j += 32) a += __ldg(vk + j) * s_rd[j];
      for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(FULL_MASK, a, o);
      if (lane == 0) s_t[k] = a;
    }
    __syncthreads();

    // t2 = t kinv
    for (int k = tid; k < Tw; k += SEG_THREADS) {
      T a = T(0);
      for (int l = 0; l < Tw; ++l) a += s_t[l] * s_kinv[l * Tw + k];
      s_t2[k] = a;
    }
    __syncthreads();

    // xt = rd - (t2 V) / d, and the partial sums of e = ge xt
    T xt[SEG_COLS];
    T ep[SEG_KMAX];
#pragma unroll
    for (int k = 0; k < SEG_KMAX; ++k) ep[k] = T(0);
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int j = tid + c * SEG_THREADS;
      xt[c] = T(0);
      if (j < N) {
        T a = T(0);
        for (int k = 0; k < Tw; ++k) a += s_t2[k] * __ldg(V + (size_t)k * N + j);
        xt[c] = s_rd[j] - a / __ldg(d + j);
#pragma unroll
        for (int k = 0; k < SEG_KMAX; ++k)
          if (k < K) ep[k] += xt[c] * __ldg(ge + (size_t)k * N + j);
      }
    }
#pragma unroll
    for (int k = 0; k < SEG_KMAX; ++k) {
      if (k < K) {
        T v = ep[k];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
        if (lane == 0) s_red[k * SEG_WARPS + warp] = v;
      }
    }
    __syncthreads();
    T e[SEG_KMAX];
#pragma unroll
    for (int k = 0; k < SEG_KMAX; ++k) {
      e[k] = T(0);
      if (k < K)
        for (int w = 0; w < SEG_WARPS; ++w) e[k] += s_red[k * SEG_WARPS + w];
    }

    // equality correction, relaxation, prox, dual update
    const bool last_it = it == seg_len - 1;
    T dzl = T(0), xzl = T(0), r2 = T(0);
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int j = tid + c * SEG_THREADS;
      if (j < N) {
        T corr = T(0);
#pragma unroll
        for (int k = 0; k < SEG_KMAX; ++k)
          if (k < K) corr += e[k] * __ldg(mt + (size_t)k * N + j);
        const T xv = xt[c] - corr + __ldg(xb + j);
        const T xr = relax * xv + (T(1) - relax) * z[c];
        const T w = xr + u[c];
        const T cj = __ldg(center + j);
        const T zs = w - cj;
        T zn = cj + psign(zs) * pmax(fabs(zs) - __ldg(thresh + j), T(0));
        zn = pmin(pmax(zn, __ldg(lo + j)), __ldg(hi + j));
        const T un = w - zn;
        if (last_it) x_out[j] = xv;
        dzl = pmax(dzl, T(fabs(zn - z[c])));
        xzl = pmax(xzl, T(fabs(xv - zn)));
        if (AA) {
          const T gz = zn - z[c], gu = un - u[c];
          r2 += gz * gz + gu * gu;
          VF[j] = zn;
          VF[N + j] = un;
          G[j] = gz;
          G[N + j] = gu;
        } else {
          u[c] = un;
          z[c] = zn;
        }
      }
    }

    if (!AA) {
      if (collect || last_it) {
        T v[2] = {dzl, xzl};
        block_reduce<T, 2>(v, 3u, s_gred, s_gout);
        dz = v[0];
        const T r_c = pmax(v[1], rho * dz);
        if (collect && conv == T(0) && r_c <= conv_tol) conv = T(it + 1);
      }
      continue;
    }

    // ---- Anderson: residual, safeguard, history push
    T v3[3] = {dzl, xzl, r2};
    block_reduce<T, 3>(v3, 3u, s_gred, s_gout);
    dz = v3[0];
    const T r_c = pmax(v3[1], rho * dz);
    if (collect && conv == T(0) && r_c <= conv_tol) conv = T(it + 1);
    const T r = sqrt(v3[2]);
    const bool grew = it > 0 && r > safeguard * r_best;
    const bool improve = r <= r_best;
    r_best = pmin(r_best, r);
    if (grew) {
      rej += T(1);
      hist = 0;
    }
    const bool push = it > 0 && !grew;
    if (push) {
      head = (head + m - 1) % m;          // newest row first
      hist = hist + 1 < m ? hist + 1 : m;
    }
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int j = tid + c * SEG_THREADS;
      if (j < N) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = j + half * N;
          const T vh = half ? u[c] : z[c];
          const T gh = G[h];
          if (improve) VG[h] = VF[h];
          if (push) {
            S[(size_t)head * n2 + h] = vh - VP[h];
            Y[(size_t)head * n2 + h] = gh - GP[h];
          }
          VP[h] = vh;
          GP[h] = gh;
        }
      }
    }
    __syncthreads();

    // masked Gram of Y and Y g: one warp per entry, logical row r at
    // physical slot (head + r) % m
    const int n_gram = m * (m + 1) / 2;
    for (int ent = warp; ent < n_gram + m; ent += SEG_WARPS) {
      int r, s2 = -1;
      if (ent < n_gram) {
        int e2 = ent;
        r = 0;
        while (e2 >= m - r) {
          e2 -= m - r;
          ++r;
        }
        s2 = r + e2;
      } else {
        r = ent - n_gram;
      }
      const T mr = r < hist ? T(1) : T(0);
      const T* yr = Y + (size_t)((head + r) % m) * n2;
      T a = T(0);
      if (s2 >= 0) {
        const T ms = s2 < hist ? T(1) : T(0);
        const T* ys = Y + (size_t)((head + s2) % m) * n2;
        for (int h = lane; h < n2; h += 32) a += (yr[h] * mr) * (ys[h] * ms);
      } else {
        for (int h = lane; h < n2; h += 32) a += (yr[h] * mr) * G[h];
      }
      for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(FULL_MASK, a, o);
      if (lane == 0) s_gram[ent] = a;
    }
    __syncthreads();

    // gamma: (Ym Ym' + diag(1 - mask) + ridge I) gamma = Ym g, by the
    // pivot-free Gauss-Jordan of ops/_linalg.py::spd_solve
    if (tid == 0) {
      T aug[AA_MMAX][AA_MMAX + 1];
      T trace = T(0);
      for (int r = 0, ent = 0; r < m; ++r)
        for (int s2 = r; s2 < m; ++s2, ++ent) {
          aug[r][s2] = aug[s2][r] = s_gram[ent];
          if (s2 == r) trace += s_gram[ent];
        }
      const T ridge = T(1e-8) * trace / T(hist > 1 ? hist : 1) + Eps<T>::tiny();
      for (int r = 0; r < m; ++r) {
        aug[r][r] = aug[r][r] + (r < hist ? T(0) : T(1)) + ridge;
        aug[r][m] = s_gram[n_gram + r];
      }
      for (int k = 0; k < m; ++k) {
        const T piv = aug[k][k];
        for (int col = 0; col <= m; ++col) aug[k][col] = aug[k][col] / piv;
        for (int r = 0; r < m; ++r) {
          if (r == k) continue;
          const T fac = aug[r][k];
          for (int col = 0; col <= m; ++col) aug[r][col] = aug[r][col] - fac * aug[k][col];
        }
      }
      for (int r = 0; r < m; ++r) s_gamma[r] = aug[r][m];
    }
    __syncthreads();

    // candidate, its step length and finiteness
    T st2 = T(0), nonfinite = T(0);
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int j = tid + c * SEG_THREADS;
      if (j < N) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = j + half * N;
          T mix = T(0);
          for (int r = 0; r < m; ++r) {
            const size_t row = (size_t)((head + r) % m) * n2 + h;
            mix += s_gamma[r] * ((S[row] + Y[row]) * (r < hist ? T(1) : T(0)));
          }
          const T vf = VF[h];
          const T cand = vf - mix;
          const T step = cand - vf;
          st2 += step * step;
          if (!isfinite(cand)) nonfinite += T(1);
          CAND[h] = cand;
        }
      }
    }
    T v2[2] = {st2, nonfinite};
    block_reduce<T, 2>(v2, 0u, s_gred, s_gout);
    bool use = hist > 0 && !grew && r <= r_best && r_c > conv_tol &&
               sqrt(v2[0]) <= step_clamp * r && v2[1] == T(0);
    if (last && it >= seg_len - plain_tail) use = false;
    if (use) acc += T(1);
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int j = tid + c * SEG_THREADS;
      if (j < N) {
        const T* src = grew ? VG : (use ? CAND : VF);
        z[c] = src[j];
        u[c] = src[N + j];
      }
    }
  }

  if (tid == 0) {
    stats_out[0] = dz;
    stats_out[1] = acc;
    stats_out[2] = rej;
    stats_out[3] = conv;
  }
#pragma unroll
  for (int c = 0; c < SEG_COLS; ++c) {
    const int j = tid + c * SEG_THREADS;
    if (j < N) {
      z_out[j] = z[c];
      u_out[j] = u[c];
    }
  }
}

template <typename T, bool AA>
static int launch_one(const T* d, const T* V, const T* kinv, const T* mt,
                      const T* ge, const T* xb, const T* q, const T* lo,
                      const T* hi, const T* center, const T* thresh,
                      const T* z0, const T* u0, const T* rho, T* x_out,
                      T* z_out, T* u_out, T* stats, T* work, int B, int Tw,
                      int N, int K, int seg_len, double relax, int m,
                      int collect, int last, double safeguard,
                      double step_clamp, int plain_tail, double conv_tol,
                      void* stream) {
  const int smem = (int)sizeof(T) * (Tw * Tw + N + 2 * Tw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        admm_segment_kernel<T, AA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_segment_kernel<T, AA><<<B, SEG_THREADS, smem, (cudaStream_t)stream>>>(
      d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z0, u0, rho, x_out,
      z_out, u_out, stats, work, Tw, N, K, seg_len, (T)relax, m, collect,
      last, (T)safeguard, (T)step_clamp, plain_tail, (T)conv_tol);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* d, const T* V, const T* kinv, const T* mt,
                  const T* ge, const T* xb, const T* q, const T* lo,
                  const T* hi, const T* center, const T* thresh, const T* z0,
                  const T* u0, const T* rho, T* x_out, T* z_out, T* u_out,
                  T* stats, T* work, int B, int Tw, int N, int K, int seg_len,
                  double relax, int m, int collect, int last,
                  double safeguard, double step_clamp, int plain_tail,
                  double conv_tol, void* stream) {
  if (B <= 0) return 0;
  if (m > AA_MMAX || m < 0) return (int)cudaErrorInvalidValue;
  if (m > 0)
    return launch_one<T, true>(d, V, kinv, mt, ge, xb, q, lo, hi, center,
                               thresh, z0, u0, rho, x_out, z_out, u_out, stats,
                               work, B, Tw, N, K, seg_len, relax, m, collect,
                               last, safeguard, step_clamp, plain_tail,
                               conv_tol, stream);
  return launch_one<T, false>(d, V, kinv, mt, ge, xb, q, lo, hi, center,
                              thresh, z0, u0, rho, x_out, z_out, u_out, stats,
                              work, B, Tw, N, K, seg_len, relax, 0, collect,
                              last, safeguard, step_clamp, plain_tail,
                              conv_tol, stream);
}

#define FM_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* d, const T* V, const T* kinv, const T* mt,   \
                      const T* ge, const T* xb, const T* q, const T* lo,    \
                      const T* hi, const T* center, const T* thresh,        \
                      const T* z0, const T* u0, const T* rho, T* x_out,     \
                      T* z_out, T* u_out, T* stats, T* work, int B, int Tw, \
                      int N, int K, int seg_len, double relax, int m,       \
                      int collect, int last, double safeguard,              \
                      double step_clamp, int plain_tail, double conv_tol,   \
                      void* stream) {                                       \
    return launch<T>(d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z0, \
                     u0, rho, x_out, z_out, u_out, stats, work, B, Tw, N, K, \
                     seg_len, relax, m, collect, last, safeguard,           \
                     step_clamp, plain_tail, conv_tol, stream);             \
  }

FM_ENTRY(fm_admm_segment_f32, float)
FM_ENTRY(fm_admm_segment_f64, double)
