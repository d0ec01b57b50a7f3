// One ADMM segment of the box/L1 QP solver: seg_len iterations at a fixed
// rho in one launch, one thread block per solve; float and double.
//
// Replaces the Pallas kernel factormodeling_tpu/ops/_pallas_admm.py
// (admm_segment, its anderson == 0 branch without iteration telemetry).
// Per iteration:
//   rd = (rho (z - u) - q) / d
//   t  = V rd             (T dot products over N, one warp per row)
//   t2 = t kinv           (Woodbury inner inverse, T x T)
//   xt = rd - (t2 V) / d
//   x  = xt - (ge xt) mt + xb      (equality correction, K rows)
//   xr = relax x + (1 - relax) z;  w = xr + u
//   z' = clip(center + soft(w - center, thresh), lo, hi);  u = w - z'
// and dz = max |z' - z| of the last iteration.
//
// Bound on an H100: neither bytes nor operations. One segment at T = 60,
// N = 1000 moves about 0.3 MB (0.6 MB in double) and does about 7 MFLOP, a
// fraction of a microsecond at the card's rates; what it waits on is the
// serial chain of 25 dependent iterations, each of which needs two passes
// over V and four block barriers. Design: one block of 1024 threads on one
// SM, the whole segment in one launch instead of the ~15 small launches per
// iteration of the plain version. V ([T, N], 240 KB in float at T = 60,
// N = 1000) does not fit in one block's shared memory next to the rest, so
// it stays in device memory and is read through the read-only path, where it
// stays resident in L1/L2 across the iterations; kinv and the rd vector live
// in shared memory, z and u in registers of the thread that owns each
// coordinate (at most 4 coordinates per thread, hence N <= 4096).

#include <cuda_runtime.h>
#include <math.h>

#define SEG_THREADS 1024
#define SEG_WARPS (SEG_THREADS / 32)
#define SEG_COLS 4      // coordinates per thread: N <= SEG_THREADS * SEG_COLS
#define SEG_KMAX 4      // equality rows (the leg constraints have 2)
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

template <typename T>
__global__ void __launch_bounds__(SEG_THREADS)
admm_segment_kernel(const T* __restrict__ d, const T* __restrict__ V,
                    const T* __restrict__ kinv, const T* __restrict__ mt,
                    const T* __restrict__ ge, const T* __restrict__ xb,
                    const T* __restrict__ q, const T* __restrict__ lo,
                    const T* __restrict__ hi, const T* __restrict__ center,
                    const T* __restrict__ thresh, const T* __restrict__ z0,
                    const T* __restrict__ u0, const T* __restrict__ rho_p,
                    T* __restrict__ x_out, T* __restrict__ z_out,
                    T* __restrict__ u_out, T* __restrict__ dz_out, int Tw,
                    int N, int K, int seg_len, T relax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_kinv = reinterpret_cast<T*>(smem_raw);  // [Tw * Tw]
  T* s_rd = s_kinv + Tw * Tw;                  // [N]
  T* s_t = s_rd + N;                           // [Tw]
  T* s_t2 = s_t + Tw;                          // [Tw]
  __shared__ T s_red[SEG_KMAX * SEG_WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T rho = __ldg(rho_p);

  for (int i = tid; i < Tw * Tw; i += SEG_THREADS) s_kinv[i] = kinv[i];

  T z[SEG_COLS], u[SEG_COLS];
#pragma unroll
  for (int c = 0; c < SEG_COLS; ++c) {
    const int j = tid + c * SEG_THREADS;
    z[c] = j < N ? z0[j] : T(0);
    u[c] = j < N ? u0[j] : T(0);
    if (seg_len == 0 && j < N) x_out[j] = z[c];   // x starts at z
  }
  T dz = T(0);
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
      T acc = T(0);
      for (int j = lane; j < N; j += 32) acc += __ldg(vk + j) * s_rd[j];
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(FULL_MASK, acc, o);
      if (lane == 0) s_t[k] = acc;
    }
    __syncthreads();

    // t2 = t kinv
    for (int k = tid; k < Tw; k += SEG_THREADS) {
      T acc = T(0);
      for (int l = 0; l < Tw; ++l) acc += s_t[l] * s_kinv[l * Tw + k];
      s_t2[k] = acc;
    }
    __syncthreads();

    // xt = rd - (t2 V) / d, and the partial sums of e = ge xt
    T xt[SEG_COLS];
    T ep[SEG_KMAX];
#pragma unroll
    for (int m = 0; m < SEG_KMAX; ++m) ep[m] = T(0);
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int j = tid + c * SEG_THREADS;
      xt[c] = T(0);
      if (j < N) {
        T acc = T(0);
        for (int k = 0; k < Tw; ++k) acc += s_t2[k] * __ldg(V + (size_t)k * N + j);
        xt[c] = s_rd[j] - acc / __ldg(d + j);
#pragma unroll
        for (int m = 0; m < SEG_KMAX; ++m)
          if (m < K) ep[m] += xt[c] * __ldg(ge + (size_t)m * N + j);
      }
    }
#pragma unroll
    for (int m = 0; m < SEG_KMAX; ++m) {
      if (m < K) {
        T v = ep[m];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
        if (lane == 0) s_red[m * SEG_WARPS + warp] = v;
      }
    }
    __syncthreads();
    T e[SEG_KMAX];
#pragma unroll
    for (int m = 0; m < SEG_KMAX; ++m) {
      e[m] = T(0);
      if (m < K)
        for (int w = 0; w < SEG_WARPS; ++w) e[m] += s_red[m * SEG_WARPS + w];
    }

    // equality correction, relaxation, prox, dual update
    const bool last_it = it == seg_len - 1;
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int j = tid + c * SEG_THREADS;
      if (j < N) {
        T corr = T(0);
#pragma unroll
        for (int m = 0; m < SEG_KMAX; ++m)
          if (m < K) corr += e[m] * __ldg(mt + (size_t)m * N + j);
        const T xv = xt[c] - corr + __ldg(xb + j);
        const T xr = relax * xv + (T(1) - relax) * z[c];
        const T w = xr + u[c];
        const T cj = __ldg(center + j);
        const T zs = w - cj;
        T zn = cj + psign(zs) * pmax(fabs(zs) - __ldg(thresh + j), T(0));
        zn = pmin(pmax(zn, __ldg(lo + j)), __ldg(hi + j));
        if (last_it) {
          dz = pmax(dz, T(fabs(zn - z[c])));
          x_out[j] = xv;
        }
        u[c] = w - zn;
        z[c] = zn;
      }
    }
  }

  // dz of the last iteration: block-wide NaN-propagating max
  for (int o = 16; o > 0; o >>= 1) dz = pmax(dz, __shfl_down_sync(FULL_MASK, dz, o));
  __syncthreads();
  if (lane == 0) s_red[warp] = dz;
  __syncthreads();
  if (tid == 0) {
    T m = T(0);
    for (int w = 0; w < SEG_WARPS; ++w) m = pmax(m, s_red[w]);
    dz_out[0] = m;
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

template <typename T>
static int launch(const T* d, const T* V, const T* kinv, const T* mt,
                  const T* ge, const T* xb, const T* q, const T* lo,
                  const T* hi, const T* center, const T* thresh, const T* z0,
                  const T* u0, const T* rho, T* x_out, T* z_out, T* u_out,
                  T* dz_out, int Tw, int N, int K, int seg_len, double relax,
                  void* stream) {
  const int smem = (int)sizeof(T) * (Tw * Tw + N + 2 * Tw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        admm_segment_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_segment_kernel<T><<<1, SEG_THREADS, smem, (cudaStream_t)stream>>>(
      d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z0, u0, rho, x_out,
      z_out, u_out, dz_out, Tw, N, K, seg_len, (T)relax);
  return (int)cudaGetLastError();
}

extern "C" int fm_admm_segment_f32(
    const float* d, const float* V, const float* kinv, const float* mt,
    const float* ge, const float* xb, const float* q, const float* lo,
    const float* hi, const float* center, const float* thresh, const float* z0,
    const float* u0, const float* rho, float* x_out, float* z_out,
    float* u_out, float* dz_out, int Tw, int N, int K, int seg_len,
    double relax, void* stream) {
  return launch<float>(d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z0,
                       u0, rho, x_out, z_out, u_out, dz_out, Tw, N, K, seg_len,
                       relax, stream);
}

extern "C" int fm_admm_segment_f64(
    const double* d, const double* V, const double* kinv, const double* mt,
    const double* ge, const double* xb, const double* q, const double* lo,
    const double* hi, const double* center, const double* thresh,
    const double* z0, const double* u0, const double* rho, double* x_out,
    double* z_out, double* u_out, double* dz_out, int Tw, int N, int K,
    int seg_len, double relax, void* stream) {
  return launch<double>(d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z0,
                        u0, rho, x_out, z_out, u_out, dz_out, Tw, N, K,
                        seg_len, relax, stream);
}
