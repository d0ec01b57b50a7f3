// The composite normalization chain group_neutralize(cs_zscore(x), gids, G)
// in one pass: one thread block per row of N assets; float and double.
//
// Replaces the Pallas kernel factormodeling_tpu/ops/_pallas_fused.py
// (zscore_group_neutralize_fused, body _kernel). Per row (a leading index and
// a date; the group ids [D, N] are shared across the leading axes, so row r
// reads the ids of date r % D):
//   cnt, sum over the valid (non-NaN) cells; mean = sum / cnt
//   ss = sum over the valid cells of (x - mean)^2; sigma = sqrt(ss / cnt)
//   z = (x - mean) / sigma        (a constant row gives 0 / 0 -> NaN)
//   per group g < G: s_g, c_g = sum and count of the valid z with gid == g
//   out = z - s_g / c_g for 0 <= gid < G (an empty group gives 0 / 0 -> NaN),
//         NaN for any other gid.
//
// Bound on an H100: bytes. Each cell is read once and written once and the
// ids once per date: (8 R D N + 4 D N) bytes in float32, 1.53 GB at R = 50,
// D = 1260, N = 3000 (0.46 ms at 3.35 TB/s), against about 10 + 2 G
// operations per cell.
//
// Design. A row of up to SMEM_WIDTH assets and its ids sit in shared memory
// (8 B per asset in float32, 24 KB at N = 3000; 12 B in double), loaded once
// with coalesced reads; a wider row keeps its z-values in the output row and
// reads its ids from device memory, both through L1/L2, so every N is taken.
// The count, sum and centered sum of squares are block reductions (warp
// shuffles, then the warps' partials in warp order); the z-values overwrite
// the row; for each group every warp reduces its threads' partial sums and
// counts into a [warps x G] table, and one thread per group adds the table's
// column in warp order. No floating-point atomics: every sum is taken in a
// fixed order, so two runs agree bit for bit, and the two row layouts give
// the same bits. G <= 32; SMEM_WIDTH is 16384 assets (196 KB of dynamic
// shared memory in double, beside the 4.4 KB of tables, within the 227 KB a
// block can use).
//
// Prediction, written before the first run on the card: at R = 50, D = 1260,
// N = 3000, G = 11 in float32, 0.9-1.5 ms, 2-3x the bytes bound: 63,000 blocks
// of 256 threads each make G passes over their 12 cells per thread in shared
// memory and G + 3 block-wide reductions, whose barriers leave the memory
// system idle between a block's load and its store.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ZG_THREADS 256
#define ZG_WARPS (ZG_THREADS / 32)
#define ZG_MAX_GROUPS 32
#define SMEM_WIDTH 16384
#define FULL_MASK 0xffffffffu

template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  return v;
}

// Block-wide sum in a fixed order; every thread gets the total.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  T tot = T(0);
  for (int w = 0; w < ZG_WARPS; ++w) tot += s_red[w];
  __syncthreads();  // s_red is reused by the next reduction
  return tot;
}

// kShared: the row and its ids in shared memory (N <= SMEM_WIDTH); else the
// z-values live in the output row and the ids are read where they lie.
template <typename T, bool kShared>
__global__ void __launch_bounds__(ZG_THREADS)
zscore_group_kernel(const T* __restrict__ x, const int* __restrict__ gids,
                    T* __restrict__ out, int D, int N, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_red[ZG_WARPS];
  __shared__ T s_sum[ZG_WARPS][ZG_MAX_GROUPS], s_cnt[ZG_WARPS][ZG_MAX_GROUPS];
  __shared__ T s_mean[ZG_MAX_GROUPS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * (int64_t)N;
  const int* gr = gids + (row % D) * (int64_t)N;
  T* orow = out + row * (int64_t)N;
  // [N] the row, then its z-values; [N] its group ids
  T* z = kShared ? reinterpret_cast<T*>(smem_raw) : orow;
  int* g_smem = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) + N);
  const int* g = kShared ? g_smem : gr;

  // each thread touches only its own cells i = tid (mod ZG_THREADS) until
  // the group tables, so the block barriers inside block_sum suffice
  T sum = T(0), cnt = T(0);
  for (int i = threadIdx.x; i < N; i += ZG_THREADS) {
    const T v = xr[i];
    z[i] = v;
    if (kShared) g_smem[i] = gr[i];
    if (!isnan(v)) {
      sum += v;
      cnt += T(1);
    }
  }
  sum = block_sum(sum, s_red);
  cnt = block_sum(cnt, s_red);
  const T mean = sum / cnt;  // cnt == 0 -> NaN, inert
  T ss = T(0);
  for (int i = threadIdx.x; i < N; i += ZG_THREADS) {
    const T v = z[i];
    if (!isnan(v)) {
      const T dev = v - mean;
      ss += dev * dev;
    }
  }
  ss = block_sum(ss, s_red);
  const T sigma = sqrt(ss / cnt);
  for (int i = threadIdx.x; i < N; i += ZG_THREADS) z[i] = (z[i] - mean) / sigma;

  for (int grp = 0; grp < G; ++grp) {
    T s = T(0), c = T(0);
    for (int i = threadIdx.x; i < N; i += ZG_THREADS) {
      const T zi = z[i];
      if (g[i] == grp && !isnan(zi)) {
        s += zi;
        c += T(1);
      }
    }
    s = warp_sum(s);
    c = warp_sum(c);
    if (lane == 0) {
      s_sum[warp][grp] = s;
      s_cnt[warp][grp] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    T s = T(0), c = T(0);
    for (int w = 0; w < ZG_WARPS; ++w) {
      s += s_sum[w][threadIdx.x];
      c += s_cnt[w][threadIdx.x];
    }
    s_mean[threadIdx.x] = s / c;  // empty group -> 0 / 0 -> NaN
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += ZG_THREADS) {
    const int gi = g[i];
    const T gm = (gi >= 0 && gi < G) ? s_mean[gi] : nan_of<T>();
    orow[i] = z[i] - gm;
  }
}

template <typename T>
static int launch(const T* x, const int* gids, T* out, long long rows, int D,
                  int N, int G, void* stream) {
  if (G < 1 || G > ZG_MAX_GROUPS || D < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || N <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (N > SMEM_WIDTH) {
    zscore_group_kernel<T, false><<<(unsigned)rows, ZG_THREADS, 0,
                                    (cudaStream_t)stream>>>(x, gids, out, D,
                                                             N, G);
    return (int)cudaGetLastError();
  }
  const int smem = N * (int)(sizeof(T) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        zscore_group_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  zscore_group_kernel<T, true><<<(unsigned)rows, ZG_THREADS, smem,
                                 (cudaStream_t)stream>>>(x, gids, out, D, N,
                                                         G);
  return (int)cudaGetLastError();
}

extern "C" int fm_zscore_group_f32(const float* x, const int* gids,
                                   float* out, long long rows, int D, int N,
                                   int G, void* stream) {
  return launch<float>(x, gids, out, rows, D, N, G, stream);
}

extern "C" int fm_zscore_group_f64(const double* x, const int* gids,
                                   double* out, long long rows, int D, int N,
                                   int G, void* stream) {
  return launch<double>(x, gids, out, rows, D, N, G, stream);
}
