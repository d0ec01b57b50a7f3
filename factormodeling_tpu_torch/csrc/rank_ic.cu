// Rank-IC after the cross-sectional sort, one thread block per row.
//
// Replaces the Pallas kernel factormodeling_tpu/metrics/_pallas_rank_ic.py
// (rank_ic_postsort). Input rows are already sorted by key with NaN (invalid
// cells) last, and the payload r is co-sorted with 0 at invalid cells. Per
// row the kernel forms average-tie 1-based ranks (tie runs from a forward
// max-scan of run starts and a backward min-scan of run ends; NaN != NaN puts
// each NaN in its own run, and -0.0 == +0.0 ties) and the centered Pearson
// correlation of rank vs payload, with the rank mean in closed form (n+1)/2.
//
// Bound on an H100: bytes. The row is read from device memory once (8 B per
// element) and two floats per row come back; the arithmetic is a few
// operations per element. Design: the row is staged in shared memory
// (12 B per element with the run-start index array, 12 KB at M = 1000), each
// thread owns a contiguous chunk of positions, and the block-wide scans run
// over per-thread aggregates with warp shuffles, so the only passes over
// device memory are the coalesced row loads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RIC_THREADS 256
#define RIC_WARPS (RIC_THREADS / 32)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  return v;
}

// Exclusive prefix max over threads in block order; identity -1.
__device__ __forceinline__ int block_excl_prefix_max(int v, int* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl = max(incl, n);
  }
  int excl = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) s_w[warp] = incl;
  __syncthreads();
  int before = -1;
  for (int w = 0; w < warp; ++w) before = max(before, s_w[w]);
  return max(before, excl);
}

// Exclusive suffix min over threads (threads after this one); identity big.
__device__ __forceinline__ int block_excl_suffix_min(int v, int big, int* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_down_sync(FULL_MASK, incl, o);
    if (lane + o < 32) incl = min(incl, n);
  }
  int excl = __shfl_down_sync(FULL_MASK, incl, 1);
  if (lane == 31) excl = big;
  if (lane == 0) s_w[warp] = incl;
  __syncthreads();
  int after = big;
  for (int w = warp + 1; w < RIC_WARPS; ++w) after = min(after, s_w[w]);
  return min(after, excl);
}

// Block-wide sum of three values; every thread gets the totals.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c,
                                           float* s_f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if (lane == 0) {
    s_f[warp] = a;
    s_f[RIC_WARPS + warp] = b;
    s_f[2 * RIC_WARPS + warp] = c;
  }
  __syncthreads();
  a = b = c = 0.0f;
  for (int w = 0; w < RIC_WARPS; ++w) {
    a += s_f[w];
    b += s_f[RIC_WARPS + w];
    c += s_f[2 * RIC_WARPS + w];
  }
}

__global__ void __launch_bounds__(RIC_THREADS)
rank_ic_postsort_kernel(const float* __restrict__ s_key,
                        const float* __restrict__ r_s,
                        float* __restrict__ ic_out,
                        float* __restrict__ cnt_out, int m) {
  extern __shared__ float smem[];
  float* k = smem;                        // [m] sorted keys
  float* r = smem + m;                    // [m] co-sorted payload
  int* first = reinterpret_cast<int*>(smem + 2 * m);  // [m] run start
  __shared__ int s_w0[RIC_WARPS], s_w1[RIC_WARPS];
  __shared__ float s_f0[3 * RIC_WARPS], s_f1[3 * RIC_WARPS];

  const int64_t row = blockIdx.x;
  const float* kr = s_key + row * (int64_t)m;
  const float* rr = r_s + row * (int64_t)m;

  // coalesced row load; payload sum and valid count on the way
  float sum_r = 0.0f, cnt = 0.0f, unused = 0.0f;
  for (int i = threadIdx.x; i < m; i += RIC_THREADS) {
    const float kv = kr[i], rv = rr[i];
    k[i] = kv;
    r[i] = rv;
    sum_r += rv;
    cnt += isnan(kv) ? 0.0f : 1.0f;
  }
  __syncthreads();

  const int chunk = (m + RIC_THREADS - 1) / RIC_THREADS;
  const int beg = min((int)threadIdx.x * chunk, m);
  const int end = min(beg + chunk, m);

  // forward pass: last run start seen in this chunk (-1 if none yet);
  // backward aggregate: first run end in this chunk (m if none)
  int run = -1, first_end = m;
  for (int i = beg; i < end; ++i) {
    if (i == 0 || k[i] != k[i - 1]) run = i;
    first[i] = run;
    if (first_end == m && (i == m - 1 || k[i + 1] != k[i])) first_end = i;
  }
  const int fcarry = block_excl_prefix_max(run, s_w0);
  const int lcarry = block_excl_suffix_min(first_end, m, s_w1);
  block_sum3(sum_r, cnt, unused, s_f0);

  const float cs = cnt > 0.0f ? cnt : __int_as_float(0x7fc00000);
  const float mr = sum_r / cs;
  const float mrank = (cs + 1.0f) * 0.5f;

  // backward pass: run end, rank, centered moments
  float cov = 0.0f, var_rank = 0.0f, var_r = 0.0f;
  int last = lcarry;
  for (int i = end - 1; i >= beg; --i) {
    if (i == m - 1 || k[i + 1] != k[i]) last = i;
    if (!isnan(k[i])) {
      const int f = max(first[i], fcarry);
      const float rank = 0.5f * (float)(f + last) + 1.0f;
      const float drk = rank - mrank;
      const float dr = r[i] - mr;
      cov += drk * dr;
      var_rank += drk * drk;
      var_r += dr * dr;
    }
  }
  block_sum3(cov, var_rank, var_r, s_f1);
  if (threadIdx.x == 0) {
    ic_out[row] = cov / sqrtf(var_rank * var_r);
    cnt_out[row] = cnt;
  }
}

extern "C" int fm_rank_ic_smem_bytes(int m) { return 12 * m; }

extern "C" int fm_rank_ic_postsort(const float* s_key, const float* r_s,
                                   float* ic, float* n_valid, int rows, int m,
                                   void* stream) {
  const int smem = 12 * m;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank_ic_postsort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (rows > 0) {
    rank_ic_postsort_kernel<<<rows, RIC_THREADS, smem,
                              (cudaStream_t)stream>>>(s_key, r_s, ic, n_valid,
                                                      m);
  }
  return (int)cudaGetLastError();
}
