// Block-wide scans and sums, and the rank-IC body over one sorted row,
// shared by rank_ic.cu (the post-sort stage, K1) and rank_sort.cu (the fused
// sort, K3). Both kernels run one block of RIC_THREADS threads per row and
// hand the sorted row to rank_ic_sorted_row, so on a row without ties the
// two sum the same terms in the same order.
#pragma once

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

// Average-tie 1-based ranks of one sorted row of m cells (invalid cells
// last) and the centered Pearson correlation of rank vs payload, with the
// rank mean in closed form (n+1)/2. Tie runs come from a forward max-scan of
// run starts and a backward min-scan of run ends; each thread owns a
// contiguous chunk of positions. `row` gives same(i, j) (the keys tie),
// valid(i) and payload(i) over shared memory; `first` is [m] ints of shared
// scratch. sum_r and cnt are this thread's partial payload sum and valid
// count over positions tid, tid + RIC_THREADS, ... Thread 0 writes the row's
// ic and valid count.
template <class Row>
__device__ __forceinline__ void rank_ic_sorted_row(const Row& row, int* first,
                                                   int m, float sum_r,
                                                   float cnt, float* ic_out,
                                                   float* cnt_out) {
  __shared__ int s_w0[RIC_WARPS], s_w1[RIC_WARPS];
  __shared__ float s_f0[3 * RIC_WARPS], s_f1[3 * RIC_WARPS];

  const int chunk = (m + RIC_THREADS - 1) / RIC_THREADS;
  const int beg = min((int)threadIdx.x * chunk, m);
  const int end = min(beg + chunk, m);

  // forward pass: last run start seen in this chunk (-1 if none yet);
  // backward aggregate: first run end in this chunk (m if none)
  int run = -1, first_end = m;
  for (int i = beg; i < end; ++i) {
    if (i == 0 || !row.same(i, i - 1)) run = i;
    first[i] = run;
    if (first_end == m && (i == m - 1 || !row.same(i + 1, i))) first_end = i;
  }
  const int fcarry = block_excl_prefix_max(run, s_w0);
  const int lcarry = block_excl_suffix_min(first_end, m, s_w1);
  float unused = 0.0f;
  block_sum3(sum_r, cnt, unused, s_f0);

  const float cs = cnt > 0.0f ? cnt : __int_as_float(0x7fc00000);
  const float mr = sum_r / cs;
  const float mrank = (cs + 1.0f) * 0.5f;

  // backward pass: run end, rank, centered moments
  float cov = 0.0f, var_rank = 0.0f, var_r = 0.0f;
  int last = lcarry;
  for (int i = end - 1; i >= beg; --i) {
    if (i == m - 1 || !row.same(i + 1, i)) last = i;
    if (row.valid(i)) {
      const int f = max(first[i], fcarry);
      const float rank = 0.5f * (float)(f + last) + 1.0f;
      const float drk = rank - mrank;
      const float dr = row.payload(i) - mr;
      cov += drk * dr;
      var_rank += drk * drk;
      var_r += dr * dr;
    }
  }
  block_sum3(cov, var_rank, var_r, s_f1);
  if (threadIdx.x == 0) {
    *ic_out = cov / sqrtf(var_rank * var_r);
    *cnt_out = cnt;
  }
}
