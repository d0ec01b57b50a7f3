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

#include "rank_common.cuh"

// A row of float keys (NaN = invalid) and its co-sorted payload.
struct FloatRow {
  const float* k;
  const float* r;
  __device__ bool same(int i, int j) const { return k[i] == k[j]; }
  __device__ bool valid(int i) const { return !isnan(k[i]); }
  __device__ float payload(int i) const { return r[i]; }
};

__global__ void __launch_bounds__(RIC_THREADS)
rank_ic_postsort_kernel(const float* __restrict__ s_key,
                        const float* __restrict__ r_s,
                        float* __restrict__ ic_out,
                        float* __restrict__ cnt_out, int m) {
  extern __shared__ float smem[];
  float* k = smem;                        // [m] sorted keys
  float* r = smem + m;                    // [m] co-sorted payload
  int* first = reinterpret_cast<int*>(smem + 2 * m);  // [m] run start

  const int64_t row = blockIdx.x;
  const float* kr = s_key + row * (int64_t)m;
  const float* rr = r_s + row * (int64_t)m;

  // coalesced row load; payload sum and valid count on the way
  float sum_r = 0.0f, cnt = 0.0f;
  for (int i = threadIdx.x; i < m; i += RIC_THREADS) {
    const float kv = kr[i], rv = rr[i];
    k[i] = kv;
    r[i] = rv;
    sum_r += rv;
    cnt += isnan(kv) ? 0.0f : 1.0f;
  }
  __syncthreads();
  rank_ic_sorted_row(FloatRow{k, r}, first, m, sum_r, cnt, ic_out + row,
                     cnt_out + row);
}

extern "C" int fm_rank_ic_smem_bytes(int m) { return 12 * m; }

extern "C" int fm_rank_ic_postsort(const float* s_key, const float* r_s,
                                   float* ic, float* n_valid, int rows, int m,
                                   void* stream) {
  const int smem = 12 * m;
  // always opted in: the post-sort body's static shared memory counts
  // against the 48 KB default too, so a dynamic size just under it fails
  cudaError_t e = cudaFuncSetAttribute(
      rank_ic_postsort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0) {
    rank_ic_postsort_kernel<<<rows, RIC_THREADS, smem,
                              (cudaStream_t)stream>>>(s_key, r_s, ic, n_valid,
                                                      m);
  }
  return (int)cudaGetLastError();
}
