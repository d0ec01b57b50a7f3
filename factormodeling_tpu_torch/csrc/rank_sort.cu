// Rank-IC from unsorted rows: the sort, the average-tie ranks and the
// Pearson moments in one kernel, one thread block per row.
//
// Replaces the Pallas kernel
// factormodeling_tpu/metrics/_pallas_rank_sort.py (rank_ic_fused). Its
// semantics are kept: each f32 key maps to a monotone int32 (negative floats
// u -> u ^ 0x7fffffff, -0.0 and the denormals -> +0.0 as the TPU and XLA's
// CPU flush them, every NaN bit pattern -> one canonical key 0x7fc00000
// that sorts after +inf); cells with key <= +inf's 0x7f800000 are valid (so
// +-inf are ranked), the payload r is 0 at invalid cells, and a row with no
// valid cell or one distinct value gives a non-finite ic.
//
// Bound on an H100: bytes. Each row is read once (4 B key + 4 B payload per
// cell) and two floats per row come back: 533 MB at R = 66,600, n = 1000,
// 0.159 ms at 3.35 TB/s. The sort's compare-exchanges run in shared memory
// and never touch device memory: a bitonic network over W = next_pow2(n)
// (at least 128) does log2(W) (log2(W) + 1) / 2 stages of W / 2
// compare-exchanges, 28,160 per row at W = 1024 (1.9e9 at R = 66,600), each
// two 8-byte shared loads, a compare and two stores. That shared-memory
// traffic (~45 GB at the research shape), not device memory, sets this
// simple design's time. Design: the int32 key (shifted to unsigned order)
// and the payload's bits travel as one 64-bit word, so one compare orders
// by key and a swap moves both; padding past n is the largest word (key
// 0x7fffffff, payload 0). The row (8 W bytes) and the run-start array
// (4 n bytes) sit in shared memory: 12 KB at n = 1000, 96 KB at n = 8192,
// above the 48 KB default, hence the dynamic shared-memory attribute. After
// the sort the ranks and moments are rank_common.cuh's post-sort body, the
// same code as the post-sort kernel rank_ic.cu, over positions 0 .. n-1.

#include <float.h>

#include "rank_common.cuh"

#define RS_MIN_WIDTH 128
#define RS_MAX_WIDTH 8192

// unsigned images of the JAX package's signed keys (k ^ 0x80000000)
#define RS_INF_U 0xff800000u   // +inf: the largest valid key
#define RS_NAN_U 0xffc00000u   // the canonical NaN
#define RS_PAD_WORD 0xffffffff00000000ull

__device__ __forceinline__ unsigned sort_key(float x) {
  if (isnan(x)) return RS_NAN_U;
  if (fabsf(x) < FLT_MIN) x = 0.0f;   // -0.0 and denormals tie +0.0
  const int u = __float_as_int(x);
  const int k = u < 0 ? (u ^ 0x7fffffff) : u;
  return (unsigned)k ^ 0x80000000u;
}

// A sorted row of packed (key << 32 | payload bits) words.
struct PackedRow {
  const unsigned long long* a;
  __device__ bool same(int i, int j) const {
    return (unsigned)(a[i] >> 32) == (unsigned)(a[j] >> 32);
  }
  __device__ bool valid(int i) const {
    return (unsigned)(a[i] >> 32) <= RS_INF_U;
  }
  __device__ float payload(int i) const {
    return __uint_as_float((unsigned)a[i]);
  }
};

__global__ void __launch_bounds__(RIC_THREADS)
rank_sort_kernel(const float* __restrict__ f, const float* __restrict__ r,
                 float* __restrict__ ic_out, float* __restrict__ cnt_out,
                 int n, int w) {
  extern __shared__ unsigned long long s_a[];             // [w] packed row
  int* first = reinterpret_cast<int*>(s_a + w);           // [n] run start

  const int64_t row = blockIdx.x;
  const float* fr = f + row * (int64_t)n;
  const float* rr = r + row * (int64_t)n;
  for (int i = threadIdx.x; i < w; i += RIC_THREADS) {
    s_a[i] = i < n ? ((unsigned long long)sort_key(fr[i]) << 32)
                         | __float_as_uint(rr[i])
                   : RS_PAD_WORD;
  }
  __syncthreads();

  // bitonic network: blocks of k2 sorted up where (i & k2) == 0, down
  // elsewhere; stage j compares i with i + j for every i whose bit j is 0
  const int half = w >> 1;
  for (int k2 = 2; k2 <= w; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += RIC_THREADS) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const unsigned long long a = s_a[i], b = s_a[i + j];
        if ((a > b) == ((i & k2) == 0)) {
          s_a[i] = b;
          s_a[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  const PackedRow sorted{s_a};
  float sum_r = 0.0f, cnt = 0.0f;
  for (int i = threadIdx.x; i < n; i += RIC_THREADS) {
    sum_r += sorted.payload(i);
    cnt += sorted.valid(i) ? 1.0f : 0.0f;
  }
  rank_ic_sorted_row(sorted, first, n, sum_r, cnt, ic_out + row,
                     cnt_out + row);
}

static int rank_sort_width(int n) {
  int w = RS_MIN_WIDTH;
  while (w < n) w <<= 1;
  return w;
}

// the packed row and the run-start array
static int rank_sort_smem_bytes(int n) {
  return 8 * rank_sort_width(n) + 4 * n;
}

extern "C" int fm_rank_ic_fused(const float* f, const float* r, float* ic,
                                float* n_valid, int rows, int n,
                                void* stream) {
  if (n < RS_MIN_WIDTH || n > RS_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  const int w = rank_sort_width(n);
  const int smem = rank_sort_smem_bytes(n);
  // always opted in: the post-sort body's static shared memory counts
  // against the 48 KB default too, so a dynamic size just under it fails
  cudaError_t e = cudaFuncSetAttribute(
      rank_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0) {
    rank_sort_kernel<<<rows, RIC_THREADS, smem, (cudaStream_t)stream>>>(
        f, r, ic, n_valid, n, w);
  }
  return (int)cudaGetLastError();
}
