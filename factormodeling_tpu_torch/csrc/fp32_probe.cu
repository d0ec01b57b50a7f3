// FP32 throughput probe: k dependent x = fma(x, 1.0000001f, 0.5f) steps on
// every element of a float32 array.
//
// Replaces the Pallas kernel tools/vpu_probe.py (probe), which measured the
// TPU vector unit's elementwise rate over the sort kernel's layout. Here it
// measures the H100's FP32 pipes: one fused multiply-add per step
// (__fmaf_rn, so the compiler can neither split nor fold it), counted as one
// operation as the JAX probe counts it; the data-sheet peak is 33.5 T FMA/s
// (67 TFLOP/s).
//
// Bound on an H100: the larger of bytes (each element read and written once,
// 8 B) and FMAs (numel * k). At [64, 50400, 128] (1.65 GB) that is 0.99 ms
// of bytes against 0.79 ms of FMAs at k = 64, so k = 64 is bytes-bound; at
// k = 256 the FMAs take 3.2 ms, so the rate is read there. Design: each
// thread owns PROBE_ELEMS independent elements (a block's 256 * 8 elements
// are contiguous, thread t taking t, t + 256, ... so loads coalesce) and
// steps them together, so eight independent chains hide the FMA latency.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_THREADS 256
#define PROBE_ELEMS 8

__global__ void __launch_bounds__(PROBE_THREADS)
fp32_probe_kernel(const float* __restrict__ x, float* __restrict__ y,
                  int64_t n, int k) {
  const int64_t base =
      (int64_t)blockIdx.x * PROBE_THREADS * PROBE_ELEMS + threadIdx.x;
  float v[PROBE_ELEMS];
#pragma unroll
  for (int e = 0; e < PROBE_ELEMS; ++e) {
    const int64_t i = base + (int64_t)e * PROBE_THREADS;
    v[e] = i < n ? x[i] : 0.0f;
  }
#pragma unroll 4
  for (int s = 0; s < k; ++s) {
#pragma unroll
    for (int e = 0; e < PROBE_ELEMS; ++e) v[e] = __fmaf_rn(v[e], 1.0000001f, 0.5f);
  }
#pragma unroll
  for (int e = 0; e < PROBE_ELEMS; ++e) {
    const int64_t i = base + (int64_t)e * PROBE_THREADS;
    if (i < n) y[i] = v[e];
  }
}

extern "C" int fm_fp32_probe(const float* x, float* y, int64_t n, int k,
                             void* stream) {
  if (n > 0) {
    const int64_t per_block = (int64_t)PROBE_THREADS * PROBE_ELEMS;
    const int64_t blocks = (n + per_block - 1) / per_block;
    fp32_probe_kernel<<<(unsigned)blocks, PROBE_THREADS, 0,
                        (cudaStream_t)stream>>>(x, y, n, k);
  }
  return (int)cudaGetLastError();
}
