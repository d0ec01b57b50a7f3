// Rank-IC from unsorted rows: the sort, the average-tie ranks and the
// Pearson moments in one kernel.
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
// 0.159 ms at 3.35 TB/s. The int32 key (shifted to unsigned order) and the
// payload's bits travel as one 64-bit word, so one compare orders by key and
// a swap moves both; padding past n is the largest word (key 0x7fffffff,
// payload 0). Equal words are identical, so every correct sort of a row
// gives the same sequence.
//
// Design. A bitonic network over W = next_pow2(n) (at least 128) positions
// does log2(W) (log2(W) + 1) / 2 stages; stage (k2, j) orders each position
// p with p ^ j, ascending where p & k2 is 0. A team of TEAM = W / E threads
// sorts one row, thread t holding the E words of positions t E .. t E + E - 1
// in registers (E = RS_REG_WORDS, within W / 32 .. W / RIC_THREADS). So the
// stages of the low log2(E) bits are compare-exchanges between a thread's
// own registers (no memory, no barrier); the next 5 bits are lane bits,
// exchanged with __shfl_xor_sync; only the bits above those (the team's
// warps) go through shared memory, with a barrier. At W = 1024 a team is 4
// warps holding 8 words a thread, and a block sorts 2 rows: 27 register
// stages, 25 shuffle stages and 3 shared stages of 55. Rows up to 256 wide
// sort in one warp (E = 4, 8; 8 rows a block, no shared stage); at 8192 a
// team is the block (E = 32, 6 shared stages). More words a thread means
// fewer shuffle and shared stages but more registers, fewer resident warps
// and a longer serial post-sort per block: at W = 1024, 8 words a thread
// took 1.38 ms, 4 (one row a block) 1.48, 16 1.53 and 32 (one warp a row,
// no shared stage) 1.96 (python -m factormodeling_tpu_torch.tile_sweep,
// NVIDIA H100 80GB HBM3, 700 W); the sort alone 1.08 of the 1.38 ms, 2,480
// instructions a thread, most of them the 64-bit compares and selects. Where a word starts does not matter to a
// sort, so each thread loads cells e TEAM + t (coalesced). The sorted rows
// go to shared memory with their 32-word chunks XOR-swizzled (position p
// at p ^ ((p >> 5) & 31)), which keeps both the per-thread stores of E
// consecutive words and the team's exchanges free of bank conflicts. The
// block then runs rank_common.cuh's post-sort body, the same code as the
// post-sort kernel rank_ic.cu with the same team for the row's width
// (row_layout(n): two warps at n = 1000, so the block's 2 rows go to 4 of
// its 8 warps; at most 8 warps up to n = 8192), summing the same terms in
// the same order. Shared memory: 8 B x 256 E for the rows (16 KB at
// W = 1024, 64 KB at 8192). With that post-sort the kernel takes 1.2667 ms
// at R = 66,600, n = 1000 (1.4595 with one warp of 33 positions a row, the
// block-a-row post-sort before it 1.3834; tile_sweep, NVIDIA H100 80GB
// HBM3, 700 W).
//
// Prediction for this network, written before its first run on the card:
// at R = 66,600, n = 1000 the kernel takes 0.8-1.5 ms (the bitonic network
// in shared memory, 55 stages with a barrier each: 3.5114 ms), below the
// torch.sort + gather + K1 route of the same run (~3.14 ms). Measured:
// 1.37 ms against the route's 3.14 (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W).

#include <float.h>

#include "rank_common.cuh"

#define RS_MIN_WIDTH 128
#define RS_MAX_WIDTH 8192
#define RS_REG_WORDS 8  // words a thread holds, within the team's limits

// unsigned images of the JAX package's signed keys (k ^ 0x80000000)
#define RS_INF_U 0xff800000u   // +inf: the largest valid key
#define RS_NAN_U 0xffc00000u   // the canonical NaN
#define RS_PAD_WORD 0xffffffff00000000ull

typedef unsigned long long word_t;

__device__ __forceinline__ unsigned sort_key(float x) {
  if (isnan(x)) return RS_NAN_U;
  if (fabsf(x) < FLT_MIN) x = 0.0f;   // -0.0 and denormals tie +0.0
  const int u = __float_as_int(x);
  const int k = u < 0 ? (u ^ 0x7fffffff) : u;
  return (unsigned)k ^ 0x80000000u;
}

// where position p of a row lives in shared memory
__device__ __forceinline__ int swizzle(int p) { return p ^ ((p >> 5) & 31); }

// A sorted row of packed (key << 32 | payload bits) words, swizzled.
struct PackedRow {
  typedef unsigned Key;
  const word_t* a;
  __device__ word_t at(int i) const { return a[swizzle(i)]; }
  __device__ Key key(int i) const { return (unsigned)(at(i) >> 32); }
  __device__ static bool valid(Key k) { return k <= RS_INF_U; }
  __device__ float payload(int i) const {
    return __uint_as_float((unsigned)at(i));
  }
};

template <int W>
struct SortLayout {
  // RS_REG_WORDS words a thread, but a team of at least one warp and at
  // most one block
  static constexpr int E0 = W / 32 < RS_REG_WORDS ? W / 32 : RS_REG_WORDS;
  static constexpr int E = E0 > W / RIC_THREADS ? E0 : W / RIC_THREADS;
  static constexpr int TEAM = W / E;              // threads a row
  static constexpr int ROWS = RIC_THREADS / TEAM;  // rows a block
  static constexpr int LOG_W = W == 128    ? 7
                               : W == 256  ? 8
                               : W == 512  ? 9
                               : W == 1024 ? 10
                               : W == 2048 ? 11
                               : W == 4096 ? 12
                                           : 13;
};

// a gets the smaller word where keep_min, else the larger
__device__ __forceinline__ word_t pick(word_t a, word_t b, bool keep_min) {
  return ((b < a) == keep_min) ? b : a;
}

template <int W>
__global__ void __launch_bounds__(RIC_THREADS)
rank_sort_kernel(const float* __restrict__ f, const float* __restrict__ r,
                 float* __restrict__ ic_out, float* __restrict__ cnt_out,
                 int rows, int n) {
  using L = SortLayout<W>;
  constexpr int E = L::E, TEAM = L::TEAM, ROWS = L::ROWS;
  extern __shared__ word_t s_a[];  // [ROWS][W] rows
  __shared__ TeamScratch sc;

  const int team = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int64_t row = row0 + team;
  word_t* s_row = s_a + team * W;

  word_t a[E];
  {
    const bool live = row < rows;
    const float* fr = f + row * (int64_t)n;
    const float* rr = r + row * (int64_t)n;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * TEAM + t;
      a[e] = live && i < n ? ((word_t)sort_key(fr[i]) << 32)
                                 | __float_as_uint(rr[i])
                           : RS_PAD_WORD;
    }
  }

  // stage (k2 = 2^s, j = 2^b); thread t holds positions t E + e
#pragma unroll
  for (int s = 1; s <= L::LOG_W; ++s) {
    const int k2 = 1 << s;
#pragma unroll
    for (int b = s - 1; b >= 0; --b) {
      const int j = 1 << b;
      if (j < E) {
        // register stage: positions t E + e and t E + (e | j)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & j) continue;
          // one compare orders the pair: swap where the upper word
          // belongs below
          const bool up = ((t * E + e) & k2) == 0;
          const word_t lo = a[e], hi = a[e | j];
          const bool swap = (hi < lo) == up;
          a[e] = swap ? hi : lo;
          a[e | j] = swap ? lo : hi;
        }
      } else if (j < 32 * E) {
        // lane stage: the partner is lane ^ (j / E) of the same warp
        const int m = j / E;
        const bool keep_min = ((t & m) == 0) == (((t * E) & k2) == 0);
#pragma unroll
        for (int e = 0; e < E; ++e)
          a[e] = pick(a[e], __shfl_xor_sync(FULL_MASK, a[e], m), keep_min);
      } else {
        // shared stage: the partner is another warp of the team
        const bool keep_min = (((t * E) & j) == 0) == (((t * E) & k2) == 0);
        __syncthreads();  // the last stage's reads are done
#pragma unroll
        for (int e = 0; e < E; ++e) s_row[swizzle(t * E + e)] = a[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e)
          a[e] = pick(a[e], s_row[swizzle((t * E + e) ^ j)], keep_min);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) s_row[swizzle(t * E + e)] = a[e];
  __syncthreads();

  // the post-sort body: the block's rows by teams of row_layout(n).tw
  // warps, as the post-sort kernel takes a row of n
  const RowLayout lay = row_layout(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int teams = RIC_THREADS / 32 / lay.tw, pteam = warp / lay.tw;
  int slot = 0;
  if (pteam < teams) {
    for (int q = pteam; q < ROWS && row0 + q < rows; q += teams)
      rank_ic_team_row(PackedRow{s_a + q * W}, n, lay.ch, pteam, lay.tw,
                       warp - pteam * lay.tw, lane, sc, slot,
                       ic_out + row0 + q, cnt_out + row0 + q);
  }
}

static int rank_sort_width(int n) {
  int w = RS_MIN_WIDTH;
  while (w < n) w <<= 1;
  return w;
}

template <int W>
static int launch_width(const float* f, const float* r, float* ic,
                        float* n_valid, int rows, int n, cudaStream_t stream) {
  using L = SortLayout<W>;
  // the sorted rows
  const int smem = 8 * L::ROWS * W;
  // always opted in: the post-sort body's static shared memory counts
  // against the 48 KB default too, so a dynamic size just under it fails
  cudaError_t e = cudaFuncSetAttribute(
      rank_sort_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0) {
    const int blocks = (rows + L::ROWS - 1) / L::ROWS;
    rank_sort_kernel<W><<<blocks, RIC_THREADS, smem, stream>>>(
        f, r, ic, n_valid, rows, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fm_rank_ic_fused(const float* f, const float* r, float* ic,
                                float* n_valid, int rows, int n,
                                void* stream) {
  if (n < RS_MIN_WIDTH || n > RS_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rank_sort_width(n)) {
    case 128: return launch_width<128>(f, r, ic, n_valid, rows, n, s);
    case 256: return launch_width<256>(f, r, ic, n_valid, rows, n, s);
    case 512: return launch_width<512>(f, r, ic, n_valid, rows, n, s);
    case 1024: return launch_width<1024>(f, r, ic, n_valid, rows, n, s);
    case 2048: return launch_width<2048>(f, r, ic, n_valid, rows, n, s);
    case 4096: return launch_width<4096>(f, r, ic, n_valid, rows, n, s);
    default: return launch_width<8192>(f, r, ic, n_valid, rows, n, s);
  }
}
