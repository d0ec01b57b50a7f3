// Rank-IC after the cross-sectional sort, one warp (or a team of warps for
// rows past 992 cells) a row.
//
// Replaces the Pallas kernel factormodeling_tpu/metrics/_pallas_rank_ic.py
// (rank_ic_postsort). Input rows are already sorted by key with NaN (invalid
// cells) last, and the payload r is co-sorted with 0 at invalid cells. Per
// row the kernel forms average-tie 1-based ranks (NaN != NaN puts each NaN
// in its own run, and -0.0 == +0.0 ties) and the centered Pearson
// correlation of rank vs payload, with the rank mean in closed form (n+1)/2
// (rank_common.cuh's body, shared with the fused sort).
//
// Bound on an H100: bytes. The row is read from device memory once (8 B per
// element) and two floats per row come back; the arithmetic is a few
// operations per element: 533 MB at R = 66,600, M = 1000, 0.159 ms at
// 3.35 TB/s.
//
// What held the block-a-row form back (python -m
// factormodeling_tpu_torch.tile_sweep, split of that form, NVIDIA H100 80GB
// HBM3, 700 W; R = 66,600, M = 1000): whole 0.4285 ms; its row load alone
// 0.2022; without its two block scans 0.3651. 256 threads held 4 positions
// each and met at 5 block barriers a row; the load alone reached 1.27x the
// bound.
//
// Design. A team of row_layout(M).tw warps owns a row (one warp up to
// M = 992; two warps of 17 positions a lane at M = 1000), and a block holds
// as many teams as its shared memory takes (14 at M = 1000). The grid is
// persistent: team k takes rows k, k + K, ... (K teams in the grid), and
// each team keeps two row buffers in shared memory, so the next row's keys
// and payload are on their way while the current row is ranked. A row whose
// bytes start on 16-byte boundaries (M % 4 == 0 and aligned bases) arrives
// by two 1-D bulk copies (cp.async.bulk, the TMA) issued by one thread and
// completing on the buffer's mbarrier; any other row by 4-byte cp.async
// from every lane of the team. A one-warp team meets no block barrier in a
// row; the buffers land in position order and the odd chunk keeps the
// lanes' reads free of bank conflicts.
//
// Measured (tile_sweep, NVIDIA H100 80GB HBM3, 700 W; R = 66,600,
// M = 1000): 0.2111 ms; the same kernel with the body cut out (its loads
// alone) 0.1745; at most 15 positions a lane (three warps a row) 0.2417.
// A first version, one warp of 33 positions a lane with 64-bit run masks,
// took 0.2855 (the same with 31 positions, two warps a row: 0.2683).

#include "async_copy.cuh"
#include "rank_common.cuh"

// A row of float keys (NaN = invalid) and its co-sorted payload.
struct FloatRow {
  typedef float Key;
  const float* k;
  const float* r;
  __device__ Key key(int i) const { return k[i]; }
  __device__ static bool valid(Key a) { return !isnan(a); }
  __device__ float payload(int i) const { return r[i]; }
};

// kBulk: rows by bulk copies onto the buffers' mbarriers; else by 4-byte
// cp.async groups. Shared memory: [teams][nbuf][2][mpad] floats.
template <bool kBulk>
__global__ void __launch_bounds__(1024)
rank_ic_postsort_kernel(const float* __restrict__ s_key,
                        const float* __restrict__ r_s,
                        float* __restrict__ ic_out,
                        float* __restrict__ cnt_out, int rows, int m, int tw,
                        int ch, int nbuf, int mpad) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) unsigned long long s_bar[RIC_MAX_TEAMS][2];
  __shared__ TeamScratch sc;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / tw, w = warp - team * tw, t = w * 32 + lane;
  const int teams = blockDim.x / (32 * tw), TT = 32 * tw;
  float* base = smem + (size_t)team * nbuf * 2 * mpad;
  if (kBulk) {
    if (threadIdx.x < teams * nbuf)
      mbar_init(&s_bar[threadIdx.x / nbuf][threadIdx.x % nbuf]);
    mbar_init_fence();
  }
  __syncthreads();

  const int K = gridDim.x * teams;
  auto issue = [&](int row, int b) {
    float* dk = base + (size_t)b * 2 * mpad;
    const float* gk = s_key + (int64_t)row * m;
    const float* gr = r_s + (int64_t)row * m;
    if (kBulk) {
      if (t == 0) {
        fence_proxy_async();  // the team's reads of buffer b came first
        mbar_expect_tx(&s_bar[team][b], 8u * m);
        bulk_load(dk, gk, 4u * m, &s_bar[team][b]);
        bulk_load(dk + mpad, gr, 4u * m, &s_bar[team][b]);
      }
    } else {
      for (int i = t; i < m; i += TT) {
        cp_async<4>(dk + i, gk + i);
        cp_async<4>(dk + mpad + i, gr + i);
      }
      cp_async_commit();
    }
  };

  int slot = 0, it = 0;
  int row = blockIdx.x * teams + team;
  if (row < rows) issue(row, 0);
  for (; row < rows; row += K, ++it) {
    const int b = nbuf == 2 ? (it & 1) : 0;
    const bool more = row + K < rows;
    if (nbuf == 2 && more) issue(row + K, b ^ 1);
    if (kBulk) {
      mbar_wait(&s_bar[team][b], (nbuf == 2 ? it >> 1 : it) & 1);
    } else {
      if (nbuf == 2 && more)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      ric_team_sync(team, tw);
    }
    const float* buf = base + (size_t)b * 2 * mpad;
    rank_ic_team_row(FloatRow{buf, buf + mpad}, m, ch, team, tw, w, lane, sc,
                     slot, ic_out + row, cnt_out + row);
    ric_team_sync(team, tw);  // buffer b is free again
    if (nbuf == 1 && more) issue(row + K, 0);
  }
}

// The block's shape for rows of m: [tw, ch, nbuf, teams, mpad, smem bytes]
// (nbuf 2 where two buffers a team fit, teams as many as shared memory and
// 1024 threads take, at most RIC_MAX_TEAMS).
extern "C" void fm_rank_ic_layout(int m, int* out) {
  const RowLayout l = row_layout(m);
  const int mpad = (m + 3) & ~3;
  const int budget = 227 * 1024 - (int)sizeof(TeamScratch) - 512;
  const int per_buf = 8 * mpad;
  const int nbuf = 2 * 2 * per_buf <= budget ? 2 : 1;
  int teams = budget / (nbuf * per_buf);
  teams = min(teams, 1024 / (32 * l.tw));
  teams = min(teams, RIC_MAX_TEAMS);
  teams = max(teams, 1);
  out[0] = l.tw;
  out[1] = l.ch;
  out[2] = nbuf;
  out[3] = teams;
  out[4] = mpad;
  out[5] = teams * nbuf * per_buf;
}

template <bool kBulk>
static int launch(const float* s_key, const float* r_s, float* ic,
                  float* n_valid, int rows, int m, cudaStream_t stream) {
  int lay[6];
  fm_rank_ic_layout(m, lay);
  const int tw = lay[0], ch = lay[1], nbuf = lay[2], teams = lay[3];
  const int mpad = lay[4], smem = lay[5], threads = teams * 32 * tw;
  auto kernel = rank_ic_postsort_kernel<kBulk>;
  // always opted in: the static shared memory counts against the 48 KB
  // default too, so a dynamic size just under it fails
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0) {
    long long blocks = ((long long)rows + teams - 1) / teams;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (blocks > resident) blocks = resident;
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(
        s_key, r_s, ic, n_valid, rows, m, tw, ch, nbuf, mpad);
  }
  return (int)cudaGetLastError();
}

extern "C" int fm_rank_ic_postsort(const float* s_key, const float* r_s,
                                   float* ic, float* n_valid, int rows, int m,
                                   void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = m % 4 == 0 && ((uintptr_t)s_key & 15) == 0 &&
                       ((uintptr_t)r_s & 15) == 0;
  return aligned ? launch<true>(s_key, r_s, ic, n_valid, rows, m, s)
                 : launch<false>(s_key, r_s, ic, n_valid, rows, m, s);
}
