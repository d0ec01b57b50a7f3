// The composite normalization chain group_neutralize(cs_zscore(x), gids, G)
// in one pass over rows of N assets; float and double.
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
// D = 1260, N = 3000 (0.46 ms at 3.35 TB/s), 0.54 GB at path 4's R = 50,
// D = 1332, N = 1000 (0.16 ms), against about 10 + 2 G operations per cell.
//
// What held the block-a-row form back (python -m
// factormodeling_tpu_torch.tile_sweep, split of that form, NVIDIA H100 80GB
// HBM3, 700 W; ms at [50, 1332, 1000] / [50, 1260, 3000]): whole 0.906 /
// 1.448; without the G group passes 0.361 / 0.836; its load and store alone
// 0.274 / 0.724; the ids of one date for every row 0.896 / 1.433. So the
// group passes over shared memory cost 60% / 42% of the time, one block of
// 256 threads a row cannot even stream at the bound, and the ids are not
// read again from device memory (L2 holds them).
//
// Design (the register form, rows of up to REG_WIDTH assets). A team of TW
// warps owns a row and each thread holds C of its cells in registers, cell
// c of thread t at i = c 32 TW + t, with (TW, C) the smallest team and then
// the fewest cells of ZG_CELLS that cover N: one warp of 32 cells at
// N = 1000, four warps of 24 at N = 3000. While a team reduces its row, the
// next row's cells and ids arrive in its staging buffer in shared memory
// by two 1-D bulk copies (cp.async.bulk, the TMA) on the team's mbarrier
// (4- or 8-byte cp.async where N % 4 != 0); the team reads them into
// registers at the row's start (consecutive lanes, consecutive words) and
// frees the buffer for the copy after. The G group sums cost the same for
// every G: each lane adds its cells' z and a count into its own column of
// its warp's [G + 1][32] table in shared memory (column = lane, so no two
// lanes of a half-warp share a bank; row G takes the NaN cells and ids
// outside [0, G)), then lane g adds row g from lane g on (g, .., 31, 0, ..,
// g - 1: again no shared bank) and keeps group g's mean; each cell takes
// its group's by a shuffle. The moments are a thread's cells in order, then
// an xor butterfly (which leaves the same bits in every lane); z multiplies
// by the reciprocal of sigma; a team of several warps adds its warps in
// order through shared memory at one named barrier an exchange (the
// partials alternate between two slots, so no second barrier guards their
// reuse). Counts are exact, multiply and add round apart and no sum uses an
// atomic, so two runs agree bit for bit and a CPU emulation of the order
// reproduces the kernel. The grid is persistent (as many blocks of 256
// threads as fit the card at once) and the teams walk the rows date-major
// (the F rows of a date together), x and out streaming with evict-first
// hints. Rows wider than REG_WIDTH, and rows whose stages and group tables
// would pass a block's opt-in shared memory (float64 with ~30 groups or
// more), keep the block-a-row forms: the row and its ids in shared memory up
// to SMEM_WIDTH assets, else its z-values in the output row. G <= 32.
//
// Measured (python -m factormodeling_tpu_torch.tile_sweep --parts variants,
// NVIDIA H100 80GB HBM3, 700 W; ms at [50, 1332, 1000] / [50, 1260, 3000],
// G = 11): 0.2501 / 0.6276; the walk row-major 0.2462 / 0.6735; the ids
// read from L2 at the row's start instead of staged 0.5425 / 1.3002; built
// for 3 blocks an SM 0.4958 / 1.0605 (more spills); no group table 0.2307
// / 0.5908; the load and store alone 0.2111 / 0.5612. A first version kept
// the next row in a second register set and summed each group by a
// predicated pass over the thread's cells: it spilled, at about twice the
// time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

#define ZG_THREADS 256
#define ZG_WARPS (ZG_THREADS / 32)
#define ZG_MAX_GROUPS 32
#define SMEM_WIDTH 16384
#define REG_WIDTH 8192  // 32 cells a thread, a team of ZG_WARPS warps
#define FULL_MASK 0xffffffffu

// cells a thread of the register form, in the order the layout tries them
#define ZG_CELLS {8, 16, 24, 32}

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
__device__ __forceinline__ T warp_allsum(T v) {
  // lanes l and l ^ o add the same two values, so every lane ends with the
  // same bits
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// the team's threads meet (one warp: the warp)
__device__ __forceinline__ void team_sync(int team, int tw) {
  if (tw == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(tw * 32)
                 : "memory");
  }
}

// The team's total of a warp total v (the same in every lane): the team's
// warps in order through slot[warp0 .. warp0 + tw); tw == 1 returns v.
template <typename T>
__device__ __forceinline__ T team_total(T v, T (*slot)[ZG_MAX_GROUPS + 1],
                                        int warp0, int tw, int w, int lane,
                                        int team) {
  if (tw == 1) return v;
  if (lane == 0) slot[warp0 + w][0] = v;
  team_sync(team, tw);
  T tot = slot[warp0][0];
  for (int q = 1; q < tw; ++q) tot += slot[warp0 + q][0];
  return tot;
}

// A lane's running sum and count (exact in T) of one group's cells.
template <typename T>
struct GroupAcc {
  T s, c;
};

// blocks an SM the register form is built for (its register cap)
#define ZG_MIN_BLOCKS 2
// the opt-in shared memory of a block on sm_90 (227 KB)
#define ZG_SMEM_OPTIN 232448

// unit u of the grid's walk is row unit_row(u): the F rows of one date
// together, so a date's ids are fetched while L2 still holds them
__device__ __forceinline__ int unit_row(int u, int F, int D) {
  const int d = u / F;
  return (u - d * F) * D + d;
}

// The register form's static shared memory: the teams' mbarriers and the
// teams' exchange slots (two, used in turn).
template <typename T>
struct RegStatic {
  unsigned long long bar[ZG_WARPS];
  T sum[2][ZG_WARPS][ZG_MAX_GROUPS + 1];
  T gcnt[2][ZG_WARPS][ZG_MAX_GROUPS + 1];
  int n[2][ZG_WARPS];
};

// A team's staging buffer for rows of n assets ([n] cells, then their [n]
// ids), and the bytes one row's copies bring into it.
template <typename T>
__host__ __device__ __forceinline__ int stage_bytes(int n) {
  return n * (int)(sizeof(T) + 4);
}

// The register form: a team of tw warps a row, C cells a thread in
// registers. Each team stages its next row and the row's ids in shared
// memory by asynchronous copies while it reduces the current one: kBulk, by
// 1-D bulk copies onto the team's mbarrier (N % 4 == 0, aligned bases); else
// by 4- or 8-byte cp.async from every thread. Dynamic shared memory: the
// teams' staging buffers (stage_bytes(npad) each), then each warp's
// [G + 1][32] group table (row G takes the cells of no group).
template <typename T, int C, bool kBulk>
__global__ void __launch_bounds__(ZG_THREADS, ZG_MIN_BLOCKS)
zscore_group_regs(const T* __restrict__ x, const int* __restrict__ gids,
                  T* __restrict__ out, int rows, int D, int N, int G, int tw,
                  int npad) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ RegStatic<T> sh;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int teams = ZG_WARPS / tw, team = warp / tw, w = warp - team * tw;
  const int warp0 = team * tw, TT = 32 * tw, t = w * 32 + lane;
  const int F = rows / D, K = gridDim.x * teams;
  const int stage = stage_bytes<T>(npad);
  T* sx = reinterpret_cast<T*>(smem_raw + team * stage);
  int* sid = reinterpret_cast<int*>(sx + npad);
  GroupAcc<T>* tab =
      reinterpret_cast<GroupAcc<T>*>(smem_raw + teams * stage) +
      warp * (G + 1) * 32;
  if (kBulk) {
    if (threadIdx.x < teams) mbar_init(&sh.bar[threadIdx.x]);
    mbar_init_fence();
  }
  __syncthreads();

  auto issue = [&](int u) {
    const int row = unit_row(u, F, D);
    const T* gx = x + (int64_t)row * N;
    const int* gg = gids + (int64_t)(row % D) * N;
    if (kBulk) {
      if (t == 0) {
        fence_proxy_async();  // the team's reads of the stage came first
        mbar_expect_tx(&sh.bar[team], stage_bytes<T>(N));
        bulk_load(sx, gx, N * (unsigned)sizeof(T), &sh.bar[team]);
        bulk_load(sid, gg, 4u * N, &sh.bar[team]);
      }
    } else {
      for (int i = t; i < N; i += TT) {
        cp_async<sizeof(T)>(sx + i, gx + i);
        cp_async<4>(sid + i, gg + i);
      }
      cp_async_commit();
    }
  };

  int u = blockIdx.x * teams + team, it = 0, buf = 0;
  if (u < rows) issue(u);
  for (; u < rows; u += K, ++it) {
    const int row = unit_row(u, F, D);
    if (kBulk) {
      mbar_wait(&sh.bar[team], it & 1);
    } else {
      cp_async_wait<0>();
      team_sync(team, tw);
    }
    T v[C];
    int gi[C];  // the ids, then the table row: G where z is NaN or no group
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = c * TT + t;
      v[c] = i < N ? sx[i] : nan_of<T>();
      gi[c] = i < N ? sid[i] : -1;
    }
    team_sync(team, tw);  // the stage is free for the next row
    if (u + K < rows) issue(u + K);
    for (int g = 0; g <= G; ++g) tab[g * 32 + lane] = GroupAcc<T>{T(0), T(0)};

    T s = T(0);
    int n = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!isnan(v[c])) {
        s += v[c];
        ++n;
      }
    }
    s = warp_allsum(s);
    n = __reduce_add_sync(FULL_MASK, n);
    if (tw > 1) {  // the sum and the count share one barrier
      if (lane == 0) {
        sh.sum[buf][warp][0] = s;
        sh.n[buf][warp] = n;
      }
      team_sync(team, tw);
      s = sh.sum[buf][warp0][0];
      n = sh.n[buf][warp0];
      for (int q = 1; q < tw; ++q) {
        s += sh.sum[buf][warp0 + q][0];
        n += sh.n[buf][warp0 + q];
      }
    }
    buf ^= 1;
    const T mean = s / (T)n;  // n == 0 -> NaN, inert
    T ss = T(0);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!isnan(v[c])) {
        const T dv = v[c] - mean;
        ss += mul_rn(dv, dv);
      }
    }
    ss = team_total(warp_allsum(ss), sh.sum[buf], warp0, tw, w, lane, team);
    buf ^= 1;
    const T rsig = T(1) / sqrt(ss / (T)n);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = (v[c] - mean) * rsig;
      if (isnan(v[c]) || (unsigned)gi[c] >= (unsigned)G) gi[c] = G;
      GroupAcc<T>& e = tab[gi[c] * 32 + lane];
      e.s += v[c];
      e.c += T(1);
    }
    __syncwarp();

    // lane g < G: the warp's sum and count of group g, its lanes from g on
    // (g, g + 1, .., 31, 0, .., g - 1: no two lanes of a half-warp on one
    // bank)
    T m_lane = nan_of<T>(), sg = T(0), cg = T(0);
    if (lane < G) {
#pragma unroll 8
      for (int q = 0; q < 32; ++q) {
        const GroupAcc<T> e = tab[lane * 32 + ((q + lane) & 31)];
        sg += e.s;
        cg += e.c;
      }
    }
    __syncwarp();  // the table is zeroed for the next row
    if (tw == 1) {
      m_lane = sg / cg;  // empty: 0 / 0 -> NaN
    } else {
      if (lane < G) {
        sh.sum[buf][warp][lane] = sg;
        sh.gcnt[buf][warp][lane] = cg;
      }
      team_sync(team, tw);
      if (lane < G) {
        sg = sh.sum[buf][warp0][lane];
        cg = sh.gcnt[buf][warp0][lane];
        for (int q = 1; q < tw; ++q) {
          sg += sh.sum[buf][warp0 + q][lane];
          cg += sh.gcnt[buf][warp0 + q][lane];
        }
        m_lane = sg / cg;
      }
      buf ^= 1;
    }

    T* orow = out + (int64_t)row * N;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = c * TT + t, k = gi[c];
      const T gm = __shfl_sync(FULL_MASK, m_lane, k & 31);
      if (i < N) __stcs(orow + i, k < G ? v[c] - gm : nan_of<T>());
    }
  }
}

// The register form's dynamic shared memory for rows of n assets and G
// groups with teams of tw warps.
template <typename T>
static int reg_smem(int n, int G, int tw) {
  return ZG_WARPS / tw * stage_bytes<T>((n + 3) & ~3) +
         ZG_WARPS * (G + 1) * 32 * (int)sizeof(GroupAcc<T>);
}

// (team warps, cells a thread) of the register form for a row of n assets
// and G groups: the smallest team, then the fewest cells, that cover n;
// false past REG_WIDTH, or where the form's shared memory (the teams'
// stages and the warps' group tables) passes a block's opt-in, as in
// float64 with ~30 groups or more
template <typename T>
static bool reg_layout(int n, int G, int* tw, int* cells) {
  static const int kCells[] = ZG_CELLS;
  for (int w = 1; w <= ZG_WARPS; w <<= 1) {
    for (int c : kCells) {
      if (32 * w * c >= n) {
        *tw = w;
        *cells = c;
        return ((sizeof(RegStatic<T>) + 127) & ~(size_t)127) +
                   reg_smem<T>(n, G, w) <=
               ZG_SMEM_OPTIN;
      }
    }
  }
  return false;
}

// The form for rows of n assets, G groups and elements of elem bytes (4 or
// 8), as launch() takes it: [form (0 registers, 1 shared memory, 2 wide),
// team warps, cells a thread, the register form's dynamic shared memory].
extern "C" void fm_zscore_group_layout(int n, int G, int elem, int* out) {
  out[1] = ZG_WARPS;
  out[2] = out[3] = 0;
  const bool regs = elem == 8 ? reg_layout<double>(n, G, &out[1], &out[2])
                              : reg_layout<float>(n, G, &out[1], &out[2]);
  if (regs)
    out[3] = elem == 8 ? reg_smem<double>(n, G, out[1])
                       : reg_smem<float>(n, G, out[1]);
  out[0] = regs ? 0 : n <= SMEM_WIDTH ? 1 : 2;
}

template <typename T, int C, bool kBulk>
static int launch_regs_form(const T* x, const int* gids, T* out, int rows,
                            int D, int N, int G, int tw,
                            cudaStream_t stream) {
  auto kernel = zscore_group_regs<T, C, kBulk>;
  const int teams = ZG_WARPS / tw, npad = (N + 3) & ~3;
  const int smem = reg_smem<T>(N, G, tw);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      ZG_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  long long blocks = ((long long)rows + teams - 1) / teams;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, ZG_THREADS, smem, stream>>>(x, gids, out, rows,
                                                          D, N, G, tw, npad);
  return (int)cudaGetLastError();
}

template <typename T, int C>
static int launch_regs(const T* x, const int* gids, T* out, int rows, int D,
                       int N, int G, int tw, cudaStream_t stream) {
  const bool bulk = N % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                    ((uintptr_t)gids & 15) == 0;
  return bulk ? launch_regs_form<T, C, true>(x, gids, out, rows, D, N, G,
                                             tw, stream)
              : launch_regs_form<T, C, false>(x, gids, out, rows, D, N, G,
                                              tw, stream);
}

template <typename T>
static int launch(const T* x, const int* gids, T* out, long long rows, int D,
                  int N, int G, void* stream) {
  if (G < 1 || G > ZG_MAX_GROUPS || D < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || N <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  int tw = 0, cells = 0;
  if (reg_layout<T>(N, G, &tw, &cells)) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (cells) {
      case 8:
        return launch_regs<T, 8>(x, gids, out, (int)rows, D, N, G, tw, s);
      case 16:
        return launch_regs<T, 16>(x, gids, out, (int)rows, D, N, G, tw, s);
      case 24:
        return launch_regs<T, 24>(x, gids, out, (int)rows, D, N, G, tw, s);
      default:
        return launch_regs<T, 32>(x, gids, out, (int)rows, D, N, G, tw, s);
    }
  }
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
