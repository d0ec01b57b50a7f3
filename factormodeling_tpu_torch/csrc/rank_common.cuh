// The rank-IC body over one sorted row, shared by rank_ic.cu (the post-sort
// stage, K1) and rank_sort.cu (the fused sort, K3). Both hand a sorted row
// in shared memory to rank_ic_team_row with the team that row_layout gives
// for its width, so on a row without ties the two sum the same terms in the
// same order.
//
// A team of tw warps owns a row; lane t of the team (t = 32 w + lane) owns
// the contiguous chunk of positions t ch .. t ch + ch - 1, with ch odd, so
// the lanes' reads of position t ch + j fall on 32 distinct banks of a row
// laid out in order. Two passes over the chunk, each position read once a
// pass:
//   1. run starts (position 0, or a key unlike the one before) and valid
//      cells as bit masks, the valid count and the payload sum;
//   2. for each valid position p: its run's start f (the last start at or
//      before p, else the carry from the lanes before) and end l (the next
//      start after p, less one, else the carry from the lanes after), the
//      average-tie 1-based rank (f + l) / 2 + 1, and the centered moments
//      with the rank mean in closed form (n + 1) / 2.
// The carries are warp scans (__shfl_up / __shfl_down), the sums a lane's
// positions in order, then the warp by an xor butterfly (every lane gets the
// same bits), then the team's warps in order. Multiply and add are rounded
// apart (no contraction). A one-warp team meets no barrier; a larger team
// meets at one named barrier (id 1 + team) for each of its two exchanges,
// whose slots alternate so that no second barrier guards their reuse.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RIC_THREADS 256
// positions a lane at most: 31 (32-bit masks) while the row fits the
// fused sort's block of RIC_THREADS lanes that way, else 63 (64-bit masks)
#define RIC_MAX_CHUNK 31
#define RIC_WIDE_CHUNK 63
#define RIC_MAX_TEAMS 15  // named barriers 1..15
#define RIC_MAX_WARPS 32
#define FULL_MASK 0xffffffffu

struct RowLayout {
  int tw;  // warps a row
  int ch;  // positions a lane (odd)
};

// The fewest warps whose lanes take at most RIC_MAX_CHUNK positions each
// (RIC_WIDE_CHUNK where that takes more than RIC_THREADS lanes), and the
// odd chunk that covers the row with them.
__host__ __device__ inline RowLayout row_layout(int m) {
  int lanes = (m + RIC_MAX_CHUNK - 1) / RIC_MAX_CHUNK;
  if (lanes > RIC_THREADS) lanes = (m + RIC_WIDE_CHUNK - 1) / RIC_WIDE_CHUNK;
  RowLayout l;
  l.tw = lanes > 32 ? (lanes + 31) / 32 : 1;
  l.ch = ((m + 32 * l.tw - 1) / (32 * l.tw)) | 1;
  return l;
}

// The teams' partials: [2 slots][warp of the block][words].
struct TeamScratch {
  int i[2][RIC_MAX_WARPS][3];
  float f[2][RIC_MAX_WARPS][3];
};

__device__ __forceinline__ void ric_team_sync(int team, int tw) {
  if (tw == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(tw * 32)
                 : "memory");
  }
}

// 1 + the index of the lowest set bit (the argument is not 0)
__device__ __forceinline__ int first_bit(unsigned v) { return __ffs((int)v); }
__device__ __forceinline__ int first_bit(unsigned long long v) {
  return __ffsll((long long)v);
}

__device__ __forceinline__ float warp_allsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Average-tie ranks and the rank-IC of one sorted row of m cells (invalid
// cells last) by the team `team` of tw warps (this thread: warp w of it,
// lane `lane`). `row` gives key(i), the key's valid(k) and payload(i);
// ch = row_layout(m).ch, at most the bits of Mask. `slot` alternates
// between 0 and 1 across the team's exchanges. The team's thread 0 writes
// the row's ic and valid count.
template <typename Mask, class Row>
__device__ __forceinline__ void team_row(const Row& row, int m, int ch,
                                         int team, int tw, int w, int lane,
                                         TeamScratch& sc, int& slot,
                                         float* ic_out, float* cnt_out) {
  typedef typename Row::Key Key;
  const int t = w * 32 + lane, b = t * ch;
  const int warp = team * tw + w, warp0 = team * tw;
  const int e = min(b + ch, m);  // this lane's positions: b .. e - 1

  // pass 1: run starts and valid cells, count and payload sum
  Mask starts = 0, valids = 0;
  int cnt = 0, last_start = -1, first_start = m;
  float sum_r = 0.0f;
  Key prev = b > 0 && b < m ? row.key(b - 1) : Key();
  for (int p = b; p < e; ++p) {
    const Key k = row.key(p);
    const int j = p - b;
    if (p == 0 || !(k == prev)) {
      starts |= Mask(1) << j;
      last_start = p;
      first_start = min(first_start, p);
    }
    if (Row::valid(k)) {
      valids |= Mask(1) << j;
      ++cnt;
    }
    sum_r += row.payload(p);
    prev = k;
  }

  // carries: the last start before this lane, the first start after it
  int incl_max = last_start, incl_min = first_start;
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(FULL_MASK, incl_max, o);
    const int c = __shfl_down_sync(FULL_MASK, incl_min, o);
    if (lane >= o) incl_max = max(incl_max, a);
    if (lane + o < 32) incl_min = min(incl_min, c);
  }
  int fcarry = __shfl_up_sync(FULL_MASK, incl_max, 1);
  int lcarry = __shfl_down_sync(FULL_MASK, incl_min, 1);
  if (lane == 0) fcarry = -1;
  if (lane == 31) lcarry = m;
  sum_r = warp_allsum(sum_r);
  cnt = __reduce_add_sync(FULL_MASK, cnt);
  if (tw > 1) {
    if (lane == 31) sc.i[slot][warp][0] = incl_max;
    if (lane == 0) {
      sc.i[slot][warp][1] = incl_min;
      sc.i[slot][warp][2] = cnt;
      sc.f[slot][warp][0] = sum_r;
    }
    ric_team_sync(team, tw);
    for (int q = 0; q < w; ++q)
      fcarry = max(fcarry, sc.i[slot][warp0 + q][0]);
    for (int q = w + 1; q < tw; ++q)
      lcarry = min(lcarry, sc.i[slot][warp0 + q][1]);
    sum_r = sc.f[slot][warp0][0];
    cnt = sc.i[slot][warp0][2];
    for (int q = 1; q < tw; ++q) {
      sum_r += sc.f[slot][warp0 + q][0];
      cnt += sc.i[slot][warp0 + q][2];
    }
    slot ^= 1;
  }

  const float cs = cnt > 0 ? (float)cnt : __int_as_float(0x7fc00000);
  const float mr = sum_r / cs;
  const float mrank = (cs + 1.0f) * 0.5f;

  // pass 2: ranks and centered moments, positions in order
  float cov = 0.0f, var_rank = 0.0f, var_r = 0.0f;
  int f = fcarry;
  for (int p = b; p < e; ++p) {
    const int j = p - b;
    if ((starts >> j) & Mask(1)) f = p;
    if ((valids >> j) & Mask(1)) {
      // j + 1 <= ch - 1 < the mask's bits: the next start in this chunk,
      // else the carry
      const Mask after = starts >> (j + 1);
      const int l = (after ? p + first_bit(after) : lcarry) - 1;
      const float rank = __fadd_rn(__fmul_rn(0.5f, (float)(f + l)), 1.0f);
      const float drk = rank - mrank;
      const float dr = row.payload(p) - mr;
      cov = __fadd_rn(cov, __fmul_rn(drk, dr));
      var_rank = __fadd_rn(var_rank, __fmul_rn(drk, drk));
      var_r = __fadd_rn(var_r, __fmul_rn(dr, dr));
    }
  }
  cov = warp_allsum(cov);
  var_rank = warp_allsum(var_rank);
  var_r = warp_allsum(var_r);
  if (tw > 1) {
    if (lane == 0) {
      sc.f[slot][warp][0] = cov;
      sc.f[slot][warp][1] = var_rank;
      sc.f[slot][warp][2] = var_r;
    }
    ric_team_sync(team, tw);
    cov = sc.f[slot][warp0][0];
    var_rank = sc.f[slot][warp0][1];
    var_r = sc.f[slot][warp0][2];
    for (int q = 1; q < tw; ++q) {
      cov += sc.f[slot][warp0 + q][0];
      var_rank += sc.f[slot][warp0 + q][1];
      var_r += sc.f[slot][warp0 + q][2];
    }
    slot ^= 1;
  }
  if (t == 0) {
    *ic_out = cov / sqrtf(var_rank * var_r);
    *cnt_out = (float)cnt;
  }
}

// The body with 32-bit masks where the chunk allows, else 64-bit.
template <class Row>
__device__ __forceinline__ void rank_ic_team_row(const Row& row, int m,
                                                 int ch, int team, int tw,
                                                 int w, int lane,
                                                 TeamScratch& sc, int& slot,
                                                 float* ic_out,
                                                 float* cnt_out) {
  if (ch <= 31)
    team_row<unsigned>(row, m, ch, team, tw, w, lane, sc, slot, ic_out,
                       cnt_out);
  else
    team_row<unsigned long long>(row, m, ch, team, tw, w, lane, sc, slot,
                                 ic_out, cnt_out);
}
