// One ADMM segment of the box/L1 QP solver: seg_len iterations at a fixed
// rho in one launch, for B independent problems ("lanes"), one thread-block
// cluster of C blocks per lane; float and double.
//
// Replaces the Pallas kernel factormodeling_tpu/ops/_pallas_admm.py
// (admm_segment, vmapped over lanes): the plain iteration, the safeguarded
// Anderson accelerator (m = anderson > 0), the iterations-to-converge tally
// (collect) and the plain tail of a solve's last segment. Per iteration:
//   rd = (rho (z - u) - q) / d
//   t  = V rd             (T dot products over N)
//   t2 = t kinv           (Woodbury inner inverse, T x T)
//   xt = rd - (t2 V) / d
//   x  = xt - (ge xt) mt + xb      (equality correction, K rows)
//   xr = relax x + (1 - relax) z;  w = xr + u
//   z' = clip(center + soft(w - center, thresh), lo, hi);  u' = w - z'
// then, under Anderson, on v = [z, u] (2N wide) with v_f = [z', u'] and
// g = v_f - v:
//   r = |g|; a residual above safeguard * (best r so far) drops the history
//   and rolls back to the best plain iterate vg; otherwise push the
//   difference rows (v - v_prev, g - g_prev) into the depth-m history S, Y
//   (newest first); gamma solves the masked m x m normal equations of Y
//   (relative ridge, pivot-free Gauss-Jordan, as ops/_linalg.py::aa_mix);
//   cand = v_f - gamma (S + Y); take cand when the history is non-empty, r
//   is the best so far, max(|x - z'|, rho dz) > conv_tol,
//   |cand - v_f| <= step_clamp r, cand is finite, and the iteration lies
//   outside the plain tail of a last segment.
// Stats per lane: dz = max |z' - z| of the last iteration, the accept and
// rollback tallies, and (collect) the first 1-based iteration with
// max(|x - z'|, rho dz) <= conv_tol.
//
// Bound on an H100: neither bytes nor operations. One segment at T = 60,
// N = 1000 moves about 0.6 MB in double and does about 7 MFLOP (Anderson at
// m = 5 adds about 1 MFLOP), a fraction of a microsecond at the card's
// rates. What it waits on is the serial chain: seg_len dependent
// iterations, each of eight phases that end at a block barrier or an
// exchange with the other blocks of the lane (2-3 exchanges a plain
// iteration, 5 under Anderson), each phase a short chain of dependent
// shared-memory loads, shuffles and float64 divisions; PERF.md gives the
// cycles of each phase (segment_phases.py).
//
// Design: one lane is one cluster of C blocks (cudaLaunchKernelEx with the
// cluster-dimension attribute, grid B * C), block r owning the contiguous
// slice [r nl, (r + 1) nl) of the asset axis, nl = ceil(N / C). C is chosen
// by the caller from (T, N, dtype) alone, never from B, so a lane's
// arithmetic does not depend on how many lanes share the launch. At launch
// each block copies kinv (transposed) and its columns of V ([T, nl]) into
// its own shared memory, rows padded so that the four lanes reading a row
// together and the warp's other rows fall on distinct banks; both passes
// over V then read shared memory on C SMs at once, not L2 on one SM. z and
// u stay in registers of the thread owning each coordinate (at most 8 per
// thread). Cross-block sums go through distributed shared memory, pushed:
// each block stores its partials (the T values of V rd, the K equality
// sums, the residual maxes and sums, the Anderson Gram and right-hand
// sides, the step length) as its row of an exchange slot in every block of
// the cluster with st.async, whose bytes complete on the receiving block's
// mbarrier for that slot; a block waits on its own mbarrier, not on a
// cluster barrier, and adds the C rows of its own copy in block-rank order,
// so every block holds bitwise-identical totals and takes the same branch
// at every Anderson gate. The two slots alternate; a block stores into a
// slot again only after it has received every block's next exchange, which
// each block sends only after a block barrier that follows its reads of
// the slot. (Reading the other blocks' partials after a cluster.sync() per
// exchange, the first form of this kernel, was slower: PERF.md.) The Anderson
// history (S, Y: 2m rows of 2 nl) and six 2 nl scratch rows of a block's
// slice also live in its shared memory; each block solves the m x m system
// on one warp, a lane per column of the augmented matrix, pivot rows
// passed by shuffles, from the identical Gram. Where kinv, V's slice or the
// history does not fit beside the rest (in that order of preference: at
// T = 60, N = 4096 in double V's slice would take 245 KB a block), it is
// read from device memory through L2 instead (the history from a per-block
// workspace the caller allocates); the caller says which (k_shared,
// v_shared, h_shared) and fm_admm_segment_smem gives the bytes. A cluster
// the card cannot place is refused with an error code, never run another
// way; a wait that never completes traps instead of hanging.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

// Per-phase clock cycles of the first block's thread 0, summed over the
// iterations of every launch, when built with -DFM_SEG_PHASES
// (factormodeling_tpu_torch/segment_phases.py); nothing otherwise.
#define N_PHASES 16
#ifdef FM_SEG_PHASES
__device__ unsigned long long fm_phase_cycles[N_PHASES];
#define PHASE_START                                     \
  unsigned long long ph_t = clock64(), ph_acc[N_PHASES]; \
  for (int i = 0; i < N_PHASES; ++i) ph_acc[i] = 0;
#define PHASE(i)                                    \
  do {                                              \
    const unsigned long long ph_n = clock64();      \
    ph_acc[i] += ph_n - ph_t;                       \
    ph_t = ph_n;                                    \
  } while (0)
#define PHASE_END                                            \
  if (blockIdx.x == 0 && threadIdx.x == 0)                   \
    for (int i = 0; i < N_PHASES; ++i)                       \
      atomicAdd(fm_phase_cycles + i, ph_acc[i]);
#else
#define PHASE_START
#define PHASE(i)
#define PHASE_END
#endif

#define SEG_THREADS 256
#define SEG_WARPS (SEG_THREADS / 32)
#define SEG_COLS 8      // coordinates per thread: nl <= SEG_THREADS * SEG_COLS
#define SEG_KMAX 4      // equality rows (the leg constraints have 2)
#define AA_MMAX 8       // deepest Anderson history
#define GRAM_BATCH 3    // Gram entries a warp sums in one pass over its slice
#define RED_MAX 4       // values in one cluster reduction
#define XCH_MIN 44      // exchange row: >= T and the Gram's m (m + 1) / 2 + m
#define ROW_GROUP 4     // lanes summing one row in the V rd and t kinv passes
#define FULL_MASK 0xffffffffu
#define SMEM_LIMIT 232448   // 227 KB of dynamic shared memory per block
#define MBAR_BYTES 16   // the two exchange slots' mbarriers

// NaN-propagating max/min and sign, like jnp.maximum / minimum / sign.
template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T pmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T psign(T a) {
  return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a);  // sign(0)=0, sign(NaN)=NaN
}

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static __device__ float tiny() { return 1.17549435e-38f; }
};
template <>
struct Eps<double> {
  static __device__ double tiny() { return 2.2250738585072014e-308; }
};

// Row stride in shared memory of rows of n elements of ew 4-byte words
// that ROW_GROUP lanes read together: the rows of a warp's groups fall on
// distinct banks (stride = ROW_GROUP mod 32 / ew).
static __host__ __device__ int row_stride(int n, int ew) {
  const int w = 32 / ew;
  return n + ((ROW_GROUP % w - n % w) + w) % w;
}

// Shared-memory elements of one block (mirrored by _cuda_admm.py's plan),
// after the two slots' mbarriers (16 bytes): rd, t, t2 (later the Gram
// totals), the warp partials, two exchange slots of C rows, gamma; then,
// where the caller places them there, kinv (transposed), V's slice and the
// history's.
static int smem_elems(int Tw, int nl, int m, int C, int ew, int k_shared,
                      int v_shared, int h_shared) {
  const int x = Tw > XCH_MIN ? Tw : XCH_MIN;
  int e = nl + Tw + x + RED_MAX * SEG_WARPS + 2 * C * x + AA_MMAX;
  if (k_shared) e += Tw * row_stride(Tw, ew);
  if (v_shared) e += Tw * row_stride(nl, ew);
  if (h_shared && m > 0) e += (2 * m + 6) * 2 * nl;
  return e;
}

template <typename T>
struct SegArgs {
  const T *d, *V, *kinv, *mt, *ge, *xb, *q, *lo, *hi, *center, *thresh, *z0,
      *u0, *rho;
  T *x_out, *z_out, *u_out, *stats, *work;
  int Tw, N, K, seg_len, m, collect, last, plain_tail, C, nl, k_shared,
      h_shared, x;
  T relax, safeguard, step_clamp, conv_tol;
};

#define WAIT_CYCLES (1LL << 32)   // a wait this long is a fault: trap

__device__ __forceinline__ unsigned cta_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the same shared-memory offset in block r of the cluster
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(r));
  return out;
}
__device__ __forceinline__ void st_async(unsigned addr, double v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
      :: "r"(addr), "l"(__double_as_longlong(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
// this block's arrival on its slot mbarrier, expecting `bytes` of stores
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_CYCLES) __trap();
  }
}

// An exchange slot ([C, x] in every block: row r holds block r's
// partials), its shared-memory address, and the mbarrier that counts the
// bytes stored into it with the parity of its current phase.
template <typename T>
struct Xch {
  const T* rows;
  unsigned slot, bar, parity;
};

// Store v as this block's entry i of the exchange in every block of the
// cluster (st.async: the receiver's mbarrier counts the bytes).
template <typename T>
__device__ __forceinline__ void push(const Xch<T>& xs, int x, int rank, int i,
                                     T v, int C) {
  const unsigned a = xs.slot + (unsigned)((rank * x + i) * sizeof(T));
  for (int r = 0; r < C; ++r) st_async(peer_addr(a, r), v, peer_addr(xs.bar, r));
}

// Entry i of a slot over the C blocks, combined in block-rank order (a
// NaN-propagating max if mx, else a sum); loads eight rows at a time.
template <typename T>
__device__ __forceinline__ T rank_total(const T* slot, int x, int i, int C,
                                        bool mx) {
  T a = slot[i];
  for (int r0 = 0; r0 < C; r0 += 8) {
    T v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = r0 + r < C ? slot[(r0 + r) * x + i] : T(0);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r0 + r > 0 && r0 + r < C) a = mx ? pmax(a, v[r]) : a + v[r];
  }
  return a;
}

// Cluster-wide reduction of nv <= NV values, value i a NaN-propagating max
// if bit i of is_max is set, else a sum: in warp order within a block, then
// in block-rank order; every thread of every block computes the same
// totals from its own copy of the slot. One block barrier, then a wait on
// the slot's mbarrier.
template <typename T, int NV>
__device__ __forceinline__ void cluster_reduce(const Xch<T>& xs, T (&v)[NV],
                                               int nv, unsigned is_max,
                                               T* s_red, int x, int rank,
                                               int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) bar_expect(xs.bar, (unsigned)(C * nv * sizeof(T)));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i >= nv) break;
    const bool mx = (is_max >> i) & 1u;
    T y = v[i];
    for (int o = 16; o > 0; o >>= 1) {
      const T w = __shfl_down_sync(FULL_MASK, y, o);
      y = mx ? pmax(y, w) : y + w;
    }
    if (lane == 0) s_red[i * SEG_WARPS + warp] = y;
  }
  __syncthreads();
  if (threadIdx.x < nv) {
    const int i = threadIdx.x;
    const bool mx = (is_max >> i) & 1u;
    T acc = s_red[i * SEG_WARPS];
    for (int w = 1; w < SEG_WARPS; ++w)
      acc = mx ? pmax(acc, s_red[i * SEG_WARPS + w]) : acc + s_red[i * SEG_WARPS + w];
    push(xs, x, rank, i, acc, C);
  }
  bar_wait(xs.bar, xs.parity);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < nv) v[i] = rank_total(xs.rows, x, i, C, (is_max >> i) & 1u);
}

// index of Gram entry (r, s), r <= s, in the packed upper triangle
__device__ __forceinline__ int gram_index(int r, int s, int m) {
  return r * m - r * (r - 1) / 2 + (s - r);
}

template <typename T, bool AA, bool VS>
__global__ void __launch_bounds__(SEG_THREADS)
admm_cluster_kernel(const SegArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = a.C, nl = a.nl, Tw = a.Tw, N = a.N, K = a.K, m = a.m;
  const int x = a.x;
  const int rank = (int)cl.block_rank();
  const int p = blockIdx.x / C;                 // this cluster's lane
  const int j0 = rank * nl;
  const int nlr = N - j0 < 0 ? 0 : (N - j0 < nl ? N - j0 : nl);  // my coords
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  unsigned long long* s_bar = reinterpret_cast<unsigned long long*>(smem_raw);
  T* s_rd = reinterpret_cast<T*>(smem_raw + MBAR_BYTES);   // [nl]
  T* s_t = s_rd + nl;                           // [Tw]
  T* s_t2 = s_t + Tw;                           // [x]: t2, then the Gram
  T* s_red = s_t2 + x;                          // [RED_MAX, SEG_WARPS]
  T* s_xch = s_red + RED_MAX * SEG_WARPS;       // [2, C, x] exchange slots
  T* s_gamma = s_xch + 2 * C * x;               // [AA_MMAX]
  const int ew = sizeof(T) / 4;
  const int ks = row_stride(Tw, ew), vss = row_stride(nl, ew);
  T* s_kT = s_gamma + AA_MMAX;                  // [Tw, ks] if k_shared
  T* s_V = s_kT + (a.k_shared ? Tw * ks : 0);   // [Tw, vss] if VS
  T* s_H = s_V + (VS ? Tw * vss : 0);           // [2m + 6, 2 nl] if h_shared

  // this block's slice of its lane
  const size_t vo = (size_t)p * N + j0;
  const T* d = a.d + vo;
  const T* xb = a.xb + vo;
  const T* q = a.q + vo;
  const T* lo = a.lo + vo;
  const T* hi = a.hi + vo;
  const T* center = a.center + vo;
  const T* thresh = a.thresh + vo;
  const T* mt = a.mt + (size_t)p * K * N + j0;
  const T* ge = a.ge + (size_t)p * K * N + j0;
  const T* Vg = a.V + (size_t)p * Tw * N + j0;
  const T* kinv = a.kinv + (size_t)p * Tw * Tw;
  const T rho = __ldg(a.rho + p);
  const T relax = a.relax;

  // kinv element (l, k) at kp[k * kk + l * kl]: transposed in shared
  // memory, as given in device memory
  const T* kp = kinv;
  int kk = 1, kl = Tw;
  if (a.k_shared) {
    for (int i = tid; i < Tw * Tw; i += SEG_THREADS)
      s_kT[(i % Tw) * ks + i / Tw] = __ldg(kinv + i);
    kp = s_kT;
    kk = ks;
    kl = 1;
  }
  if (VS && nlr > 0)
    for (int i = tid; i < Tw * nlr; i += SEG_THREADS) {
      const int k = i / nlr, jl = i - k * nlr;
      s_V[k * vss + jl] = __ldg(Vg + (size_t)k * N + jl);
    }
  const T* Vr = VS ? s_V : Vg;   // row k of the slice at Vr + k * vs
  const int vs = VS ? vss : N;
  auto vld = [&](size_t i) -> T { return VS ? Vr[i] : __ldg(Vr + i); };

  // Anderson rows of this block's slice: S[m], Y[m], then VP, GP, VG, VF,
  // G, CAND, each 2 nl; element jl + half * nl is coordinate jl's z (half
  // 0) or u (half 1)
  const int n2 = 2 * nl;
  T *S = nullptr, *Y = nullptr, *VP = nullptr, *GP = nullptr, *VG = nullptr,
    *VF = nullptr, *G = nullptr, *CAND = nullptr;
  if (AA) {
    S = a.h_shared ? s_H
                   : a.work + ((size_t)p * C + rank) * (size_t)(2 * m + 6) * n2;
    Y = S + (size_t)m * n2;
    VP = Y + (size_t)m * n2;
    GP = VP + n2;
    VG = GP + n2;
    VF = VG + n2;
    G = VF + n2;
    CAND = G + n2;
  }

  T z[SEG_COLS], u[SEG_COLS];
#pragma unroll
  for (int c = 0; c < SEG_COLS; ++c) {
    const int jl = tid + c * SEG_THREADS;
    z[c] = jl < nlr ? __ldg(a.z0 + vo + jl) : T(0);
    u[c] = jl < nlr ? __ldg(a.u0 + vo + jl) : T(0);
    if (a.seg_len == 0 && jl < nlr) a.x_out[vo + jl] = z[c];  // x starts at z
    if (AA && jl < nlr) {
      for (int r = 0; r < m; ++r) {
        S[(size_t)r * n2 + jl] = S[(size_t)r * n2 + nl + jl] = T(0);
        Y[(size_t)r * n2 + jl] = Y[(size_t)r * n2 + nl + jl] = T(0);
      }
      VP[jl] = VP[nl + jl] = GP[jl] = GP[nl + jl] = T(0);
      VG[jl] = z[c];
      VG[nl + jl] = u[c];
    }
  }
  T dz = T(0), acc = T(0), rej = T(0), conv = T(0);
  T r_best = T(INFINITY);
  // exchange n uses slot n & 1 and its mbarrier in phase (n >> 1) & 1
  int hist = 0, head = 0, xc = 0;
  auto next_xch = [&]() -> Xch<T> {
    const int sl = xc & 1;
    Xch<T> xs{s_xch + sl * C * x, cta_addr(s_xch + sl * C * x),
              cta_addr(s_bar + sl), (unsigned)((xc >> 1) & 1)};
    ++xc;
    return xs;
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(cta_addr(s_bar + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();   // every block runs, its mbarriers set, before any stores

  const int grp = tid / ROW_GROUP, sub = tid % ROW_GROUP;
  const int n_grp = SEG_THREADS / ROW_GROUP;
  PHASE_START
  for (int it = 0; it < a.seg_len; ++it) {
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int jl = tid + c * SEG_THREADS;
      if (jl < nlr) s_rd[jl] = (rho * (z[c] - u[c]) - __ldg(q + jl)) / __ldg(d + jl);
    }
    __syncthreads();
    PHASE(1);

    // t = V rd: this block's partial of each row, ROW_GROUP lanes a row
    // (four interleaved sums each), pushed to every block
    Xch<T> xs = next_xch();
    if (tid == 0) bar_expect(xs.bar, (unsigned)(C * Tw * sizeof(T)));
    for (int k0 = 0; k0 < Tw; k0 += n_grp) {
      const int k = k0 + grp;
      T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
      if (k < Tw) {
        const size_t row = (size_t)k * vs;
        int jl = sub;
        for (; jl + 3 * ROW_GROUP < nlr; jl += 4 * ROW_GROUP) {
          a0 += vld(row + jl) * s_rd[jl];
          a1 += vld(row + jl + ROW_GROUP) * s_rd[jl + ROW_GROUP];
          a2 += vld(row + jl + 2 * ROW_GROUP) * s_rd[jl + 2 * ROW_GROUP];
          a3 += vld(row + jl + 3 * ROW_GROUP) * s_rd[jl + 3 * ROW_GROUP];
        }
        for (; jl < nlr; jl += ROW_GROUP) a0 += vld(row + jl) * s_rd[jl];
      }
      T acc_k = (a0 + a1) + (a2 + a3);
      for (int o = ROW_GROUP / 2; o > 0; o >>= 1)
        acc_k += __shfl_xor_sync(FULL_MASK, acc_k, o);
      if (sub == 0 && k < Tw) push(xs, x, rank, k, acc_k, C);
    }
    PHASE(2);
    if (tid < Tw) bar_wait(xs.bar, xs.parity);
    PHASE(3);
    for (int k = tid; k < Tw; k += SEG_THREADS)
      s_t[k] = rank_total(xs.rows, x, k, C, false);
    __syncthreads();
    PHASE(4);

    // t2 = t kinv, ROW_GROUP lanes an output (two interleaved sums each)
    for (int k0 = 0; k0 < Tw; k0 += n_grp) {
      const int k = k0 + grp;
      T a0 = T(0), a1 = T(0);
      if (k < Tw) {
        const T* kc = kp + (size_t)k * kk;
        int l = sub;
        for (; l + ROW_GROUP < Tw; l += 2 * ROW_GROUP) {
          a0 += s_t[l] * kc[(size_t)l * kl];
          a1 += s_t[l + ROW_GROUP] * kc[(size_t)(l + ROW_GROUP) * kl];
        }
        if (l < Tw) a0 += s_t[l] * kc[(size_t)l * kl];
      }
      T acc_k = a0 + a1;
      for (int o = ROW_GROUP / 2; o > 0; o >>= 1)
        acc_k += __shfl_xor_sync(FULL_MASK, acc_k, o);
      if (sub == 0 && k < Tw) s_t2[k] = acc_k;
    }
    __syncthreads();
    PHASE(5);

    // xt = rd - (t2 V) / d (four interleaved sums), and the partial sums of
    // e = ge xt
    T xt[SEG_COLS];
    T e[SEG_KMAX];
#pragma unroll
    for (int k = 0; k < SEG_KMAX; ++k) e[k] = T(0);
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int jl = tid + c * SEG_THREADS;
      xt[c] = T(0);
      if (jl < nlr) {
        T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
        int k = 0;
        for (; k + 4 <= Tw; k += 4) {
          a0 += s_t2[k] * vld((size_t)k * vs + jl);
          a1 += s_t2[k + 1] * vld((size_t)(k + 1) * vs + jl);
          a2 += s_t2[k + 2] * vld((size_t)(k + 2) * vs + jl);
          a3 += s_t2[k + 3] * vld((size_t)(k + 3) * vs + jl);
        }
        for (; k < Tw; ++k) a0 += s_t2[k] * vld((size_t)k * vs + jl);
        xt[c] = s_rd[jl] - ((a0 + a1) + (a2 + a3)) / __ldg(d + jl);
#pragma unroll
        for (int k2 = 0; k2 < SEG_KMAX; ++k2)
          if (k2 < K) e[k2] += xt[c] * __ldg(ge + (size_t)k2 * N + jl);
      }
    }
    PHASE(6);
    cluster_reduce<T, SEG_KMAX>(next_xch(), e, K, 0u, s_red, x, rank, C);
    PHASE(7);

    // equality correction, relaxation, prox, dual update
    const bool last_it = it == a.seg_len - 1;
    T dzl = T(0), xzl = T(0), r2 = T(0);
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int jl = tid + c * SEG_THREADS;
      if (jl < nlr) {
        T corr = T(0);
#pragma unroll
        for (int k = 0; k < SEG_KMAX; ++k)
          if (k < K) corr += e[k] * __ldg(mt + (size_t)k * N + jl);
        const T xv = xt[c] - corr + __ldg(xb + jl);
        const T xr = relax * xv + (T(1) - relax) * z[c];
        const T w = xr + u[c];
        const T cj = __ldg(center + jl);
        const T zs = w - cj;
        T zn = cj + psign(zs) * pmax(fabs(zs) - __ldg(thresh + jl), T(0));
        zn = pmin(pmax(zn, __ldg(lo + jl)), __ldg(hi + jl));
        const T un = w - zn;
        if (last_it) a.x_out[vo + jl] = xv;
        dzl = pmax(dzl, T(fabs(zn - z[c])));
        xzl = pmax(xzl, T(fabs(xv - zn)));
        if (AA) {
          const T gz = zn - z[c], gu = un - u[c];
          r2 += gz * gz + gu * gu;
          VF[jl] = zn;
          VF[nl + jl] = un;
          G[jl] = gz;
          G[nl + jl] = gu;
        } else {
          u[c] = un;
          z[c] = zn;
        }
      }
    }

    PHASE(8);
    if (!AA) {
      if (a.collect || last_it) {
        T v[2] = {dzl, xzl};
        cluster_reduce<T, 2>(next_xch(), v, 2, 3u, s_red, x, rank, C);
        dz = v[0];
        const T r_c = pmax(v[1], rho * dz);
        if (a.collect && conv == T(0) && r_c <= a.conv_tol) conv = T(it + 1);
      }
      continue;
    }

    // ---- Anderson: residual, safeguard, history push
    T v3[3] = {dzl, xzl, r2};
    cluster_reduce<T, 3>(next_xch(), v3, 3, 3u, s_red, x, rank, C);
    PHASE(9);
    dz = v3[0];
    const T r_c = pmax(v3[1], rho * dz);
    if (a.collect && conv == T(0) && r_c <= a.conv_tol) conv = T(it + 1);
    const T r = sqrt(v3[2]);
    const bool grew = it > 0 && r > a.safeguard * r_best;
    const bool improve = r <= r_best;
    r_best = pmin(r_best, r);
    if (grew) {
      rej += T(1);
      hist = 0;
    }
    const bool push_h = it > 0 && !grew;
    if (push_h) {
      head = (head + m - 1) % m;          // newest row first
      hist = hist + 1 < m ? hist + 1 : m;
    }
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int jl = tid + c * SEG_THREADS;
      if (jl < nlr) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = jl + half * nl;
          const T vh = half ? u[c] : z[c];
          const T gh = G[h];
          if (improve) VG[h] = VF[h];
          if (push_h) {
            S[(size_t)head * n2 + h] = vh - VP[h];
            Y[(size_t)head * n2 + h] = gh - GP[h];
          }
          VP[h] = vh;
          GP[h] = gh;
        }
      }
    }
    __syncthreads();
    PHASE(10);

    // this block's part of the masked Gram of Y and of Y g: warp w takes
    // entries w, w + SEG_WARPS, ... (GRAM_BATCH of them in each pass over
    // the slice), logical row r at physical slot (head + r) % m
    const int n_gram = m * (m + 1) / 2;
    xs = next_xch();
    if (tid == 0) bar_expect(xs.bar, (unsigned)(C * (n_gram + m) * sizeof(T)));
    for (int base = warp; base < n_gram + m; base += GRAM_BATCH * SEG_WARPS) {
      int yr[GRAM_BATCH], ys[GRAM_BATCH];   // row offsets; ys < 0: G
      T mr[GRAM_BATCH], ms[GRAM_BATCH], acc_e[GRAM_BATCH];
#pragma unroll
      for (int q = 0; q < GRAM_BATCH; ++q) {
        const int ent = base + q * SEG_WARPS;
        int r0 = 0, s2 = -1;
        if (ent < n_gram) {
          int e2 = ent;
          while (e2 >= m - r0) {
            e2 -= m - r0;
            ++r0;
          }
          s2 = r0 + e2;
        } else if (ent < n_gram + m) {
          r0 = ent - n_gram;
        }
        mr[q] = ent < n_gram + m && r0 < hist ? T(1) : T(0);
        ms[q] = s2 >= 0 && s2 < hist ? T(1) : T(0);
        yr[q] = ((head + r0) % m) * n2;
        ys[q] = s2 >= 0 ? ((head + s2) % m) * n2 : -1;
        acc_e[q] = T(0);
      }
      for (int i = lane; i < 2 * nlr; i += 32) {
        const int h = i < nlr ? i : nl + i - nlr;
#pragma unroll
        for (int q = 0; q < GRAM_BATCH; ++q) {
          if (ys[q] >= 0)
            acc_e[q] += (Y[yr[q] + h] * mr[q]) * (Y[ys[q] + h] * ms[q]);
          else
            acc_e[q] += (Y[yr[q] + h] * mr[q]) * G[h];
        }
      }
#pragma unroll
      for (int q = 0; q < GRAM_BATCH; ++q) {
        const int ent = base + q * SEG_WARPS;
        if (ent < n_gram + m) {   // the same in the whole warp
          for (int o = 16; o > 0; o >>= 1)
            acc_e[q] += __shfl_down_sync(FULL_MASK, acc_e[q], o);
          if (lane == 0) push(xs, x, rank, ent, acc_e[q], C);
        }
      }
    }
    PHASE(11);
    if (tid < n_gram + m) bar_wait(xs.bar, xs.parity);
    PHASE(12);
    for (int i = tid; i < n_gram + m; i += SEG_THREADS)
      s_t2[i] = rank_total(xs.rows, x, i, C, false);   // t2 is read until xt
    __syncthreads();

    // gamma: (Ym Ym' + diag(1 - mask) + ridge I) gamma = Ym g, by the
    // pivot-free Gauss-Jordan of ops/_linalg.py::spd_solve on one warp:
    // lane c < m holds column c of the augmented matrix, lane m the
    // right-hand side; pivot rows pass by shuffles
    const T* gram = s_t2;
    if (warp == 0) {
      T trace = T(0);
      for (int r = 0; r < m; ++r) trace += gram[gram_index(r, r, m)];
      const T ridge = T(1e-8) * trace / T(hist > 1 ? hist : 1) + Eps<T>::tiny();
      T col[AA_MMAX];
#pragma unroll
      for (int r = 0; r < AA_MMAX; ++r) {
        col[r] = T(0);
        if (r < m) {
          int src = 0;
          if (lane < m)
            src = lane >= r ? gram_index(r, lane, m) : gram_index(lane, r, m);
          else if (lane == m)
            src = n_gram + r;
          T v = gram[src];
          if (lane == r) v = v + (r < hist ? T(0) : T(1)) + ridge;
          col[r] = v;
        }
      }
#pragma unroll
      for (int k = 0; k < AA_MMAX; ++k) {
        if (k < m) {
          const T piv = __shfl_sync(FULL_MASK, col[k], k);
          col[k] = col[k] / piv;
#pragma unroll
          for (int r = 0; r < AA_MMAX; ++r) {
            if (r < m && r != k) {
              const T fac = __shfl_sync(FULL_MASK, col[r], k);
              col[r] = col[r] - fac * col[k];
            }
          }
        }
      }
      if (lane == m) {
#pragma unroll
        for (int r = 0; r < AA_MMAX; ++r)
          if (r < m) s_gamma[r] = col[r];
      }
    }
    __syncthreads();
    PHASE(13);

    // candidate, its step length and finiteness
    T v2[2] = {T(0), T(0)};   // step^2, non-finite count
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int jl = tid + c * SEG_THREADS;
      if (jl < nlr) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = jl + half * nl;
          T mix = T(0);
          for (int r = 0; r < m; ++r) {
            const size_t row = (size_t)((head + r) % m) * n2 + h;
            mix += s_gamma[r] * ((S[row] + Y[row]) * (r < hist ? T(1) : T(0)));
          }
          const T vf = VF[h];
          const T cand = vf - mix;
          const T step = cand - vf;
          v2[0] += step * step;
          if (!isfinite(cand)) v2[1] += T(1);
          CAND[h] = cand;
        }
      }
    }
    PHASE(14);
    cluster_reduce<T, 2>(next_xch(), v2, 2, 0u, s_red, x, rank, C);
    PHASE(15);
    bool use = hist > 0 && !grew && r <= r_best && r_c > a.conv_tol &&
               sqrt(v2[0]) <= a.step_clamp * r && v2[1] == T(0);
    if (a.last && it >= a.seg_len - a.plain_tail) use = false;
    if (use) acc += T(1);
#pragma unroll
    for (int c = 0; c < SEG_COLS; ++c) {
      const int jl = tid + c * SEG_THREADS;
      if (jl < nlr) {
        const T* src = grew ? VG : (use ? CAND : VF);
        z[c] = src[jl];
        u[c] = src[nl + jl];
      }
    }
  }

  PHASE_END
  if (rank == 0 && tid == 0) {
    T* st = a.stats + (size_t)p * 4;
    st[0] = dz;
    st[1] = acc;
    st[2] = rej;
    st[3] = conv;
  }
#pragma unroll
  for (int c = 0; c < SEG_COLS; ++c) {
    const int jl = tid + c * SEG_THREADS;
    if (jl < nlr) {
      a.z_out[vo + jl] = z[c];
      a.u_out[vo + jl] = u[c];
    }
  }
  cl.sync();   // no block leaves while stores into it may be in flight
}

template <typename T, bool AA, bool VS>
static int launch_one(const SegArgs<T>& args, int B, int smem, void* stream) {
  auto kern = admm_cluster_kernel<T, AA, VS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * args.C));
  cfg.blockDim = dim3(SEG_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)args.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be resident is refused, not run some other way;
  // the answer is kept for the last configuration asked about
  static int last_c = -1, last_smem = -1, last_ok = 0;
  if (args.C != last_c || smem != last_smem) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    last_c = args.C;
    last_smem = smem;
    last_ok = clusters > 0;
  }
  if (!last_ok) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* d, const T* V, const T* kinv, const T* mt,
                  const T* ge, const T* xb, const T* q, const T* lo,
                  const T* hi, const T* center, const T* thresh, const T* z0,
                  const T* u0, const T* rho, T* x_out, T* z_out, T* u_out,
                  T* stats, T* work, int B, int Tw, int N, int K, int seg_len,
                  double relax, int m, int collect, int last,
                  double safeguard, double step_clamp, int plain_tail,
                  double conv_tol, int C, int k_shared, int v_shared,
                  int h_shared, void* stream) {
  if (B <= 0) return 0;
  if (m > AA_MMAX || m < 0 || K > SEG_KMAX || K < 0 || C < 1 || C > 8 ||
      N < 1 || Tw < 1)
    return (int)cudaErrorInvalidValue;
  const int nl = (N + C - 1) / C;
  if (nl > SEG_THREADS * SEG_COLS) return (int)cudaErrorInvalidValue;
  if (m > 0 && !h_shared && work == nullptr) return (int)cudaErrorInvalidValue;
  const long smem = MBAR_BYTES + (long)sizeof(T) *
                                     smem_elems(Tw, nl, m, C, sizeof(T) / 4,
                                                k_shared, v_shared, h_shared);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  SegArgs<T> args{d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z0, u0,
                  rho, x_out, z_out, u_out, stats, work, Tw, N, K, seg_len,
                  m, collect, last, plain_tail, C, nl, k_shared, h_shared,
                  Tw > XCH_MIN ? Tw : XCH_MIN, (T)relax, (T)safeguard,
                  (T)step_clamp, (T)conv_tol};
  if (m > 0)
    return v_shared ? launch_one<T, true, true>(args, B, (int)smem, stream)
                    : launch_one<T, true, false>(args, B, (int)smem, stream);
  return v_shared ? launch_one<T, false, true>(args, B, (int)smem, stream)
                  : launch_one<T, false, false>(args, B, (int)smem, stream);
}

#define FM_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* d, const T* V, const T* kinv, const T* mt,   \
                      const T* ge, const T* xb, const T* q, const T* lo,    \
                      const T* hi, const T* center, const T* thresh,        \
                      const T* z0, const T* u0, const T* rho, T* x_out,     \
                      T* z_out, T* u_out, T* stats, T* work, int B, int Tw, \
                      int N, int K, int seg_len, double relax, int m,       \
                      int collect, int last, double safeguard,              \
                      double step_clamp, int plain_tail, double conv_tol,   \
                      int cluster, int k_shared, int v_shared,              \
                      int h_shared, void* stream) {                         \
    return launch<T>(d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z0, \
                     u0, rho, x_out, z_out, u_out, stats, work, B, Tw, N, K, \
                     seg_len, relax, m, collect, last, safeguard,           \
                     step_clamp, plain_tail, conv_tol, cluster, k_shared,   \
                     v_shared, h_shared, stream);                           \
  }

FM_ENTRY(fm_admm_segment_f32, float)
FM_ENTRY(fm_admm_segment_f64, double)

// Shared-memory bytes of one block for element size elt (4 or 8).
extern "C" int fm_admm_segment_smem(int elt, int Tw, int N, int m,
                                    int cluster, int k_shared, int v_shared,
                                    int h_shared) {
  const int nl = (N + cluster - 1) / cluster;
  return MBAR_BYTES + elt * smem_elems(Tw, nl, m, cluster, elt / 4, k_shared,
                                       v_shared, h_shared);
}

#ifdef FM_SEG_PHASES
// The cluster barrier alone: each block of clusters of C runs reps
// cluster.sync() calls (segment_phases.py times it).
__global__ void __launch_bounds__(SEG_THREADS) cluster_barrier_kernel(int reps) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < reps; ++i) cl.sync();
}

extern "C" int fm_cluster_barrier(int clusters, int C, int reps,
                                  void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C));
  cfg.blockDim = dim3(SEG_THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, reps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The phase cycles summed since the last read, into out[N_PHASES]; resets.
extern "C" int fm_segment_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, fm_phase_cycles, sizeof(fm_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[N_PHASES] = {};
  return (int)cudaMemcpyToSymbol(fm_phase_cycles, zero, sizeof(zero));
}
#endif
