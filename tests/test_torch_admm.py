"""The port's ADMM solver and its segment kernel against the JAX package, on
the CPU in float64 with seeded numpy inputs.

- ``spd_solve`` and ``aa_mix`` against the JAX functions.
- The plain segment against the Pallas ``admm_segment`` run by its
  interpreter (``interpret=True``) on the same operands, built as the JAX
  solver builds them per rho: plain, and with the Anderson accelerator and
  the conv tally; the lane form against single-lane calls.
- The CUDA kernel's cross-block order of sums (C slices of the asset axis,
  partials added in rank order) emulated for C = 1-8 against the same
  Pallas kernel, and the kernel's cluster plan over every shape the
  earlier one-block kernel took; on days whose accelerated path is
  chaotic, the serial order's parting from the plain version (why the
  card's Anderson gates leave those days out).
- ``admm_solve_lowrank`` with ``kernel="reference"`` and ``"fused"``
  against the JAX solver with the same kernel: cold and warm-started, with
  a vector alpha, with Anderson, and as a lane batch against ``jax.vmap``.
- On the card (marker ``cuda``): the CUDA kernel against its plain version
  at slice edges, depths 0-8 and T = 20-165; lane launches bitwise against
  single-lane launches.

The Anderson accept/reject chain is discrete: on a turnover day from a cold
start (L1 term on) the extrapolation can amplify a reassociated sum's last
bit until a gate flips — the JAX package's own two kernels part there too
(``tests/test_solver_fuzz.py::check_anderson_instance``,
``aa_path_stable``). The Anderson differentials therefore run where the
accelerated path is stable: the plain-MVO day (no L1 term) for the segment,
and turnover days whose accelerated path both packages follow for the
solver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.obs import probes
from factormodeling_tpu.ops._linalg import aa_mix as jax_aa_mix
from factormodeling_tpu.ops._linalg import spd_solve as jax_spd_solve
from factormodeling_tpu.ops._pallas_admm import admm_segment as jax_segment
from factormodeling_tpu.solvers import (ADMMWarmState as JaxWarm,
                                        BoxQPProblem as JaxProblem,
                                        admm_solve_lowrank as jax_solve)
from factormodeling_tpu_torch.ops import _cuda_admm as ak
from factormodeling_tpu_torch.ops._linalg import aa_mix, spd_solve
from factormodeling_tpu_torch.solvers import (ADMMWarmState, BoxQPProblem,
                                              admm_solve_lowrank)
from factormodeling_tpu_torch.solvers.admm_qp import first_segment_inputs
from tests.torch_threads import torch_one_thread  # noqa: F401


def _problem(seed, t=12, n=40, max_weight=0.2, l1=0.1, k=2):
    """A turnover day as the backtest builds it: centered return window,
    shrunk low-rank covariance, sign boxes, leg equalities, L1 around
    yesterday's weights. ``k`` other than 2 keeps the first ``k`` of the
    leg rows and random rows with zero right-hand sides."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(scale=0.02, size=(t, n))
    c = rows - rows.mean(0, keepdims=True)
    lam = 0.1
    alpha = (1 - lam) * 1e-6 + lam * ((c * c).sum() / (t - 1) / n + 1e-6)
    s = np.full(t, (1 - lam) / (t - 1))
    sig = rng.normal(size=n)
    sig[:3] = 0.0
    pos, neg = sig > 0, sig < 0
    lo = np.where(neg, -max_weight, 0.0)
    hi = np.where(pos, max_weight, 0.0)
    E = np.stack([pos, neg]).astype(float)
    b = np.array([1.0, -1.0])
    center = np.where(rng.uniform(size=n) < 0.5, pos / pos.sum() - neg / neg.sum(), 0.0)
    if k != 2:
        E = np.concatenate([E, rng.normal(size=(max(k - 2, 0), n))])[:k]
        b = np.concatenate([b, np.zeros(max(k - 2, 0))])[:k]
    return dict(alpha=2 * alpha, V=c, s=2 * s, q=np.zeros(n), lo=lo, hi=hi,
                E=E, b=b, l1=l1, center=center)


def _torch_prob(p):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()
         if k not in ("alpha", "l1")}
    return BoxQPProblem(q=t["q"], lo=t["lo"], hi=t["hi"], E=t["E"], b=t["b"],
                        l1=p["l1"], center=t["center"]), t


def _jax_prob(p):
    return JaxProblem(q=jnp.asarray(p["q"]), lo=jnp.asarray(p["lo"]),
                      hi=jnp.asarray(p["hi"]), E=jnp.asarray(p["E"]),
                      b=jnp.asarray(p["b"]), l1=jnp.asarray(p["l1"]),
                      center=jnp.asarray(p["center"]))


@pytest.mark.parametrize("warm_iters", [0, 10])
@pytest.mark.parametrize("seg_len", [25, 15])
def test_plain_segment_matches_pallas_interpret(warm_iters, seg_len):
    p = _problem(0)
    prob, t = _torch_prob(p)
    ops = list(first_segment_inputs(p["alpha"], t["V"], t["s"], prob))
    if warm_iters:   # start from a mid-solve iterate, not the cold zeros
        _, z, u, *_ = ak.admm_segment_plain(*ops, relax=1.7,
                                            seg_len=warm_iters)
        ops[11], ops[12] = z, u
    got = ak.admm_segment(*ops, relax=1.7, seg_len=seg_len)
    (d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z, u, rho) = (
        jnp.asarray(o.numpy()) for o in ops)
    want = jax_segment(d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z,
                       u, rho, relax=1.7, seg_len=seg_len, last=True,
                       anderson=0, collect=False, interpret=True)
    for name, a, b in zip(("x", "z", "u", "dz"), got, want[:4]):
        # f64; the two sides associate the small products differently
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12,
                                   rtol=0, err_msg=name)


def test_segment_wrapper_on_cpu_runs_plain_and_counts_nothing():
    p = _problem(1)
    prob, t = _torch_prob(p)
    ops = first_segment_inputs(p["alpha"], t["V"], t["s"], prob)
    before = ak.launches
    got = ak.admm_segment(*ops, relax=1.7, seg_len=5)
    want = ak.admm_segment_plain(*ops, relax=1.7, seg_len=5)
    assert ak.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["reference", "fused"])
@pytest.mark.parametrize("warm", [False, True])
def test_admm_solve_lowrank_matches_jax(kernel, warm):
    p = _problem(2)
    prob, t = _torch_prob(p)
    kw = dict(rho=2.0, iters=40, kernel=kernel)
    warm_t = warm_j = None
    if warm:
        rng = np.random.default_rng(3)
        z0 = rng.normal(scale=0.05, size=p["q"].shape)
        u0 = rng.normal(scale=0.01, size=p["q"].shape)
        warm_t = ADMMWarmState(torch.from_numpy(z0), torch.from_numpy(u0),
                               torch.tensor(7.5, dtype=torch.float64))
        warm_j = JaxWarm(jnp.asarray(z0), jnp.asarray(u0), jnp.asarray(7.5))
    got = admm_solve_lowrank(torch.tensor(p["alpha"]), t["V"], t["s"], prob,
                             warm_start=warm_t, **kw)
    want = jax_solve(jnp.asarray(p["alpha"]), jnp.asarray(p["V"]),
                     jnp.asarray(p["s"]), _jax_prob(p), warm_start=warm_j, **kw)
    for name in ("x", "z", "u", "rho", "primal_residual",
                 "polish_pre_residual", "polish_post_residual"):
        # the 1e-6 pin the JAX package holds its own two kernels to
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert bool(got.polished) == bool(want.polished)


def test_solver_without_polish_and_with_zero_iterations_matches_jax():
    p = _problem(4, l1=0.0)
    prob, t = _torch_prob(p)
    for iters, polish in ((0, True), (30, False)):
        got = admm_solve_lowrank(p["alpha"], t["V"], t["s"], prob,
                                 iters=iters, polish=polish, kernel="fused")
        want = jax_solve(jnp.asarray(p["alpha"]), jnp.asarray(p["V"]),
                         jnp.asarray(p["s"]), _jax_prob(p), iters=iters,
                         polish=polish, kernel="fused")
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho),
                                   atol=1e-6, rtol=0)


def test_spd_solve_matches_jax():
    rng = np.random.default_rng(10)
    a = rng.normal(size=(7, 5, 5))
    a = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(5)
    b = rng.normal(size=(7, 5))
    np.testing.assert_allclose(
        spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_spd_solve(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-12, rtol=0)


@pytest.mark.parametrize("hist_len", [0, 1, 3, 5])
@pytest.mark.parametrize("deficient", [False, True])
def test_aa_mix_matches_jax(hist_len, deficient):
    """Full and rank-deficient histories: a stalled iterate (a zero residual
    difference, which the ridge decouples) and a repeated iterate step."""
    rng = np.random.default_rng(11)
    m, n = 5, 30
    s_h, y_h = rng.normal(size=(m, n)), rng.normal(size=(m, n))
    v_f, g = rng.normal(size=n), rng.normal(size=n)
    if deficient:
        y_h[1] = 0.0
        s_h[2] = s_h[0]
    got = aa_mix(*(torch.from_numpy(a) for a in (v_f, g, s_h, y_h)), hist_len)
    want = jax_aa_mix(*(jnp.asarray(a) for a in (v_f, g, s_h, y_h)), hist_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=0)
    if hist_len == 0:
        assert torch.equal(got, torch.from_numpy(v_f))


def _vector_alpha(p, seed):
    rng = np.random.default_rng(seed)
    return p["alpha"] * (0.5 + rng.uniform(size=p["q"].shape))


@pytest.mark.parametrize("vector_d", [False, True])
@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("m", [1, 5])
def test_anderson_segment_matches_pallas_interpret(m, last, vector_d):
    """The plain-MVO day (no L1 term): iterates within 1e-10, tallies and
    conv equal; ``vector_d`` is the risk model's per-asset diagonal."""
    p = _problem(0, l1=0.0)
    prob, t = _torch_prob(p)
    alpha = torch.from_numpy(_vector_alpha(p, 9)) if vector_d else p["alpha"]
    ops = first_segment_inputs(alpha, t["V"], t["s"], prob)
    kw = dict(relax=1.7, seg_len=25, last=last, anderson=m, collect=True)
    got = ak.admm_segment(*ops, **kw)
    want = jax_segment(*(jnp.asarray(o.numpy()) for o in ops), **kw,
                       interpret=True)
    for name, a, b in zip(("x", "z", "u", "dz"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10,
                                   rtol=0, err_msg=name)
    assert [int(a) for a in got[4:]] == [int(b) for b in want[4:]]
    assert int(got[4]) > 0 and int(got[6]) > 0   # it accelerated, converged


@pytest.mark.parametrize("anderson", [0, 5])
def test_lane_segment_matches_single_lanes_bitwise(anderson):
    ops = _lane_ops((0, 1, 2))
    kw = dict(relax=1.7, seg_len=25, anderson=anderson, collect=True)
    lanes = ak.admm_segment(*ops, **kw)
    for i in range(3):
        one = ak.admm_segment(*(o[i] for o in ops), **kw)
        for a, b in zip(lanes, one):
            assert torch.equal(a[i], b)


def _cluster_segment(ops, c, *, relax, seg_len, last=True, anderson=0,
                     collect=False):
    """One lane's segment in the CUDA kernel's order of cross-block sums:
    the asset axis cut into ``c`` contiguous slices of ceil(N / c), every
    sum over assets (V rd, ge xt, the residuals, the Anderson Gram and
    right-hand sides, the step length) taken per slice and the partials
    added in slice order; the m x m system by the kernel's pivot-free
    Gauss-Jordan. Returns what :func:`ak.admm_segment_plain` returns."""
    (d, V, kinv, mt, ge, xb, q, lo, hi, center, thresh, z, u, rho) = ops
    n = z.shape[-1]
    nl = -(-n // c)
    cuts = [slice(r * nl, min(n, (r + 1) * nl)) for r in range(c)]
    zero = torch.zeros((), dtype=z.dtype)

    def csum(f):
        tot = f(cuts[0])
        for s in cuts[1:]:
            tot = tot + f(s)
        return tot

    def cmax(v):   # NaN-propagating, each slice from 0 as the kernel's
        tot = torch.cat([zero[None], v[cuts[0]]]).amax()
        for s in cuts[1:]:
            tot = torch.maximum(tot, torch.cat([zero[None], v[s]]).amax())
        return tot

    def both(f):   # a sum over v = [z, u]: the slice's z part, then its u
        return lambda s: f(s, 0) + f(s, 1)

    m = int(anderson)
    x, dz = z, zero
    acc = rej = conv = 0
    hist, r_best = 0, torch.tensor(float("inf"), dtype=z.dtype)
    s_h, y_h = [], []            # newest first
    vp = gp = torch.zeros(2 * n, dtype=z.dtype)
    vg = torch.cat([z, u])
    for it in range(int(seg_len)):
        rd = (rho * (z - u) - q) / d
        t2 = csum(lambda s: V[:, s] @ rd[s]) @ kinv
        xt = rd - (t2 @ V) / d
        e = csum(lambda s: ge[:, s] @ xt[s])
        x = xt - e @ mt + xb
        w = relax * x + (1.0 - relax) * z + u
        zs = w - center
        zn = torch.clamp(center + torch.sign(zs)
                         * torch.clamp(zs.abs() - thresh, min=0.0), lo, hi)
        un = w - zn
        dz = cmax((zn - z).abs())
        r_c = torch.maximum(cmax((x - zn).abs()), rho * dz)
        if collect and conv == 0 and bool(r_c <= ak._CONV_TOL):
            conv = it + 1
        if not m:
            z, u = zn, un
            continue
        v, v_f = torch.cat([z, u]), torch.cat([zn, un])
        g = v_f - v
        halves = (lambda s, h: s if h == 0 else slice(s.start + n, s.stop + n))
        r = torch.sqrt(csum(both(lambda s, h: (g[halves(s, h)] ** 2).sum())))
        grew = it > 0 and bool(r > ak._AA_SAFEGUARD * r_best)
        if bool(r <= r_best):
            vg = v_f
        r_best = torch.minimum(r_best, r)
        if grew:
            rej += 1
            hist = 0
        if it > 0 and not grew:
            s_h = [v - vp] + s_h[:m - 1]
            y_h = [g - gp] + y_h[:m - 1]
            hist = min(hist + 1, m)
        vp, gp = v, g
        ys = [y * float(i < hist) for i, y in enumerate(y_h)]
        ys += [torch.zeros(2 * n, dtype=z.dtype)] * (m - len(ys))
        gram = [[csum(both(lambda s, h: (ys[i][halves(s, h)]
                                         * ys[j][halves(s, h)]).sum()))
                 for j in range(m)] for i in range(m)]
        rhs = [csum(both(lambda s, h: (ys[i][halves(s, h)]
                                       * g[halves(s, h)]).sum()))
               for i in range(m)]
        trace = zero
        for i in range(m):
            trace = trace + gram[i][i]
        ridge = 1e-8 * trace / max(hist, 1) + torch.finfo(z.dtype).tiny
        aug = [[gram[i][j] + ((0.0 if i < hist else 1.0) + ridge
                              if i == j else 0.0) for j in range(m)]
               + [rhs[i]] for i in range(m)]
        for k in range(m):
            piv = aug[k][k]
            aug[k] = [a / piv for a in aug[k]]
            for i in range(m):
                if i != k:
                    fac = aug[i][k]
                    aug[i] = [a - fac * b for a, b in zip(aug[i], aug[k])]
        mix = torch.zeros(2 * n, dtype=z.dtype)
        for i in range(min(m, len(s_h))):
            mix = mix + aug[i][m] * ((s_h[i] + y_h[i]) * float(i < hist))
        cand = v_f - mix
        st = cand - v_f
        step = torch.sqrt(csum(both(lambda s, h: (st[halves(s, h)] ** 2).sum())))
        use = (hist > 0 and not grew and bool(r <= r_best)
               and bool(r_c > ak._CONV_TOL)
               and bool(step <= ak._AA_STEP_CLAMP * r)
               and bool(torch.isfinite(cand).all())
               and not (last and it >= seg_len - ak._AA_PLAIN_TAIL))
        acc += use
        nxt = vg if grew else (cand if use else v_f)
        z, u = nxt[:n], nxt[n:]
    i32 = lambda v: torch.tensor(int(v), dtype=torch.int32)   # noqa: E731
    return x, z, u, dz, i32(acc), i32(rej), i32(conv)


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("anderson", [0, 5])
def test_cluster_summation_order_matches_pallas_interpret(c, anderson):
    """The kernel's cross-block order of sums (C slices of a ragged asset
    axis, partials added in rank order), emulated on the CPU, against the
    Pallas kernel at the card's gates: 1e-12 plain, 1e-10 with Anderson and
    tallies equal. Reassociation by the cluster must not trip a gate."""
    p = _problem(0, n=37, l1=0.0)
    prob, t = _torch_prob(p)
    ops = first_segment_inputs(p["alpha"], t["V"], t["s"], prob)
    kw = dict(relax=1.7, seg_len=25, last=True, anderson=anderson,
              collect=True)
    got = _cluster_segment(ops, c, **kw)
    want = jax_segment(*(jnp.asarray(o.numpy()) for o in ops), **kw,
                       interpret=True)
    tol = 1e-10 if anderson else 1e-12
    for name, a, b in zip(("x", "z", "u", "dz"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=0, err_msg=name)
    assert [int(a) for a in got[4:]] == [int(b) for b in want[4:]]
    assert int(got[6]) > 0 and (int(got[4]) > 0 or not anderson)


# (T, N) at the edges of what the one-block kernel of earlier versions took:
# its shared memory held kinv, rd and t, t2 (size (T^2 + N + 2T) within
# 227 KB less 4 KB of fixed buffers)
def _one_block_max_t(n, size):
    t = 1
    while size * ((t + 1) ** 2 + n + 2 * (t + 1)) <= 227 * 1024 - 4096:
        t += 1
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_plan_takes_every_shape_the_one_block_kernel_took(dtype):
    size = torch.finfo(dtype).bits // 8
    for n in (1, 5, 7, 37, 1000, 1001, 2048, 4096):
        for t in (1, 8, 20, 60, 150, _one_block_max_t(n, size)):
            for k in range(1, 5):
                for m in range(0, ak.MAX_ANDERSON + 1):
                    plan = ak.cluster_plan(t, n, k, m, dtype)
                    assert plan.cluster == ak.CLUSTER > 1
                    assert plan.cols * plan.cluster >= n
                    assert plan.smem_bytes <= ak._SMEM_LIMIT
    with pytest.raises(ValueError, match="N <="):
        ak.cluster_plan(8, ak.MAX_N + 1, 2, 0, dtype)
    with pytest.raises(ValueError, match="anderson <="):
        ak.cluster_plan(8, 100, 2, ak.MAX_ANDERSON + 1, dtype)


def test_cluster_plan_depends_on_shape_not_lanes(monkeypatch):
    """The plan's inputs are T, N, K, m and the dtype (no lane count), and
    at the backtest's shape a lane is a cluster of C > 1 blocks with V and
    the Anderson history in shared memory."""
    import inspect

    assert list(inspect.signature(ak.cluster_plan).parameters) == [
        "t", "n", "k", "m", "dtype"]
    for m in (0, 5):
        plan = ak.cluster_plan(60, 1000, 2, m, torch.float64)
        assert plan.cluster > 1 and plan.v_shared
        assert plan.history_shared == bool(m)
        assert plan.kinv_shared
    # past the shared memory: T = 60, N = 4096 in float64 reads V from
    # device memory, a wide T also the history, the widest kinv too
    assert not ak.cluster_plan(60, 4096, 2, 5, torch.float64).v_shared
    wide = ak.cluster_plan(150, 4096, 2, 8, torch.float64)
    assert wide.kinv_shared and not (wide.v_shared or wide.history_shared)
    assert not ak.cluster_plan(167, 1, 2, 0, torch.float64).kinv_shared
    # the kernel takes the portable cluster sizes only
    monkeypatch.setattr(ak, "CLUSTER", 16)
    with pytest.raises(ValueError, match="cluster of 16"):
        ak.cluster_plan(60, 1000, 2, 0, torch.float64)


_SOLVER_CASES = [dict(vector=True, anderson=0), dict(vector=False, anderson=5),
                 dict(vector=True, anderson=5)]


@pytest.mark.parametrize("kernel", ["reference", "fused"])
@pytest.mark.parametrize("case", _SOLVER_CASES,
                         ids=["vector_alpha", "anderson", "vector_anderson"])
def test_admm_solve_lowrank_options_match_jax(kernel, case):
    p = _problem(3)
    prob, t = _torch_prob(p)
    alpha = _vector_alpha(p, 3) if case["vector"] else np.asarray(p["alpha"])
    kw = dict(iters=40, anderson=case["anderson"], kernel=kernel)
    got = admm_solve_lowrank(torch.from_numpy(alpha), t["V"], t["s"], prob,
                             **kw)
    want = jax_solve(jnp.asarray(alpha), jnp.asarray(p["V"]),
                     jnp.asarray(p["s"]), _jax_prob(p), **kw)
    for name in ("x", "z", "u", "rho", "primal_residual"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in ("polished", "aa_accepted", "aa_rejected"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    assert int(got.aa_accepted) > 0 or not case["anderson"]
    assert got.iters_to_converge is None


@pytest.mark.parametrize("kernel", ["reference", "fused"])
@pytest.mark.parametrize("anderson", [0, 5])
def test_lane_batch_solve_matches_jax_vmap(kernel, anderson):
    """Four lanes (three turnover days and a plain-MVO day), each with its
    own warm state, against ``jax.vmap`` of the JAX solver."""
    lanes = [_problem(2), _problem(3), _problem(7), _problem(5, l1=0.0)]
    st = {k: np.stack([np.asarray(p[k], float) for p in lanes])
          for k in lanes[0]}
    kw = dict(iters=40, anderson=anderson, kernel=kernel)
    prob = BoxQPProblem(**{k: torch.from_numpy(st[k]) for k in
                           ("q", "lo", "hi", "E", "b", "l1", "center")})
    # warm states as a day loop carries them: a previous solve's exit, and
    # one lane cold (NaN rho)
    prev = admm_solve_lowrank(torch.from_numpy(st["alpha"]),
                              torch.from_numpy(st["V"]),
                              torch.from_numpy(st["s"]), prob, iters=25)
    warm = tuple(a.numpy().copy() for a in prev.warm_state)
    warm[2][1] = np.nan
    got = admm_solve_lowrank(torch.from_numpy(st["alpha"]),
                             torch.from_numpy(st["V"]),
                             torch.from_numpy(st["s"]), prob,
                             warm_start=ADMMWarmState(
                                 *(torch.from_numpy(w) for w in warm)),
                             collect=True, **kw)

    def one(alpha, V, s, q, lo, hi, E, b, l1, center, wz, wu, wr):
        return jax_solve(alpha, V, s, JaxProblem(q, lo, hi, E, b, l1, center),
                         warm_start=JaxWarm(wz, wu, wr), **kw)

    # the JAX solver tallies the conv read only under its probes layer
    with probes.probing():
        want = jax.vmap(one)(*(jnp.asarray(st[k]) for k in
                               ("alpha", "V", "s", "q", "lo", "hi", "E", "b",
                                "l1", "center")),
                             *(jnp.asarray(w) for w in warm))
    for name in ("x", "z", "u", "rho", "primal_residual"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in ("polished", "aa_accepted", "aa_rejected",
                 "iters_to_converge"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.iters_to_converge > 0).any()


# (T, N, K) on the card: N < C (some blocks own no coordinate), ragged
# slices, the path's shape (V's slice in shared memory), N = 4096 (V read
# from device memory), T = 165 (kinv read from device memory in float64),
# the risk model's T = 20, and K from 1 to 4
_CARD_SHAPES = [(60, 7, 2), (60, 37, 2), (20, 1001, 2), (60, 1000, 1),
                (60, 1000, 2), (60, 1000, 3), (60, 1000, 4), (60, 4096, 2),
                (20, 4096, 4), (165, 37, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,k", _CARD_SHAPES,
                         ids=[f"T{t}-N{n}-K{k}" for t, n, k in _CARD_SHAPES])
@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-5),    # reassociation over 25 dependent iterations
    ("float64", 1e-12),   # the same, at float64 rounding
])
def test_segment_kernel_matches_plain_on_card(t, n, k, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    p = _problem(5, t=t, n=n, max_weight=max(0.03, 4.0 / n), k=k)
    prob, tt = _torch_prob({key: (np.asarray(v, dtype) if key != "l1" else v)
                            for key, v in p.items()})
    prob = BoxQPProblem(**{key: (v.cuda() if torch.is_tensor(v) else v)
                           for key, v in vars(prob).items()})
    ops = first_segment_inputs(float(p["alpha"]), tt["V"].cuda(),
                               tt["s"].cuda(), prob)
    before = ak.launches
    got = ak.admm_segment(*ops, relax=1.7, seg_len=25)
    assert ak.launches == before + 1
    assert got[0].dtype == getattr(torch, dtype)
    want = ak.admm_segment_plain(*ops, relax=1.7, seg_len=25)
    assert all(bool(torch.isfinite(w).all()) for w in want[:4])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    zero = ak.admm_segment(*ops, relax=1.7, seg_len=0)   # x starts at z
    torch.testing.assert_close(zero[0], ops[11], atol=0, rtol=0)


@pytest.mark.cuda
def test_segment_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    p = _problem(6, t=8, n=ak.MAX_N + 1)
    prob, t = _torch_prob(p)
    ops = [o.cuda() for o in first_segment_inputs(p["alpha"], t["V"], t["s"],
                                                  prob)]
    with pytest.raises(ValueError, match="N <="):
        ak.admm_segment(*ops, relax=1.7, seg_len=5)
    with pytest.raises(TypeError):
        ak.admm_segment(*[o.float() for o in ops[:-1]], ops[-1], relax=1.7,
                        seg_len=5)


def _lane_ops(seeds, anderson_safe=True, **kw):
    """Segment operands of several problems stacked on a lane axis."""
    stacks = []
    for seed in seeds:
        p = _problem(seed, l1=0.0 if anderson_safe else 0.1, **kw)
        prob, t = _torch_prob(p)
        stacks.append(first_segment_inputs(p["alpha"], t["V"], t["s"], prob))
    return [torch.stack(col) for col in zip(*stacks)]


#: N = 7 plain-MVO days whose accelerated path converges within the segment
_N7_CONVERGING = (8, 15, 17)
# days on which the accelerated path is chaotic: plain-MVO days at N = 7
# that do not converge within the segment, and turnover days (L1 on) at
# path 3's T = 20
_CHAOTIC = [dict(seed=seed, t=60, n=7, l1=0.0, m=m) for m in (5, 8)
            for seed in (5, 7)] + [dict(seed=seed, t=20, n=1000, l1=0.1, m=5)
                                   for seed in (2, 4, 5)]


@pytest.mark.parametrize("case", _CHAOTIC, ids=[
    f"T{c['t']}-N{c['n']}-l1{c['l1']}-m{c['m']}-seed{c['seed']}"
    for c in _CHAOTIC])
def test_serial_order_parts_from_plain_on_chaotic_days(case):
    """The witness for the days the Anderson card gates leave out: with the
    kernel's sums emulated in the serial order (C = 1, no cross-block sums
    at all) the segment already parts from the plain version beyond the
    card's 1e-10 gate, so no order of sums could hold it there."""
    ops = [o[0] for o in _lane_ops(
        (case["seed"],), anderson_safe=not case["l1"], t=case["t"],
        n=case["n"], max_weight=max(0.03, 4.0 / case["n"]))]
    kw = dict(relax=1.7, seg_len=20, last=True, anderson=case["m"],
              collect=True)
    want = ak.admm_segment_plain(*ops, **kw)
    got = _cluster_segment(ops, 1, **kw)
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], want[:4]))
    assert err > 1e-10
    if case["n"] == 7:
        assert int(want[6]) == 0       # not converged within the segment


@pytest.mark.parametrize("m", [5, 8])
@pytest.mark.parametrize("seed", _N7_CONVERGING)
def test_cluster_order_holds_on_converging_n7_days(seed, m):
    """The N = 7 days the Anderson card test takes: the emulated cluster
    order (C = 1 and 8) within the card's gate of the plain version, tallies
    equal."""
    ops = [o[0] for o in _lane_ops((seed,), t=60, n=7, max_weight=4.0 / 7)]
    kw = dict(relax=1.7, seg_len=20, last=True, anderson=m, collect=True)
    want = ak.admm_segment_plain(*ops, **kw)
    assert int(want[6]) > 0 and int(want[4]) > 0
    for c in (1, 8):
        got = _cluster_segment(ops, c, **kw)
        for a, b in zip(got[:4], want[:4]):
            torch.testing.assert_close(a, b, atol=1e-10, rtol=0)
        assert [int(a) for a in got[4:]] == [int(b) for b in want[4:]]


# (T, N, m) on the card: depths 0 to 8 at the path's shape, the risk
# model's T = 20, N < C, ragged N (N = 37: 8-12 extrapolations a lane, the
# history full at depth 8), N = 4096 (V from device memory, the history in
# shared memory) and T = 150 there (both from device memory)
_AA_CARD_SHAPES = [(60, 1000, 0), (60, 1000, 1), (60, 1000, 2),
                   (60, 1000, 5), (60, 1000, 8), (20, 1000, 5), (60, 7, 5),
                   (60, 7, 8), (60, 37, 8), (20, 37, 8), (60, 1001, 5),
                   (60, 4096, 5), (150, 4096, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,m", _AA_CARD_SHAPES,
                         ids=[f"T{t}-N{n}-m{m}" for t, n, m in _AA_CARD_SHAPES])
@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-4),    # reassociated sums over 25 dependent iterations,
                          # amplified by the Anderson extrapolation
    ("float64", 1e-10),
])
def test_anderson_lane_kernel_matches_plain_on_card(t, n, m, dtype, tol):
    """Three lanes (seeds 5, 6, 7), the conv tally and the plain tail,
    against the plain version on the same card. At N = 7 the lanes are the
    days whose accelerated path converges within the segment (seeds 8, 15,
    17): there seed 6 has no feasible box and the days of seeds 5 and 7
    part from the plain version beyond the gate already when the kernel's
    sums are emulated in the serial order on the CPU
    (``test_serial_order_parts_from_plain_on_chaotic_days``): the
    accept/reject chain's chaos, not the cluster's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    seeds = _N7_CONVERGING if n == 7 else (5, 6, 7)
    ops = [o.to(getattr(torch, dtype)).cuda()
           for o in _lane_ops(seeds, t=t, n=n, max_weight=max(0.03, 4.0 / n))]
    kw = dict(relax=1.7, seg_len=20, last=True, anderson=m, collect=True)
    before = ak.launches
    got = ak.admm_segment(*ops, **kw)
    assert ak.launches == before + 1
    want = ak.admm_segment_plain(*ops, **kw)
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    if dtype == "float64":
        for a, b in zip(got[4:], want[4:]):
            assert torch.equal(a, b)
    if m:
        assert int(got[4].sum()) > 0       # the accelerator engaged


@pytest.mark.cuda
@pytest.mark.parametrize("anderson", [0, 5])
@pytest.mark.parametrize("n", [1000, 4096])
def test_lane_launch_equals_single_lane_launches_bitwise_on_card(anderson, n):
    """A lane's arithmetic does not depend on the lanes sharing its launch:
    eight lanes in one launch equal the same lanes launched alone, bit for
    bit (the cluster size comes from the shape, not the lane count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    ops = [o.cuda() for o in _lane_ops(range(5, 13), t=60, n=n,
                                        max_weight=max(0.03, 4.0 / n))]
    kw = dict(relax=1.7, seg_len=25, anderson=anderson, collect=True)
    lanes = ak.admm_segment(*ops, **kw)
    for i in range(8):
        one = ak.admm_segment(*(o[i] for o in ops), **kw)
        for a, b in zip(lanes, one):
            assert torch.equal(a[i], b)


@pytest.mark.cuda
def test_cluster_plan_bytes_match_the_kernel_and_refusals_raise():
    """The plan's shared-memory bytes are the source's own count, and a
    launch the kernel refuses raises: no other route runs instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    import ctypes

    from factormodeling_tpu_torch import _build

    fn = _build.load("admm_segment").fm_admm_segment_smem
    fn.restype = ctypes.c_int
    for dtype in (torch.float32, torch.float64):
        for t, n, m in ((60, 1000, 5), (20, 7, 0), (60, 4096, 8),
                        (150, 4096, 8), (167, 1, 0)):
            plan = ak.cluster_plan(t, n, 2, m, dtype)
            assert fn(torch.finfo(dtype).bits // 8, t, n, m, plan.cluster,
                      int(plan.kinv_shared), int(plan.v_shared),
                      int(plan.history_shared)) == plan.smem_bytes
    # a plan that claims more shared memory than a block has: the library
    # refuses the launch and the wrapper raises
    ops = [o.cuda() for o in _lane_ops((0, 1), t=150, n=4096,
                                        max_weight=0.03)]
    kept = ak._SMEM_LIMIT
    ak._plan.cache_clear()
    try:
        ak._SMEM_LIMIT = 1 << 30
        with pytest.raises(RuntimeError, match="launch failed"):
            ak.admm_segment(*ops, relax=1.7, seg_len=5, anderson=8)
    finally:
        ak._SMEM_LIMIT = kept
        ak._plan.cache_clear()


@pytest.mark.cuda
def test_segment_kernel_refuses_anderson_beyond_its_depth():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    ops = [o.cuda() for o in _lane_ops((0, 1))]
    with pytest.raises(ValueError, match="anderson <="):
        ak.admm_segment(*ops, relax=1.7, seg_len=5,
                        anderson=ak.MAX_ANDERSON + 1)
    with pytest.raises(ValueError, match="shapes"):
        ak.admm_segment(*ops[:-1], ops[-1][:1], relax=1.7, seg_len=5)


def test_segment_phases_needs_the_card(monkeypatch):
    """The phase profile measures the card: without one it raises before
    building anything."""
    from factormodeling_tpu_torch import segment_phases

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        segment_phases.measure()
    assert set(segment_phases.PHASES) == set(range(1, 16))
