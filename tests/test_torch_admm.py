"""The port's ADMM solver and its segment kernel against the JAX package, on
the CPU in float64 with seeded numpy inputs.

- ``spd_solve`` and ``aa_mix`` against the JAX functions.
- The plain segment against the Pallas ``admm_segment`` run by its
  interpreter (``interpret=True``) on the same operands, built as the JAX
  solver builds them per rho: plain, and with the Anderson accelerator and
  the conv tally; the lane form against single-lane calls.
- ``admm_solve_lowrank`` with ``kernel="reference"`` and ``"fused"``
  against the JAX solver with the same kernel: cold and warm-started, with
  a vector alpha, with Anderson, and as a lane batch against ``jax.vmap``.
- On the card (marker ``cuda``): the CUDA kernel against its plain version.

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


def _problem(seed, t=12, n=40, max_weight=0.2, l1=0.1):
    """A turnover day as the backtest builds it: centered return window,
    shrunk low-rank covariance, sign boxes, leg equalities, L1 around
    yesterday's weights."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 1000, 4096])
@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-5),    # reassociation over 25 dependent iterations
    ("float64", 1e-12),   # the same, at float64 rounding
])
def test_segment_kernel_matches_plain_on_card(n, dtype, tol):
    """A ragged width, the path's width, and the widest the kernel takes
    (past 48 KB of dynamic shared memory in float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    p = _problem(5, t=60, n=n, max_weight=max(0.03, 4.0 / n))
    prob, t = _torch_prob({k: (np.asarray(v, dtype) if k != "l1" else v)
                           for k, v in p.items()})
    prob = BoxQPProblem(**{k: (v.cuda() if torch.is_tensor(v) else v)
                           for k, v in vars(prob).items()})
    ops = first_segment_inputs(float(p["alpha"]), t["V"].cuda(),
                               t["s"].cuda(), prob)
    before = ak.launches
    got = ak.admm_segment(*ops, relax=1.7, seg_len=25)
    assert ak.launches == before + 1
    assert got[0].dtype == getattr(torch, dtype)
    want = ak.admm_segment_plain(*ops, relax=1.7, seg_len=25)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-4),    # reassociated sums over 25 dependent iterations,
                          # amplified by the Anderson extrapolation
    ("float64", 1e-10),
])
def test_anderson_lane_kernel_matches_plain_on_card(dtype, tol):
    """Three lanes at the path's width, depth 5, the conv tally and the
    plain tail, against the plain version on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    ops = [o.to(getattr(torch, dtype)).cuda()
           for o in _lane_ops((5, 6, 7), t=60, n=1000, max_weight=0.03)]
    kw = dict(relax=1.7, seg_len=20, last=True, anderson=5, collect=True)
    before = ak.launches
    got = ak.admm_segment(*ops, **kw)
    assert ak.launches == before + 1
    want = ak.admm_segment_plain(*ops, **kw)
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    if dtype == "float64":
        for a, b in zip(got[4:], want[4:]):
            assert torch.equal(a, b)
    assert int(got[4].sum()) > 0       # the accelerator engaged


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
