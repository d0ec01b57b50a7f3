"""The port's ADMM solver and its segment kernel against the JAX package, on
the CPU in float64 with seeded numpy inputs.

- The plain segment against the Pallas ``admm_segment`` run by its
  interpreter (``anderson=0, collect=False, interpret=True``) on the same
  operands, built as the JAX solver builds them per rho.
- ``admm_solve_lowrank`` with ``kernel="reference"`` and ``"fused"``
  against the JAX solver with the same kernel, cold and warm-started.
- On the card (marker ``cuda``): the CUDA kernel against its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.ops._pallas_admm import admm_segment as jax_segment
from factormodeling_tpu.solvers import (ADMMWarmState as JaxWarm,
                                        BoxQPProblem as JaxProblem,
                                        admm_solve_lowrank as jax_solve)
from factormodeling_tpu_torch.ops import _cuda_admm as ak
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
        _, z, u, _ = ak.admm_segment_plain(*ops, relax=1.7, seg_len=warm_iters)
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
