"""The port's research step end to end against the JAX package, and the
port's boundaries.

- The whole step at the ``__graft_entry__.entry()`` size (F=8, D=48, N=24,
  window 8, lookback 8) on the CPU in float64, for ``solver_kernel``
  ``"reference"`` and ``"fused"`` (the JAX fused path runs the Pallas kernel
  through its interpreter, as on any non-TPU backend): ``mvo_turnover``,
  plain ``mvo``, and ``mvo_turnover`` with the risk model and Anderson.
- ``convert`` carries the QP options and a lane batch's warm state.
- No module of the port and no line of ``chip_smoke.py`` imports JAX or the
  JAX package; the package imports with neither in ``sys.modules``.
- Entry points run on the card unless asked for the CPU; ``chip_smoke.py``
  fails, printing no result, without a card or without the package.
- On the card (marker ``cuda``): the step launches both kernels; plain
  ``mvo`` launches one segment per lane batch.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu.parallel import build_research_step as jax_build
from tests.torch_threads import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "factormodeling_tpu_torch"

_PREFIXES = ("alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta")
_SUFFIXES = ("_eq", "_flx", "_long", "_short")


def _names(f):
    return tuple(f"{_PREFIXES[i % 8]}{i // 8}{_SUFFIXES[i % 4]}"
                 for i in range(f))


def _inputs(f, d, n, seed=0):
    """The ``__graft_entry__`` recipe, in float64."""
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(f, d, n))
    factors[rng.uniform(size=factors.shape) < 0.03] = np.nan
    returns = rng.normal(scale=0.02, size=(d, n))
    factor_ret = rng.normal(scale=0.01, size=(d, f))
    cap = rng.integers(1, 4, size=(d, n)).astype(float)
    invest = np.ones((d, n))
    universe = np.ones((d, n), dtype=bool)
    return factors, returns, factor_ret, cap, invest, universe


_SIM = {
    "mvo_turnover": dict(method="mvo_turnover", lookback_period=8,
                         qp_iters=40),
    "mvo": dict(method="mvo", lookback_period=8, mvo_batch=16),
    # the risk model and the Anderson accelerator on the headline scheme,
    # at a budget where the accelerated path is stable (see
    # test_torch_backtest.py)
    "turnover_risk_anderson": dict(method="mvo_turnover",
                                   covariance="risk_model", risk_factors=3,
                                   risk_lookback=12, risk_refit_every=6,
                                   qp_anderson=5, qp_iters=60),
}


@pytest.mark.parametrize("kernel", ["reference", "fused"])
@pytest.mark.parametrize("scheme", list(_SIM))
def test_research_step_matches_jax(scheme, kernel):
    f, d, n = 8, 48, 24
    arrays = _inputs(f, d, n)
    config = dict(names=_names(f), window=8, select_method="icir_top",
                  blend_method="zscore",
                  sim_kwargs=dict(_SIM[scheme], max_weight=0.4,
                                  solver_kernel=kernel))
    want = jax.jit(jax_build(**config))(*(jnp.asarray(a) for a in arrays))
    inputs, cfg = fmt.convert(*arrays, **config, device="cpu")
    got = fmt.build_research_step(**cfg.as_kwargs())(*inputs)

    assert np.asarray(want.selection).sum() > 0
    # selection and signal: the same float64 sums, reassociated
    np.testing.assert_allclose(got.selection.numpy(), np.asarray(want.selection),
                               atol=1e-10, rtol=0)
    np.testing.assert_allclose(got.signal.numpy(), np.asarray(want.signal),
                               atol=1e-10, rtol=0, equal_nan=True)
    # weights: the 1e-6 pin of the solver's two kernels
    np.testing.assert_allclose(got.sim.weights.numpy(),
                               np.asarray(want.sim.weights), atol=1e-6,
                               rtol=0, equal_nan=True)
    for field in got.summary._fields:
        np.testing.assert_allclose(float(getattr(got.summary, field)),
                                   float(getattr(want.summary, field)),
                                   atol=1e-8, rtol=0, err_msg=field)


def test_convert_keeps_dtypes_and_config():
    arrays = _inputs(4, 10, 6)
    inputs, cfg = fmt.convert(*arrays, names=_names(4), window=3,
                              sim_kwargs={"method": "equal"}, device="cpu",
                              dtype=torch.float32)
    assert [t.dtype for t in inputs] == [torch.float32] * 5 + [torch.bool]
    assert all(t.device.type == "cpu" for t in inputs)
    assert cfg.as_kwargs() == dict(names=_names(4), window=3,
                                   select_method="icir_top", select_kwargs={},
                                   blend_method="zscore",
                                   sim_kwargs={"method": "equal"},
                                   device="cpu")
    out = fmt.build_research_step(**cfg.as_kwargs())(*inputs)
    assert out.signal.dtype == torch.float32


def test_convert_carries_the_qp_options_and_warm_lanes():
    """The risk-model, Anderson and lane-batch knobs cross unchanged and a
    lane batch's warm state carries over: the JAX package's exit state,
    carried into the port, warm-starts the same next solve."""
    from factormodeling_tpu.solvers import (ADMMWarmState as JaxWarm,
                                            BoxQPProblem as JaxProblem,
                                            admm_solve_lowrank as jax_solve)
    from factormodeling_tpu_torch.solvers import (BoxQPProblem,
                                                  admm_solve_lowrank)

    sim = dict(method="mvo", covariance="risk_model", risk_factors=5,
               risk_lookback=30, risk_refit_every=7, qp_anderson=5,
               mvo_batch=4, solver_kernel="fused")
    _, cfg = fmt.convert(*_inputs(2, 5, 4), names=_names(2), window=3,
                         sim_kwargs=sim, device="cpu")
    assert cfg.sim_kwargs == sim
    with pytest.raises(ValueError, match="Unknown covariance"):
        fmt.convert(*_inputs(2, 5, 4), names=_names(2), window=3,
                    sim_kwargs={"covariance": "x"}, device="cpu")

    rng = np.random.default_rng(7)
    lanes, t, n = 3, 6, 12
    V = rng.normal(scale=0.02, size=(lanes, t, n))
    s = np.full((lanes, t), 0.2)
    alpha = np.full(lanes, 1e-4)
    sig = rng.normal(size=(lanes, n))
    lo = np.where(sig < 0, -0.4, 0.0)
    hi = np.where(sig > 0, 0.4, 0.0)
    E = np.stack([sig > 0, sig < 0], axis=1).astype(float)
    b = np.tile([1.0, -1.0], (lanes, 1))
    arrays = dict(q=np.zeros((lanes, n)), lo=lo, hi=hi, E=E, b=b,
                  l1=np.full(lanes, 0.05), center=np.zeros((lanes, n)))

    def jax_solve_lanes(warm):
        def one(a, v, s_, q, lo, hi, E, b, l1, c, wz, wu, wr):
            return jax_solve(a, v, s_, JaxProblem(q, lo, hi, E, b, l1, c),
                             warm_start=JaxWarm(wz, wu, wr), iters=30)
        return jax.vmap(one)(jnp.asarray(alpha), jnp.asarray(V),
                             jnp.asarray(s), *(jnp.asarray(arrays[k]) for k in
                                               ("q", "lo", "hi", "E", "b",
                                                "l1", "center")),
                             *(jnp.asarray(w) for w in warm))

    cold = (np.zeros((lanes, n)), np.zeros((lanes, n)), np.full(lanes, np.nan))
    first = jax_solve_lanes(cold)
    want = jax_solve_lanes((first.z, first.u, first.rho))
    carried = fmt.convert_warm_state(first.z, first.u, first.rho,
                                     device="cpu")
    assert carried.z.shape == (lanes, n) and carried.rho.shape == (lanes,)
    got = admm_solve_lowrank(
        torch.from_numpy(alpha), torch.from_numpy(V), torch.from_numpy(s),
        BoxQPProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
        iters=30, warm_start=carried)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho),
                               atol=1e-6, rtol=0)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fmt.build_research_step(names=_names(2), window=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fmt.convert(*_inputs(2, 5, 4), names=_names(2), window=3)
    with pytest.raises(ValueError, match="Unknown method"):
        fmt.build_research_step(names=_names(2), window=3, device="cpu",
                                sim_kwargs={"method": "nope"})


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "factormodeling_tpu"), (
                path, mod)
    code = ("import sys, pkgutil, importlib, factormodeling_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'factormodeling_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def _smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    proc = _smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.cuda
def test_research_step_on_card_launches_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    arrays = _inputs(8, 48, 24)
    inputs, cfg = fmt.convert(*arrays, names=_names(8), window=8,
                              sim_kwargs=dict(method="mvo_turnover",
                                              lookback_period=8, qp_iters=40,
                                              max_weight=0.4,
                                              solver_kernel="fused"),
                              dtype=torch.float32)
    rk.launches = ak.launches = 0
    out = fmt.build_research_step(**cfg.as_kwargs())(*inputs)
    assert rk.launches == 1 and ak.launches == 48 * 2
    assert torch.isfinite(out.summary.sharpe)


@pytest.mark.cuda
def test_plain_mvo_on_card_launches_one_segment_per_lane_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    arrays = _inputs(8, 48, 24)
    inputs, cfg = fmt.convert(*arrays, names=_names(8), window=8,
                              sim_kwargs=dict(_SIM["mvo"], max_weight=0.4,
                                              solver_kernel="fused"))
    ak.launches = 0
    out = fmt.build_research_step(**cfg.as_kwargs())(*inputs)
    # 48 dates in lanes of 16: 3 solves of 200 iterations, 8 segments each
    assert ak.launches == 3 * 8
    assert int(out.sim.diagnostics.qp_solves) == 48
    assert torch.isfinite(out.summary.sharpe)
