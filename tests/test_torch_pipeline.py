"""The port's research step end to end against the JAX package, and the
port's boundaries.

- The whole step at the ``__graft_entry__.entry()`` size (F=8, D=48, N=24,
  window 8, lookback 8, qp_iters=40) on the CPU in float64, for
  ``solver_kernel`` ``"reference"`` and ``"fused"`` (the JAX fused path runs
  the Pallas kernel through its interpreter, as on any non-TPU backend).
- No module of the port and no line of ``chip_smoke.py`` imports JAX or the
  JAX package; the package imports with neither in ``sys.modules``.
- Entry points run on the card unless asked for the CPU; ``chip_smoke.py``
  fails, printing no result, without a card or without the package.
- On the card (marker ``cuda``): the step launches both kernels.
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


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_research_step_matches_jax(kernel):
    f, d, n = 8, 48, 24
    arrays = _inputs(f, d, n)
    config = dict(names=_names(f), window=8, select_method="icir_top",
                  blend_method="zscore",
                  sim_kwargs=dict(method="mvo_turnover", lookback_period=8,
                                  qp_iters=40, max_weight=0.4,
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
