"""The port's pandas selector surface against the JAX package's compat
layer, on the CPU in float64 on the same DataFrames: the metric table and
``FactorSelector.prepare_selection`` by a dense method and by a custom
plugin registered in the registry (the per-date loop), compared on index,
columns, sort order and values (1e-10: the same float64 arithmetic in
orders that differ by reassociation). On the card (marker ``cuda``) the
same calls with the default device.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from factormodeling_tpu.compat import factor_selection_methods as jax_fsm
from factormodeling_tpu.compat import factor_selector as jax_fs
from factormodeling_tpu_torch.compat import factor_selection_methods as fsm
from factormodeling_tpu_torch.compat import factor_selector as fs
from factormodeling_tpu_torch.compat._convert import (PanelVocab,
                                                      level_values, roundtrip)
from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_x64 import torch_float64_module  # noqa: F401

TOL = 1e-10


def _frames(seed=0, d=30, n=12, f=5):
    rng = np.random.default_rng(seed)
    dates = pd.date_range("2021-01-04", periods=d, freq="B")
    syms = [f"S{i:02d}" for i in range(n)]
    idx = pd.MultiIndex.from_product([dates, syms], names=["date", "symbol"])
    keep = rng.uniform(size=len(idx)) > 0.08          # a ragged universe
    idx = idx[keep]
    ret = pd.Series(rng.normal(scale=0.02, size=len(idx)), index=idx)
    fac = pd.DataFrame(rng.normal(size=(len(idx), f)), index=idx,
                       columns=[f"f{i}" for i in range(f)])
    fac.iloc[:, 0] += 3.0 * ret.groupby(level="symbol").shift(-2).fillna(0)
    fac = fac.mask(rng.uniform(size=fac.shape) < 0.05)
    fr = pd.DataFrame(rng.normal(scale=0.01, size=(d, f)) + 0.002,
                      index=dates, columns=fac.columns)
    return fac, ret, fr


def _same_frame(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    assert got.index.name == want.index.name
    assert got.columns.name == want.columns.name
    np.testing.assert_allclose(got.to_numpy(dtype=float),
                               want.to_numpy(dtype=float), atol=TOL,
                               rtol=TOL, equal_nan=True)


def test_single_factor_metrics_matches_jax_compat():
    fac, ret, _ = _frames()
    got = fs.single_factor_metrics(fac, ret, device="cpu")
    want = jax_fs.single_factor_metrics(fac, ret)
    _same_frame(got, want)
    assert got["rank_IC_IR"].is_monotonic_decreasing


@pytest.mark.parametrize("method,kw", [
    ("icir_top", {"icir_threshold": -1.0, "top_x": 2}),
    ("mvo", {"qp_iters": 80}),
    ("regression", {}),
])
def test_factor_selector_dense_methods_match_jax_compat(method, kw):
    fac, ret, fr = _frames(1)
    sel = fs.FactorSelector(fac, ret, fr, 8, method, kw, device="cpu")
    got = sel.prepare_selection()
    want = jax_fs.FactorSelector(fac, ret, fr, 8, method,
                                 kw).prepare_selection()
    _same_frame(got, want)
    assert got.to_numpy().sum() > 0
    assert sel.prepare_selection() is got                 # cached


def _custom(metrics_df, factors_win, returns_win, factor_ret_win, today,
            window, **kwargs):
    """A custom plugin: weights by the positive part of rank-IC."""
    w = metrics_df["rank_IC"].clip(lower=0.0).fillna(0.0)
    return w.rename(today)


def test_factor_selector_custom_plugin_matches_jax_compat(monkeypatch):
    monkeypatch.setitem(fs.FACTOR_SELECTION_METHODS, "custom_ric", _custom)
    monkeypatch.setitem(jax_fs.FACTOR_SELECTION_METHODS, "custom_ric",
                        _custom)
    fac, ret, fr = _frames(2, d=16)
    got = fs.FactorSelector(fac, ret, fr, 6, "custom_ric",
                            device="cpu").prepare_selection()
    want = jax_fs.FactorSelector(fac, ret, fr, 6,
                                 "custom_ric").prepare_selection()
    _same_frame(got, want)
    assert got.shape == (16 - 6 - 1, 5) and got.to_numpy().sum() > 0
    with pytest.raises(ValueError, match="Unknown"):
        fs.FactorSelector(fac, ret, fr, 6, "nope",
                          device="cpu").prepare_selection()


@pytest.mark.parametrize("name", ["mvo_selector", "pca_selector",
                                  "regression_selector"])
def test_covariance_plugins_match_jax_compat(name):
    _, _, fr = _frames(3)
    win = fr.iloc[:12]
    args = (None, None, None, win, fr.index[12], list(fr.index[:12]))
    kw = {"qp_iters": 80} if name == "mvo_selector" else {}
    got = getattr(fsm, name)(*args, device="cpu", **kw)
    want = getattr(jax_fsm, name)(*args, **kw)
    assert got.name == want.name and list(got.index) == list(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), atol=TOL)
    np.testing.assert_allclose(
        fsm.ledoit_wolf_shrinkage(win, device="cpu").to_numpy(),
        jax_fsm.ledoit_wolf_shrinkage(win).to_numpy(), atol=TOL)


def test_panel_vocab_roundtrip_and_level_contract():
    fac, ret, _ = _frames(4)
    vocab = PanelVocab.from_indexes(fac.index, ret.index)
    values, universe = vocab.densify(ret)
    assert values.dtype == np.float64 and universe.sum() == len(ret)
    back = roundtrip(ret, lambda v, u: torch.where(u, 2.0 * v, v),
                     device="cpu")
    pd.testing.assert_series_equal(back, 2.0 * ret)
    shuffled = ret.sample(frac=1.0, random_state=0)
    pd.testing.assert_series_equal(vocab.align_like(values, shuffled.index),
                                   shuffled.rename(None))
    with pytest.raises(TypeError, match="MultiIndex"):
        level_values(pd.Index([1, 2]), "date", 0)
    swapped = ret.index.set_names(["symbol", "date"])
    assert (level_values(swapped, "date", 0)
            == ret.index.get_level_values(1)).all()
    with pytest.raises(KeyError, match="not found"):
        level_values(ret.index.set_names(["day", "ticker"]), "date", 0)


def test_compat_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error; a card is present")
    fac, ret, fr = _frames(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fs.single_factor_metrics(fac, ret)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fs.FactorSelector(fac, ret, fr, 8, "icir_top")


@pytest.mark.cuda
def test_compat_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    fac, ret, fr = _frames(6)
    _same_frame(fs.single_factor_metrics(fac, ret),
                fs.single_factor_metrics(fac, ret, device="cpu"))
    for method, kw in (("icir_top", {"icir_threshold": -1.0}),
                       ("mvo", {"qp_iters": 80}), ("pca", {})):
        _same_frame(fs.FactorSelector(fac, ret, fr, 8, method,
                                      kw).prepare_selection(),
                    fs.FactorSelector(fac, ret, fr, 8, method, kw,
                                      device="cpu").prepare_selection())
