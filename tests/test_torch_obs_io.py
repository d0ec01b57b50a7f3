"""The port's run report, latency sketch, panels, loaders, artifact store and
compat shims against the JAX package's, on the CPU:

- ``RunReport`` rows from the same calls (a compat ``Simulation`` on each
  run path, a manager sweep, a stage and a module-level span), compared by
  kind, name and keys (walls are not compared; the cost rows' FLOPs and
  bytes, the port's tally of its ATen operations against XLA's cost
  analysis, are held finite and positive, not equal);
- the latency sketch's rows bit for bit on the same samples;
- ``Panel``/``FactorPanel`` round trips and the three loaders on the same
  CSVs (float32, bit for bit), the artifact store's round trips, and
  ``fingerprint`` equal to the JAX package's on the same numpy inputs;
- ``compat.install()``/``uninstall()``, beside a bare name bound to the JAX
  compat that ``install()`` leaves alone;
- ``import factormodeling_tpu_torch`` in a child interpreter with pandas
  blocked, as on a machine without it.
"""

import json
import subprocess
import sys
import textwrap
import types

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import factormodeling_tpu.compat as jax_compat
import factormodeling_tpu_torch as fmt
import factormodeling_tpu_torch.compat as port_compat
from factormodeling_tpu import io as jio
from factormodeling_tpu import obs as jobs
from factormodeling_tpu import panel as jpanel
from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.compat import portfolio_simulation as jax_ps
from factormodeling_tpu.obs import latency as jlat
from factormodeling_tpu.parallel import sweep as jsweep
from factormodeling_tpu_torch import io as tio
from factormodeling_tpu_torch import panel as tpanel
from factormodeling_tpu_torch.compat import portfolio_simulation as port_ps
from factormodeling_tpu_torch.obs import latency as tlat
from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_x64 import torch_float64_module  # noqa: F401

D, N, F = 12, 6, 3


def _series(rng, idx, scale=1.0):
    return pd.Series(rng.normal(scale=scale, size=len(idx)), index=idx)


def _market(seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    dates = pd.date_range("2021-06-01", periods=D, freq="B")
    idx = pd.MultiIndex.from_product([dates, [f"S{i}" for i in range(N)]],
                                     names=["date", "symbol"])
    ret = _series(rng, idx, 0.02)
    cap = pd.Series(rng.integers(1, 4, size=len(idx)).astype(float),
                    index=idx)
    inv = pd.Series(1.0, index=idx)
    sig = _series(rng, idx).rename("sig")
    if ragged:
        keep = idx.get_level_values("date") != dates[4]
        sig, inv = sig[keep], inv[keep]
    return ret, cap, inv, sig


def _report_rows(obs, ps, sweep, settings_cls, arrays_to, **dev):
    """The rows one report collects from the same calls."""
    rep = obs.RunReport("parity")
    with rep.activate():
        for ragged in (False, True):
            ret, cap, inv, sig = _market(1, ragged)
            settings = ps.SimulationSettings(
                returns=ret, cap_flag=cap, investability_flag=inv,
                factors_df=None, method="equal", pct=0.3, plot=False,
                output_returns=True, **dev)
            ps.Simulation(f"s{int(ragged)}", sig, settings).run()
        rng = np.random.default_rng(2)
        factors = arrays_to(rng.normal(size=(F, D, N)))
        s = settings_cls(returns=arrays_to(rng.normal(size=(D, N))),
                         cap_flag=arrays_to(np.ones((D, N))),
                         investability_flag=arrays_to(np.ones((D, N))))
        cw = sweep.combo_weight_matrix([[0, 1], [1, 2]], F, **dev)
        sweep.manager_sweep(factors, cw, s, combo_batch=2, **dev)
        obs.record_stage("custom", value=3)
        with obs.span("block", note="x") as sp:
            sp.add(factors)
    return rep.rows


def _shape(row):
    out = {}
    for k, v in row.items():
        out[k] = _shape(v) if isinstance(v, dict) else None
    return out


def test_run_report_rows_match_jax_by_kind_name_and_keys():
    got = _report_rows(fmt.obs, port_ps, fmt.parallel.sweep,
                       fmt.SimulationSettings, torch.from_numpy,
                       device="cpu")
    want = _report_rows(jobs, jax_ps, jsweep, JaxSettings, jnp.asarray)
    assert [(r["kind"], r["name"]) for r in got] == \
        [(r["kind"], r["name"]) for r in want]
    kinds = [r["kind"] for r in got]
    assert kinds.count("span") == 2 and kinds.count("counters") == 2
    assert kinds.count("cost") == 1 and kinds.count("stage") == 2
    for g, w in zip(got, want):
        if g["kind"] == "cost":
            assert set(g) == set(w)
            assert g["flops"] > 0 and g["bytes_accessed"] > 0
            assert np.isfinite(g["flops"]) and np.isfinite(
                g["bytes_accessed"])
            continue
        assert _shape(g) == _shape(w), g["name"]
        if g["kind"] in ("counters", "stage"):
            assert json.dumps(g, sort_keys=True, default=str) == \
                json.dumps(w, sort_keys=True, default=str)
        if g["kind"] == "span":
            assert g["fenced"] == w["fenced"]


def test_report_header_latency_and_jsonl(tmp_path):
    rep = fmt.obs.RunReport("lat", meta={"run": 1}, latency=True,
                            slos=[fmt.obs.SLOSpec("step", 0.5, 10.0)])
    with rep.activate():
        for _ in range(3):
            with fmt.obs.span("step") as sp:
                sp.add(torch.ones(4))
        with pytest.raises(ValueError):
            with fmt.obs.span("bad"):
                raise ValueError("boom")
    spans = [r for r in rep.rows if r["kind"] == "span"]
    assert [r["name"] for r in spans] == ["step", "bad"]   # repeats folded
    assert spans[1]["error"] is True and spans[1]["fenced"] is False
    head = rep.header()
    assert head["kind"] == "meta" and head["torch_version"] == torch.__version__
    assert head["schema_version"] == jobs.report.SCHEMA_VERSION
    assert len(head["code_fingerprint"]) == 16
    lat = rep.latency_rows()
    assert [r["name"] for r in lat] == ["step"] and lat[0]["count"] == 3
    assert lat[0]["slo_violated"] is False
    lines = rep.write_jsonl(tmp_path / "r.jsonl").read_text().splitlines()
    rows = [json.loads(x) for x in lines]
    assert rows[0]["kind"] == "meta" and all(r["label"] == "lat"
                                             for r in rows)
    assert len(rows) == 1 + len(rep.rows) + 1
    if not torch.cuda.is_available():
        assert fmt.obs.live_watermark() is None
        assert "mem_peak_bytes" not in spans[0]


def test_latency_sketch_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    samples = np.concatenate([rng.lognormal(-6, 2, size=500), [0.0, 1e-7,
                                                               5e6]])
    a, b = tlat.QuantileSketch(), jlat.QuantileSketch()
    for s in samples:
        a.add(s)
        b.add(s)
    assert a.to_row() == b.to_row()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)
    half = tlat.QuantileSketch()
    for s in samples[:250]:
        half.add(s)
    rest = tlat.QuantileSketch.from_row(
        jlat.QuantileSketch.from_row(b.to_row()).to_row())
    assert rest.to_row() == a.to_row()
    half.merge(tlat.QuantileSketch())
    rec_t, rec_j = tlat.LatencyRecorder(), jlat.LatencyRecorder()
    for i, s in enumerate(samples[:40]):
        rec_t.observe(f"s{i % 3}", s)
        rec_j.observe(f"s{i % 3}", s)
    slos_t = [tlat.SLOSpec("s1", 0.9, 1e-3), tlat.SLOSpec("s*", 0.5, 1.0)]
    slos_j = [jlat.SLOSpec("s1", 0.9, 1e-3), jlat.SLOSpec("s*", 0.5, 1.0)]
    assert rec_t.rows(slos_t) == rec_j.rows(slos_j)
    with pytest.raises(ValueError):
        a.add(float("nan"))


def _long_frames(seed=4):
    rng = np.random.default_rng(seed)
    dates = pd.date_range("2021-01-04", periods=D, freq="B")
    rows = [{"date": d, "symbol": f"SYM{j}",
             "log_return": rng.normal(scale=0.02),
             "cap_flag": float(rng.integers(1, 4)),
             "investability_flag": 1.0}
            for d in dates for j in range(N) if rng.uniform() > 0.15]
    features = pd.DataFrame(rows)
    factors = features[["date", "symbol"]].copy()
    for i in range(F):
        factors[f"alpha{i}_flx"] = rng.normal(size=len(factors))
    factors.loc[factors.index[::7], "alpha0_flx"] = np.nan
    fr = pd.DataFrame({"date": dates,
                       **{f"alpha{i}_flx": rng.normal(scale=0.005, size=D)
                          for i in range(F)}})
    return features, factors, fr


def _same_panel(got, want):
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.universe.numpy(),
                                  np.asarray(want.universe))
    np.testing.assert_array_equal(got.dates, want.dates)
    np.testing.assert_array_equal(got.symbols, want.symbols)


@pytest.mark.parametrize("ext", [".csv", ".parquet"])
def test_loaders_match_jax(tmp_path, ext):
    features, factors, fr = _long_frames()
    paths = []
    for name, frame in (("features", features), ("factors", factors),
                        ("fr", fr)):
        path = tmp_path / f"{name}{ext}"
        if ext == ".csv":
            frame.to_csv(path, index=False)
        else:
            frame.to_parquet(path)
        paths.append(path)
    md = tio.load_symbol_features(paths[0], device="cpu")
    md_j = jio.load_symbol_features(paths[0])
    for f in ("returns", "cap_flag", "investability_flag"):
        _same_panel(getattr(md, f), getattr(md_j, f))
        assert getattr(md, f).values.dtype == torch.float32
    fp = tio.load_factors(paths[1], device="cpu")
    fp_j = jio.load_factors(paths[1])
    _same_panel(fp, fp_j)
    assert fp.factor_names == fp_j.factor_names
    r = tio.load_factor_returns(paths[2], dtype=torch.float64, device="cpu")
    r_j = jio.load_factor_returns(paths[2], dtype=jnp.float64)
    np.testing.assert_array_equal(r.values.numpy(), np.asarray(r_j.values))
    assert r.factor_names == r_j.factor_names
    pd.testing.assert_frame_equal(r.to_frame(), r_j.to_frame())
    assert tio.fingerprint(md.returns, fp, r) == \
        jio.fingerprint(md_j.returns, fp_j, r_j)


def test_panels_round_trip_like_jax():
    _, factors, _ = _long_frames(5)
    df = factors.set_index(["date", "symbol"])
    fp = tpanel.FactorPanel.from_frame(df, dtype=torch.float64, device="cpu")
    fp_j = jpanel.FactorPanel.from_frame(df, dtype=jnp.float64)
    _same_panel(fp, fp_j)
    pd.testing.assert_frame_equal(fp.to_frame(), fp_j.to_frame())
    one = fp.factor("alpha1_flx")
    pd.testing.assert_series_equal(one.to_series("v"),
                                   fp_j.factor("alpha1_flx").to_series("v"))
    sel = fp.select(["alpha2_flx", "alpha0_flx"])
    assert sel.factor_names == ("alpha2_flx", "alpha0_flx")
    np.testing.assert_array_equal(sel.values[1].numpy(), fp.values[0].numpy())
    p = tpanel.Panel.from_series(df["alpha0_flx"], device="cpu")
    _same_panel(p, jpanel.Panel.from_series(df["alpha0_flx"]))
    back = tpanel.Panel.from_series(p.to_series("alpha0_flx"), device="cpu")
    _same_panel(back, p)
    codes = tpanel.panel_to_long(p)
    codes_j = jpanel.panel_to_long(jpanel.Panel.from_series(df["alpha0_flx"]))
    for a, b in zip(codes, codes_j):
        np.testing.assert_array_equal(a, b)
    q = tpanel.from_long(*codes, n_dates=p.n_dates, n_symbols=p.n_symbols,
                         device="cpu")
    np.testing.assert_array_equal(q.universe.numpy(), p.universe.numpy())
    dense = tpanel.Panel.dense(np.ones((3, 2)), device="cpu")
    assert dense.shape == (3, 2) and bool(dense.universe.all())
    with pytest.raises(ValueError, match="negative"):
        tpanel.from_long([-1], [0], [1.0], device="cpu")
    with pytest.raises(TypeError, match="MultiIndex"):
        tpanel._index_level(pd.Index([1]), "date", 0)


def test_artifact_store_and_fingerprint_match_jax(tmp_path):
    _, factors, fr = _long_frames(6)
    df = factors.set_index(["date", "symbol"])
    fp = tpanel.FactorPanel.from_frame(df, device="cpu")
    store = tio.ArtifactStore(tmp_path / "store")
    store.save_factor_panel("stack", fp)
    again = store.load_factor_panel("stack", device="cpu")
    _same_panel(again, fp)
    store.save_panel("one", fp.factor("alpha1_flx"))
    _same_panel(store.load_panel("one", device="cpu"), fp.factor("alpha1_flx"))
    calls = []
    frame = fr.set_index("date")
    for _ in range(2):
        got = store.cached("weights", tio.fingerprint(frame.to_numpy(), 3),
                           lambda: calls.append(1) or frame)
    assert calls == [1]
    pd.testing.assert_frame_equal(got, frame, check_freq=False)
    arrays = (np.arange(6.0).reshape(2, 3), np.ones(4, bool), "tag", 7, None)
    assert tio.fingerprint(*arrays) == jio.fingerprint(*arrays)
    assert tio.fingerprint(torch.arange(6.0, dtype=torch.float64)
                           .reshape(2, 3)) == \
        jio.fingerprint(np.arange(6.0).reshape(2, 3))
    assert tio.fingerprint(fp) == jio.fingerprint(
        jpanel.FactorPanel.from_frame(df))


def test_install_binds_the_bare_names_and_uninstall_undoes_it():
    try:
        installed = port_compat.install()
        assert set(installed) == set(port_compat.REFERENCE_MODULES)
        ns: dict = {}
        exec("from operations import ts_decay\n"
             "from portfolio_simulation import Simulation\n"
             "from multi_manager import run_multimanager_backtest\n", ns)
        assert ns["ts_decay"] is port_compat.operations.ts_decay
        assert ns["Simulation"] is port_compat.portfolio_simulation.Simulation
        assert port_compat.install() == []           # idempotent
    finally:
        removed = port_compat.uninstall()
    assert set(removed) == set(port_compat.REFERENCE_MODULES)
    assert "operations" not in sys.modules


def test_install_leaves_names_bound_elsewhere():
    sentinel = types.ModuleType("factor_selector")
    sys.modules["factor_selector"] = sentinel
    jax_installed = jax_compat.install()
    try:
        assert "factor_selector" not in jax_installed
        # every other name is bound to the JAX compat now; the port's
        # install leaves them alone, and its uninstall does not touch them
        assert port_compat.install() == []
        assert sys.modules["operations"].__name__ == \
            "factormodeling_tpu.compat.operations"
        assert port_compat.uninstall() == []
        assert sys.modules["factor_selector"] is sentinel
        taken = port_compat.install(overwrite=True)
        assert set(taken) == set(port_compat.REFERENCE_MODULES)
        assert sys.modules["operations"].__name__ == \
            "factormodeling_tpu_torch.compat.operations"
        assert jax_compat.uninstall() == []          # not its modules now
    finally:
        port_compat.uninstall()
        jax_compat.uninstall()
        sys.modules.pop("factor_selector", None)
    assert not any(name in sys.modules
                   for name in port_compat.REFERENCE_MODULES)


def test_port_imports_without_pandas():
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("pandas", "pyarrow", "matplotlib"):
                    raise ImportError(f"{name} is blocked")

        sys.meta_path.insert(0, Block())
        import factormodeling_tpu_torch as fmt
        from factormodeling_tpu_torch import multimanager
        from factormodeling_tpu_torch.parallel import manager_sweep
        import factormodeling_tpu_torch.compat as compat
        assert fmt.multimanager is multimanager and callable(manager_sweep)
        assert fmt.obs.RunReport and fmt.panel.Panel
        # io imports without pandas (its chunk files need numpy only);
        # its table readers raise when called
        assert callable(fmt.io.disk_chunk_source)
        try:
            fmt.io.read_table("x.csv")
        except ImportError:
            pass
        else:
            raise AssertionError("read_table ran without pandas")
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("pandas", "pyarrow", "matplotlib", "jax")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
