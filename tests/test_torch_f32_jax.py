"""The port in float32 on the CPU against the JAX package in its production
precision (x64 off): the two modules whose kernels were redesigned for
Hopper, the fused normalization chain ``cs_zscore_group_neutralize`` (K5's
function) and ``daily_factor_stats``'s IC and rank-IC (K1's); and the
modules the serving lanes run, ``composite_weighted`` under a group tilt,
``icir_top`` with ``finalize_selection``, the ``equal`` and ``linear``
backtests, a lane-batched ``equal`` bucket (``[C]`` knobs) against
``jax.vmap`` of the JAX backtest, and the online advance
(``make_online_step``, float32 panels) for the ``equal`` and ``linear``
schemes over ``ONLINE_DATES`` dates against the JAX package's jitted
advance. The QP schemes solve in float64 and are not held here.

The test suite runs JAX in x64 (conftest), so the JAX side runs in a child
interpreter with x64 never enabled, the idiom of ``tests/test_compat_f32.py``,
and hands its outputs back as an ``.npz`` (one child for every case). Both
sides get the same seeded float32 inputs. The outputs are held to the
smooth-statistics tier of ``tools/device_goldens.py::check``
(``TOL_SMOOTH``, 3e-4), with NaN at the same cells and the pair and leg
counts exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from factormodeling_tpu_torch import ops
from factormodeling_tpu_torch.backtest import (SimulationSettings,
                                               run_simulation)
from factormodeling_tpu_torch.backtest.settings import lane_knobs
from factormodeling_tpu_torch.composite import (composite_weighted,
                                                prefix_group_ids)
from factormodeling_tpu_torch.metrics import daily_factor_stats
from factormodeling_tpu_torch.online import DateSlice, make_online_step
from factormodeling_tpu_torch.selection import (finalize_selection,
                                                icir_top_selector)
from factormodeling_tpu_torch.selection.selectors import SelectionContext
from factormodeling_tpu_torch.ops import _cuda_fused as cf
from factormodeling_tpu_torch.serve import TenantConfig
from tests.torch_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools.device_goldens import TOL_SMOOTH  # noqa: E402

G = 5
#: the blend's factors (three prefix groups, every suffix rule) and the
#: selection window
NAMES = ("mom_eq", "mom_flx", "val_long", "val_short", "qual_flx")
WINDOW = 6
#: the lane-batched equal bucket's knobs, one a lane
LANES = dict(pct=[0.15, 0.25, 0.35], tcost_scale=[1.0, 0.5, 2.0])
#: the online advance's dates and its config (both schemes)
ONLINE_DATES = 12
ONLINE = dict(window=4, lookback_period=6, top_k=2, icir_threshold=-1.0)
ONLINE_ROWS = ("selection", "signal", "weights", "log_return", "turnover")

_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
import jax

jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64, "child must run the production f32 path"
import jax.numpy as jnp
import numpy as np

from factormodeling_tpu import ops
from factormodeling_tpu.metrics import daily_factor_stats

d = np.load({inputs!r})
z = ops.cs_zscore_group_neutralize(jnp.asarray(d["x"]), jnp.asarray(d["gid"]),
                                   {g}, universe=jnp.asarray(d["uni"]))
st = daily_factor_stats(jnp.asarray(d["fac"]), jnp.asarray(d["ret"]),
                        universe=jnp.asarray(d["uni"]),
                        stats=("ic", "rank_ic"))
out = dict(z=np.asarray(z), ic=np.asarray(st["ic"]),
           rank_ic=np.asarray(st["rank_ic"]), n_pairs=np.asarray(st["n_pairs"]))

from factormodeling_tpu.backtest import SimulationSettings, run_simulation
from factormodeling_tpu.composite import composite_weighted
from factormodeling_tpu.selection import finalize_selection, icir_top_selector
from factormodeling_tpu.selection.selectors import SelectionContext

uni = jnp.asarray(d["uni"])
out["blend"] = np.asarray(jax.jit(lambda f, s, u, g: composite_weighted(
    f, {names!r}, s, universe=u, group_tilt=g))(
    jnp.asarray(d["bf"]), jnp.asarray(d["bsel"]), uni,
    jnp.asarray(d["tilt"])))
ctx = SelectionContext(metrics_win={{"rank_IC_IR": jnp.asarray(d["score"])}},
                       factor_ret=jnp.asarray(d["fr"]),
                       ret_win_sum=jnp.asarray(d["fr"]), window={window})
out["sel"] = np.asarray(finalize_selection(
    icir_top_selector(ctx, icir_threshold=0.1, top_x=2), {window}))


def sim(sig, **kw):
    s = SimulationSettings(returns=jnp.asarray(d["ret"]),
                           cap_flag=jnp.asarray(d["cap"]),
                           investability_flag=jnp.asarray(d["inv"]),
                           universe=uni, **kw)
    o = run_simulation(sig, s)
    return o.weights, o.result.log_return, o.long_count


for name, kw in (("eq", dict(method="equal", pct=0.2)),
                 ("lin", dict(method="linear", max_weight=0.05))):
    w, r, lc = jax.jit(lambda g, kw=kw: sim(g, **kw))(
        jnp.asarray(d["sig"][0]))
    out[name + "_w"], out[name + "_r"], out[name + "_lc"] = map(np.asarray,
                                                              (w, r, lc))
w, r, lc = jax.jit(jax.vmap(lambda g, p, c: sim(g, method="equal", pct=p,
                                                tcost_scale=c)))(
    jnp.asarray(d["sig"]), jnp.asarray(d["pct"]), jnp.asarray(d["tc"]))
out["lanes_w"], out["lanes_r"], out["lanes_lc"] = map(np.asarray, (w, r, lc))

from factormodeling_tpu.online import DateSlice, make_online_step
from factormodeling_tpu.serve.tenant import TenantConfig

for m in ("equal", "linear"):
    tmpl = TenantConfig(method=m, **{online!r}).normalized(
        {n_names}, {groups}, dtype=np.float32)
    init, adv = make_online_step(names={names!r}, template=tmpl,
                                 n_assets=d["ret"].shape[1],
                                 dtype=jnp.float32, has_universe=True)
    adv = jax.jit(adv)
    ms, ts = init()
    rows = []
    for t in range({online_dates}):
        (ms, ts), o = adv(tmpl, ms, ts, DateSlice(
            factors=jnp.asarray(d["bf"][:, t]), returns=jnp.asarray(d["ret"][t]),
            factor_ret=jnp.asarray(d["fr"][t]), cap_flag=jnp.asarray(d["cap"][t]),
            investability=jnp.asarray(d["inv"][t]),
            universe=jnp.asarray(d["uni"][t])))
        rows.append(o)
    for k in {online_rows!r} + ("long_count",):
        out[f"on_{{m}}_{{k}}"] = np.stack([np.asarray(getattr(o, k))
                                         for o in rows[1:]])
assert all(v.dtype != np.float64 for v in out.values())
np.savez({outputs!r}, **out)
"""


def _inputs(seed=20261017, f=3, d=40, n=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(f, d, n)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.05] = np.nan
    x[0, 3] = 7.5                     # a constant date: z NaN
    x[1, 4] = np.nan                  # an all-NaN date
    gid = rng.integers(-1, G, size=(d, n)).astype(np.int32)
    gid[5] = 0                        # one group takes a date
    gid[7, 9] = 3
    gid[8, 11] = G + 2                # an id past the groups
    fac = np.round(rng.normal(size=(f, d, n)) * 2.0).astype(np.float32)
    fac[rng.uniform(size=fac.shape) < 0.05] = np.nan
    fac[2, :, ::3] = -0.0             # -0.0 beside +0.0 ties
    ret = rng.normal(scale=0.02, size=(d, n)).astype(np.float32)
    ret[rng.uniform(size=ret.shape) < 0.03] = np.nan
    uni = rng.uniform(size=(d, n)) > 0.1
    f_b = len(NAMES)
    bf = rng.normal(size=(f_b, d, n)).astype(np.float32)
    bf[rng.uniform(size=bf.shape) < 0.05] = np.nan
    bsel = rng.uniform(size=(d, f_b)).astype(np.float32)
    bsel[bsel < 0.4] = 0.0
    bsel[:2] = 0.0                    # days with no active factor
    score = rng.normal(scale=0.3, size=(f_b, d)).astype(np.float32)
    score[rng.uniform(size=score.shape) < 0.1] = np.nan
    sig = rng.normal(size=(len(LANES["pct"]), d, n)).astype(np.float32)
    sig[:, ~uni] = np.nan
    return dict(x=x, gid=gid, fac=fac, ret=ret, uni=uni, bf=bf, bsel=bsel,
                tilt=np.array([2.0, 0.5, 1.0], np.float32), score=score,
                fr=rng.normal(scale=0.01, size=(d, f_b)).astype(np.float32),
                sig=sig, cap=rng.integers(1, 4, size=(d, n)).astype(
                    np.float32),
                inv=np.ones((d, n), np.float32),
                pct=np.asarray(LANES["pct"], np.float32),
                tc=np.asarray(LANES["tcost_scale"], np.float32))


def _held(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    worst = float(np.nanmax(np.abs(got - want), initial=0.0))
    assert worst <= TOL_SMOOTH, f"{name}: max |d| {worst} > {TOL_SMOOTH}"


def _groups() -> int:
    return len(prefix_group_ids(NAMES)[1])


def _online_rows(t, method):
    """The port's float32 online advance over the first ONLINE_DATES
    dates: ``{field: [dates - 1, ...]}`` of the finalized rows."""
    tmpl = TenantConfig(method=method, **ONLINE).normalized(
        len(NAMES), _groups(), dtype=np.float32)
    init, adv = make_online_step(names=NAMES, template=tmpl,
                                 n_assets=t["ret"].shape[1],
                                 dtype=torch.float32, has_universe=True,
                                 device="cpu")
    ms, ts = init()
    rows = []
    for d in range(ONLINE_DATES):
        (ms, ts), o = adv(tmpl, ms, ts, DateSlice(
            t["bf"][:, d], t["ret"][d], t["fr"][d], t["cap"][d],
            t["inv"][d], t["uni"][d]))
        rows.append(o)
    assert rows[-1].signal.dtype == torch.float32
    return {k: np.stack([getattr(o, k).numpy() for o in rows[1:]])
            for k in ONLINE_ROWS + ("long_count",)}


def test_float32_port_matches_jax_x64_off(tmp_path):
    data = _inputs()
    inputs, outputs = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inputs, **data)
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(
            repo=str(REPO), g=G, names=NAMES, window=WINDOW,
            inputs=str(inputs), outputs=str(outputs), online=ONLINE,
            n_names=len(NAMES), groups=_groups(),
            online_dates=ONLINE_DATES, online_rows=ONLINE_ROWS)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(outputs)

    t = {k: torch.from_numpy(v) for k, v in data.items()}
    z = ops.cs_zscore_group_neutralize(t["x"], t["gid"], G,
                                       universe=t["uni"])
    assert z.dtype == torch.float32
    _held(z.numpy(), want["z"], "cs_zscore_group_neutralize")
    masked = torch.where(t["uni"], t["x"], float("nan"))
    _held(cf.zscore_group_neutralize_plain(masked, t["gid"], G).numpy(),
          want["z"], "zscore_group_neutralize_plain")

    st = daily_factor_stats(t["fac"], t["ret"], universe=t["uni"],
                            stats=("ic", "rank_ic"))
    assert st["rank_ic"].dtype == torch.float32
    np.testing.assert_array_equal(st["n_pairs"].numpy(), want["n_pairs"])
    _held(st["ic"].numpy(), want["ic"], "ic")
    _held(st["rank_ic"].numpy(), want["rank_ic"], "rank_ic")

    # the modules the serving lanes run
    blend = composite_weighted(t["bf"], NAMES, t["bsel"], universe=t["uni"],
                               group_tilt=t["tilt"])
    assert blend.dtype == torch.float32
    _held(blend.numpy(), want["blend"], "composite_weighted")
    ctx = SelectionContext(metrics_win={"rank_IC_IR": t["score"]},
                           factor_ret=t["fr"], ret_win_sum=t["fr"],
                           window=WINDOW)
    sel = finalize_selection(icir_top_selector(ctx, icir_threshold=0.1,
                                               top_x=2), WINDOW)
    _held(sel.numpy(), want["sel"], "icir_top + finalize_selection")

    def sim(sig, **kw):
        s = SimulationSettings(returns=t["ret"], cap_flag=t["cap"],
                               investability_flag=t["inv"],
                               universe=t["uni"], **kw)
        o = run_simulation(sig, s)
        return o.weights, o.result.log_return, o.long_count

    for name, kw in (("eq", dict(method="equal", pct=0.2)),
                     ("lin", dict(method="linear", max_weight=0.05))):
        w, r, lc = sim(t["sig"][0], **kw)
        assert w.dtype == torch.float32
        _held(w.numpy(), want[name + "_w"], name + " weights")
        _held(r.numpy(), want[name + "_r"], name + " log_return")
        np.testing.assert_array_equal(lc.numpy(), want[name + "_lc"])
    w, r, lc = sim(t["sig"], method="equal", **lane_knobs(LANES, "cpu"))
    assert w.shape == t["sig"].shape and w.dtype == torch.float32
    _held(w.numpy(), want["lanes_w"], "equal lanes weights")
    _held(r.numpy(), want["lanes_r"], "equal lanes log_return")
    np.testing.assert_array_equal(lc.numpy(), want["lanes_lc"])

    # the online advance, float32 panels, against the JAX package's
    for method in ("equal", "linear"):
        got = _online_rows(t, method)
        for k in ONLINE_ROWS:
            _held(got[k], want[f"on_{method}_{k}"], f"online {method} {k}")
        np.testing.assert_array_equal(got["long_count"],
                                      want[f"on_{method}_long_count"])
        # the selection reaches its window: some rows are blended
        assert np.count_nonzero(got["selection"]) > 0
