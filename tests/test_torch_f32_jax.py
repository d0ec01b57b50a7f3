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

Then the rest of the float32 surface:

- the seeded draws at the x64-off widths: 32-bit bits, float32 uniforms
  with and without bounds and int32 ``randint`` bitwise, float32 normals
  within ``NORMAL_ULP``; fault injection with every class on and the
  scenario families' draws bitwise at the float32 default;
- every op of the ops package not held above, and ``cs_ols``, on
  ``tests/test_torch_ops.py``'s panels at unit scale, each output held to
  ``TOL_SMOOTH`` relative to its scale; the same panels at
  ``OP_BIG_SCALE``, where float32 rounding grows with the values: the
  port's float32 distance from its float64 answer within ``BIG_FACTOR``
  times the JAX package's plus ``BIG_SLACK``;
- the metric tables (``single_factor_metrics``, ``aggregate_metrics``,
  ``rolling_metrics``) and the momentum, ``mvo``, ``pca`` and
  ``regression`` selectors;
- the compat layer at the float32 default: ``tests/test_compat_f32.py``'s
  six ops at its tolerances and its ``mvo_turnover`` simulation at its
  leg-sum gate, float32 in flight and realigned on the caller's index.

The test suite runs JAX in x64 (conftest), so the JAX side runs in a child
interpreter with x64 never enabled, the idiom of ``tests/test_compat_f32.py``,
and hands its outputs back as an ``.npz`` (one child for the module, each
of its functions traced once). Both sides get the same seeded float32
inputs. The outputs are held to the smooth-statistics tier of
``tools/device_goldens.py::check`` (``TOL_SMOOTH``, 3e-4), with NaN at the
same cells and the pair and leg counts exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from factormodeling_tpu_torch import ops, resil, scenarios
from factormodeling_tpu_torch import threefry as tf
from factormodeling_tpu_torch.backtest import (SimulationSettings,
                                               run_simulation)
from factormodeling_tpu_torch.backtest.settings import lane_knobs
from factormodeling_tpu_torch.composite import (composite_weighted,
                                                prefix_group_ids)
from factormodeling_tpu_torch.metrics import (aggregate_metrics,
                                              daily_factor_stats,
                                              rolling_metrics,
                                              single_factor_metrics)
from factormodeling_tpu_torch.online import DateSlice, make_online_step
from factormodeling_tpu_torch.resil import faults
from factormodeling_tpu_torch.selection import (finalize_selection,
                                                icir_top_selector,
                                                rolling_selection)
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

#: the seeded draws: seeds, shapes (the last odd and above 2**16 elements),
#: uniform bounds and randint spans, as in tests/test_torch_threefry.py
DRAW_SEEDS = (0, 1, 7, 2**31 - 1)
DRAW_SHAPES = ((), (1,), (7,), (5, 7, 3), (263, 257))
DRAW_BOUNDS = ((0.0, 1.0), (-2.5, 3.7))
DRAW_SPANS = (1, 3, 1332)
NORMAL_ULP = 4
#: fault injection with every class on, at each stage
CHAOS = dict(seed=11, nan_rate=0.05, inf_rate=0.05, outlier_rate=0.05,
             outlier_mag=6.0, stale_rate=0.2, drop_rate=0.2,
             collapse_rate=0.3, collapse_keep=3)
FAULT_STAGES = (("ops/factors_raw", 1), ("selection/rolling", 0),
                ("composite/blend", 0))
FAULT_SHAPES = ((3, 40, 16), (40, 5), (40, 16))
SCEN = dict(boot=dict(seed=5, block_len=10),
            regime=dict(seed=7, vol_scale=2.0, mean_shift=-0.005,
                        corr_tighten=0.4),
            adv=dict(seed=3, window_len=20, nan_rate=0.05, inf_rate=0.02,
                     outlier_rate=0.05, stale_rate=0.3, drop_rate=0.2,
                     collapse_rate=0.2))
#: every op of the ops package that the float32 differential held nowhere
#: before, and cs_ols: ``m`` the ops module, ``a`` the inputs, ``G`` the
#: groups
OP_GROUPS = 5
OPS = {
    "ts_sum": "m.ts_sum(a['x'], 5, universe=a['uni'])",
    "ts_mean": "m.ts_mean(a['x'], 4)",
    "ts_std": "m.ts_std(a['x'], 5, universe=a['uni'])",
    "ts_zscore": "m.ts_zscore(a['x'], 5)",
    "ts_rank": "m.ts_rank(a['x'], 6, universe=a['uni'])",
    "ts_diff": "m.ts_diff(a['x'], 5)",
    "ts_delay": "m.ts_delay(a['x'], 5, universe=a['uni'])",
    "ts_decay": "m.ts_decay(a['stack'], 9, universe=a['uni'])",
    "ts_backfill": "m.ts_backfill(a['x'], universe=a['uni'])",
    "cs_rank": "m.cs_rank(a['x'], universe=a['uni'], method='average')",
    "cs_winsor": "m.cs_winsor(a['x'], (0.05, 0.9), min_valid=8, "
                 "universe=a['uni'])",
    "cs_filter_center": "m.cs_filter_center(a['x'], (0.2, 0.6), "
                        "universe=a['uni'])",
    "cs_zscore": "m.cs_zscore(a['stack'], a['uni'])",
    "cs_bool": "m.cs_bool(a['x'] > 0.1, a['x'], a['y'])",
    "cs_mean": "m.cs_mean(a['x'], a['uni'])",
    "market_neutralize": "m.market_neutralize(a['x'], a['uni'])",
    "sign": "m.sign(a['x'])",
    "power": "m.power(a['x'], 3)",
    "log": "m.log(a['x'])",
    "abs_": "m.abs_(a['x'])",
    "clip": "m.clip(a['x'], -0.5, 0.75)",
    "bucket": "m.bucket(a['unit'])",
    "group_mean": "m.group_mean(a['x'], a['gid'], G)",
    "group_neutralize": "m.group_neutralize(a['stack'], a['gid'], G)",
    "group_normalize": "m.group_normalize(a['x'], a['gid'], G)",
    "group_rank_normalized": "m.group_rank_normalized(a['stack'], "
                             "a['gid'], G)",
    "cs_ols": "m.cs_ols(a['y'], a['stack'], universe=a['uni'], ridge=0.05)",
    "cs_regression": "m.cs_regression(a['y'], a['x'], 'resid', "
                     "universe=a['uni'])",
    "ts_regression_fast": "m.ts_regression_fast(a['y'], a['x'], 6, lag=2, "
                          "rettype=2, universe=a['uni'])",
    "forward_fill": "m.forward_fill(a['x'])",
    "masked_shift": "m.masked_shift(a['x'], a['uni'], 2)",
    "rolling_sum": "m.rolling_sum(a['y'], 4)",
    "shift": "m.shift(a['x'], 3)",
}
#: the ill-conditioned case: the panels scaled by OP_BIG_SCALE, where
#: float32 rounding, not the formulation, parts the two packages: the
#: port's float32 distance from the port's float64 answer is held to
#: BIG_FACTOR times the JAX package's plus BIG_SLACK
OP_BIG_SCALE, OP_SCALED = 1e3, ("x", "y", "stack")
BIG_FACTOR, BIG_SLACK = 2.0, 1e-6
#: the metric tables' rolling window and the four further selectors (the
#: factor_momentum selector is registered as "momentum")
METRIC_WINDOW = 10
SELECTORS = {"momentum": {}, "mvo": dict(qp_iters=500),
             "pca": {}, "regression": {}}
#: tests/test_compat_f32.py's six compat ops (name: op, args, its atol)
COMPAT_OPS = {"ts_mean": ("ts_mean", (5,), 1e-5),
              "ts_zscore": ("ts_zscore", (5,), 1e-4),
              "ts_rank": ("ts_rank", (5,), 1e-5),
              "cs_rank": ("cs_rank", (), 1e-6),
              "cs_zscore": ("cs_zscore", (), 1e-4),
              "market_neutralize": ("market_neutralize", (), 1e-4)}
COMPAT_SIM = dict(method="mvo_turnover", max_weight=0.4, lookback_period=6,
                  plot=False, output_returns=True)
#: its gate on the simulation: leg sums within 1e-2 of 1 past the first
#: 8 (warm-up) dates
COMPAT_LEG_TOL, COMPAT_WARMUP = 1e-2, 8

#: the float32 paths the card runs (chip_smoke.py paths 4, 8a-8b, 12a,
#: 12d-12e): the equal scheme, the decay windows, the combos of the sweep
#: and its chunk, the streamed chunk, the scenario tenant and its paths
PATHS_SIM = dict(method="equal", pct=0.2)
DECAY_WINDOWS = (0, 2, 5, 9)
COMBOS = ((0, 1, 2), (1, 3, 4), (0, 2, 4), (2, 3, 4), (0, 0, 1))
COMBO_BATCH = 2
STREAM_CHUNK = 2
SCEN_TENANT = dict(method="equal", window=WINDOW, lookback_period=WINDOW,
                   top_k=3, icir_threshold=-1.0, pct=0.2)
SCEN_PATHS = 4
#: the chaos matrix's tier-1 smoke (tests/test_chaos.py's SMOKE) over every
#: fault class and policy
CHAOS_SMOKE = dict(shape=(4, 28, 12), window=6, method="equal", rate=0.08,
                   day_rate=0.25, seed=11)

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
z = jax.jit(lambda x, gid, uni: ops.cs_zscore_group_neutralize(
    x, gid, {g}, universe=uni))(jnp.asarray(d["x"]), jnp.asarray(d["gid"]),
                                jnp.asarray(d["uni"]))
st = jax.jit(lambda f, r, uni: daily_factor_stats(
    f, r, universe=uni, stats=("ic", "rank_ic")))(
    jnp.asarray(d["fac"]), jnp.asarray(d["ret"]), jnp.asarray(d["uni"]))
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
"""


_CHILD_MORE = r"""
import json
import pandas as pd
from jax import random

from factormodeling_tpu import resil, scenarios as jsc
from factormodeling_tpu.metrics import (aggregate_metrics, rolling_metrics,
                                        single_factor_metrics)
from factormodeling_tpu.selection import rolling_selection

cfg = json.load(open(sys.argv[1]))

# the seeded draws at the x64-off widths (float32, int32), one trace
shapes = [tuple(sh) for sh in cfg["shapes"]]


@jax.jit
def draws(key):
    res = {}
    for i, shape in enumerate(shapes):
        res[f"{i}_bits"] = random.bits(key, shape, jnp.uint32)
        for j, (lo, hi) in enumerate(cfg["bounds"]):
            res[f"{i}_u{j}"] = random.uniform(key, shape, minval=lo,
                                              maxval=hi)
        for span in cfg["spans"]:
            res[f"{i}_r{span}"] = random.randint(key, shape, 5, 5 + span)
        res[f"{i}_n"] = random.normal(key, shape)
    return res


for seed in cfg["seeds"]:
    for k, v in draws(random.PRNGKey(seed)).items():
        out[f"draw_{seed}_{k}"] = np.asarray(v)

# fault injection and the scenario draws at the same seeds
fs = resil.FaultSpec.make(**cfg["chaos"])
boot = jsc.BootstrapSpec.make(**cfg["boot"])
reg = jsc.RegimeSpec.make(**cfg["regime"])
adv = jsc.AdversarialSpec.make(**cfg["adv"])
dd, nn = d["ret"].shape


@jax.jit
def seeded(xs, uni, ret):
    faulted = [resil.inject(stage, x, fs, date_axis=axis)
               for x, (stage, axis) in zip(xs, cfg["stages"])]
    paths = []
    for p in range(2):
        k = jsc.path_key(adv, p)
        sched = adv.schedule(k, dd)
        paths.append((boot.day_index(jsc.path_key(boot, p), dd),
                      reg.transform_returns(jsc.path_key(reg, p), ret),
                      sched, adv.cell_masks(k, (dd, nn), sched[0])))
    return faulted, resil.inject_universe(uni, fs), paths


faulted, fault_uni, paths = seeded(
    [jnp.asarray(d[f"fault_x{i}"]) for i in range(len(cfg["stages"]))],
    jnp.asarray(d["fault_uni"]), jnp.asarray(d["ret"]))
for i, x in enumerate(faulted):
    out[f"fault_{i}"] = np.asarray(x)
out["fault_uni"] = np.asarray(fault_uni)
for p, (idx, regime, sched, cells) in enumerate(paths):
    out[f"boot_{p}"], out[f"regime_{p}"] = np.asarray(idx), np.asarray(regime)
    for j, m in enumerate(sched):
        out[f"adv_{p}_s{j}"] = np.asarray(m)
    for j, m in enumerate(cells):
        out[f"adv_{p}_c{j}"] = np.asarray(m)

# every op, unit scale and at the ill-conditioned scale, in one trace
every_op = jax.jit(lambda a: {
    name: eval(expr, dict(m=ops, G=cfg["groups"], a=a))
    for name, expr in cfg["ops"].items()})
for scale in ("unit", "big"):
    res = every_op({k: jnp.asarray(d[f"op_{scale}_{k}"])
                    for k in cfg["op_inputs"]})
    for name, r in res.items():
        for j, v in enumerate(r if isinstance(r, tuple) else (r,)):
            out[f"op_{scale}_{name}_{j}"] = np.asarray(v)

# the metric tables and the selectors
fac, ret = jnp.asarray(d["fac"]), jnp.asarray(d["ret"])
uni_m = jnp.asarray(d["uni"])


@jax.jit
def tables(fac, ret, uni):
    daily = daily_factor_stats(fac, ret, shift_periods=2, universe=uni)
    return dict(sfm=single_factor_metrics(fac, ret, universe=uni),
                agg=aggregate_metrics(daily),
                roll=rolling_metrics(daily, cfg["window"]))


for tag, table in tables(fac, ret, uni_m).items():
    for k, v in table.items():
        out[f"{tag}_{k}"] = np.asarray(v)
for method, kw in cfg["selectors"].items():
    out["sel_" + method] = np.asarray(jax.jit(
        lambda f, r, fr, u, method=method, kw=kw: rolling_selection(
            f, r, fr, cfg["window"], method=method, method_kwargs=kw,
            universe=u))(jnp.asarray(d["bf"]), ret, jnp.asarray(d["fr"]),
                         uni_m))

# the compat layer at its production width
sys.path.insert(0, cfg["repo"])
from factormodeling_tpu.compat import operations as cops
from factormodeling_tpu.compat import portfolio_simulation as csim
from tests import pandas_oracle as po

arr, universe = d["c_arr"], d["c_uni"]
x = po.dense_to_long(arr, universe)
for name, (op, args) in cfg["compat_ops"].items():
    got = getattr(cops, op)(x, *args)
    assert got.dtype == np.float32 and got.index.equals(x.index), name
    out["compat_" + name] = got.to_numpy()
cd, cn = arr.shape
st = csim.SimulationSettings(
    returns=po.dense_to_long(d["c_ret"]),
    cap_flag=po.dense_to_long(np.ones((cd, cn))),
    investability_flag=po.dense_to_long(np.ones((cd, cn))),
    factors_df=pd.DataFrame(index=po.dense_to_long(d["c_sig"]).index),
    **cfg["compat_sim"])
sim = csim.Simulation("f32", po.dense_to_long(d["c_sig"]), st)
res = sim.run()
out["compat_sim_log_return"] = res["log_return"].to_numpy(np.float32)
w, _ = sim._daily_trade_list()
out["compat_sim_w"] = po.long_to_dense(w, cd, cn).astype(np.float32)
"""


_CHILD_PATHS = r"""
# the float32 paths the card runs: the decay sweep, the multi-manager
# backtest, the combo sweep, the streamed stats and composite, the static
# blend, the scenario engine's path metrics, and the chaos matrix's smoke
from factormodeling_tpu.analytics import decay_sensitivity
from factormodeling_tpu.composite import composite_static
from factormodeling_tpu.multimanager import run_multimanager_backtest
from factormodeling_tpu.parallel import streaming as jst
from factormodeling_tpu.parallel import sweep as jsweep
from factormodeling_tpu.serve import TenantConfig

bf, ret_p = jnp.asarray(d["bf"]), jnp.asarray(d["ret"])


def eq_settings():
    return SimulationSettings(returns=ret_p, cap_flag=jnp.asarray(d["cap"]),
                              investability_flag=jnp.asarray(d["inv"]),
                              universe=uni_m, **cfg["paths_sim"])


dec = decay_sensitivity(jnp.asarray(d["sig"][0]), eq_settings(),
                        cfg["decay_windows"], universe=uni_m)
for k in ("log_return", "annualized_return", "sharpe"):
    out["path_decay_" + k] = np.asarray(getattr(dec, k))
mm = jax.jit(run_multimanager_backtest)(bf, jnp.asarray(d["mm_fw"]),
                                        eq_settings())
out["path_mm_weights"] = np.asarray(mm.weights)
out["path_mm_long_count"] = np.asarray(mm.long_count)
for k in mm.result._fields:
    out["path_mm_result_" + k] = np.asarray(getattr(mm.result, k))
cw = jsweep.combo_weight_matrix(np.asarray(cfg["combos"]), bf.shape[0])
sw = jax.jit(lambda f, w, s: jsweep.manager_sweep(
    f, w, s, combo_batch=cfg["combo_batch"]))(bf, cw, eq_settings())
for k in sw._fields:
    out["path_sweep_" + k] = np.asarray(getattr(sw, k))
src, sl = jst.host_array_source(d["bf"], cfg["chunk"])
for k, v in jst.streamed_factor_stats(src, len(sl), ret_p, universe=uni_m,
                                      shift_periods=2).items():
    out["path_stream_" + k] = np.asarray(v)
out["path_stream_composite"] = np.asarray(jst.streamed_weighted_composite(
    src, [jnp.asarray(d["stream_w"][s]) for s in sl], universe=uni_m))
# op by op: under jit XLA's float32 rank blend parts from the op-by-op
# blend (and from its float64 answer) by ~7.5e-3 on this market, the
# recorded reference behaviour; the port follows the op-by-op blend
for m in ("zscore", "rank"):
    out["path_static_" + m] = np.asarray(composite_static(
        bf, cfg["names"], m, universe=uni_m))
scen = jsc.run_scenarios(
    names=cfg["names"], template=TenantConfig(**cfg["scen_tenant"]),
    spec=jsc.RegimeSpec.make(**cfg["regime"]), n_paths=cfg["scen_paths"],
    chunk=cfg["scen_paths"], factors=bf, returns=ret_p,
    factor_ret=jnp.asarray(d["fr"]), cap_flag=jnp.asarray(d["cap"]),
    investability=jnp.asarray(d["inv"]), universe=uni_m)
out["path_scen_rows"] = np.asarray(json.dumps(scen.rows, sort_keys=True,
                                              default=float))

sys.path.insert(0, os.path.join(cfg["repo"], "tools"))
import chaos as jchaos

smoke = jchaos.run_chaos(progress=lambda _m: None, **cfg["chaos_smoke"])
out["chaos_smoke"] = np.asarray(json.dumps(smoke, sort_keys=True))

assert all(v.dtype != np.float64 for v in out.values())
np.savez(sys.argv[2], **out)
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


def _extra_inputs(seed=20261018):
    """The inputs of the child's second part: fault panels, the op panels
    at unit scale and at OP_BIG_SCALE, and the compat panels
    (``tests/test_compat_f32.py``'s market)."""
    rng = np.random.default_rng(seed)
    out = {f"fault_x{i}": rng.normal(size=shape).astype(np.float32)
           for i, shape in enumerate(FAULT_SHAPES)}
    out["fault_uni"] = rng.uniform(size=FAULT_SHAPES[2]) > 0.2
    unit = _op_inputs(rng)
    for k, v in unit.items():
        out[f"op_unit_{k}"] = v
        out[f"op_big_{k}"] = (v * np.float32(OP_BIG_SCALE)
                              if k in OP_SCALED else v)
    c = np.random.default_rng(20260802)
    cd, cn = 24, 13
    arr = np.round(c.normal(size=(cd, cn)) * 2) / 2      # half-integer ties
    arr[c.uniform(size=arr.shape) < 0.12] = np.nan
    uni = c.uniform(size=arr.shape) < 0.9
    uni[0, :] = True
    uni[:, 0] = True
    out.update(c_arr=arr, c_uni=uni,
               c_ret=c.normal(scale=0.02, size=(cd, cn)),
               c_sig=c.normal(size=(cd, cn)))
    return out


def _path_inputs(seed=20261019, d=40):
    """The card paths' weights: the multi-manager backtest's daily factor
    weights (a NaN weight and a date without weights, as the float64
    differential has them) and the streamed composite's ``[F, D]``."""
    rng = np.random.default_rng(seed)
    f = len(NAMES)
    fw = rng.uniform(size=(d, f)).astype(np.float32)
    fw /= fw.sum(1, keepdims=True)
    fw[7, 2] = np.nan
    fw[3] = 0.0
    return dict(mm_fw=fw,
                stream_w=rng.random((f, d)).astype(np.float32))


def _op_inputs(rng, d=30, n=16, f=3):
    """``tests/test_torch_ops.py``'s panels in float32: NaNs, ties, a
    constant window, an all-NaN date, a ragged universe, group id -1."""
    x = rng.normal(size=(d, n))
    x[rng.uniform(size=x.shape) < 0.12] = np.nan
    x[:, 1] = np.round(x[:, 1] * 2) / 2
    x[2] = np.round(x[2])
    x[5:12, 4] = 1.25
    x[7] = np.nan
    y = 0.5 * np.nan_to_num(x) + rng.normal(scale=0.3, size=(d, n))
    y[rng.uniform(size=y.shape) < 0.08] = np.nan
    stack = rng.normal(size=(f, d, n))
    stack[rng.uniform(size=stack.shape) < 0.1] = np.nan
    uni = rng.uniform(size=(d, n)) > 0.15
    uni[:, 0] = True
    uni[9, :] = False
    gid = rng.integers(-1, OP_GROUPS - 1, size=(d, n)).astype(np.int32)
    return dict(x=x.astype(np.float32), y=y.astype(np.float32),
                stack=stack.astype(np.float32), uni=uni, gid=gid,
                unit=rng.uniform(-0.1, 1.2, size=(d, n)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    """One x64-off child for the module: ``(inputs, the JAX package's
    outputs)``."""
    tmp = tmp_path_factory.mktemp("f32")
    data = dict(_inputs(), **_extra_inputs(), **_path_inputs())
    inputs, outputs, cfg = tmp / "in.npz", tmp / "out.npz", tmp / "cfg.json"
    np.savez(inputs, **data)
    cfg.write_text(json.dumps(_child_config()))
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["JAX_PLATFORMS"] = "cpu"
    code = _CHILD.format(
        repo=str(REPO), g=G, names=NAMES, window=WINDOW,
        inputs=str(inputs), outputs=str(outputs), online=ONLINE,
        n_names=len(NAMES), groups=_groups(),
        online_dates=ONLINE_DATES, online_rows=ONLINE_ROWS) + _CHILD_MORE \
        + _CHILD_PATHS
    proc = subprocess.run(
        [sys.executable, "-c", code, str(cfg), str(outputs)],
        capture_output=True, text=True, env=env, timeout=420)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return data, dict(np.load(outputs))


def test_float32_port_matches_jax_x64_off(jax_f32):
    data, want = jax_f32
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


def _child_config() -> dict:
    return dict(
        repo=str(REPO), seeds=DRAW_SEEDS, shapes=DRAW_SHAPES,
        bounds=DRAW_BOUNDS, spans=DRAW_SPANS, chaos=CHAOS,
        stages=FAULT_STAGES, groups=OP_GROUPS, ops=OPS,
        op_inputs=["x", "y", "stack", "uni", "gid", "unit"],
        window=METRIC_WINDOW, selectors=SELECTORS,
        compat_ops={k: (op, args) for k, (op, args, _) in COMPAT_OPS.items()},
        compat_sim=COMPAT_SIM, names=NAMES, paths_sim=PATHS_SIM,
        decay_windows=DECAY_WINDOWS, combos=COMBOS, combo_batch=COMBO_BATCH,
        chunk=STREAM_CHUNK, scen_tenant=SCEN_TENANT, scen_paths=SCEN_PATHS,
        chaos_smoke=CHAOS_SMOKE, **SCEN)


def _same_bits(got: torch.Tensor, want: np.ndarray) -> bool:
    got = got.numpy()
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    a = got.view(np.int32).astype(np.int64)
    b = want.view(np.int32).astype(np.int64)
    a = np.where(a < 0, np.iinfo(np.int32).min - a, a)
    b = np.where(b < 0, np.iinfo(np.int32).min - b, b)
    return int(np.abs(a - b).max(initial=0))


@pytest.mark.parametrize("seed", DRAW_SEEDS)
def test_float32_draws_are_jax_s(jax_f32, seed):
    """The x64-off widths: 32-bit bits, float32 uniforms with and without
    bounds, int32 randint bitwise; float32 normals within NORMAL_ULP."""
    _, want = jax_f32
    key = tf.seed_key(seed)
    for i, shape in enumerate(DRAW_SHAPES):
        tag = f"draw_{seed}_{i}"
        bits = tf.random_bits(key, 32, shape, device="cpu")
        assert np.array_equal(bits.numpy(),
                              want[tag + "_bits"].astype(np.int64))
        for j, (lo, hi) in enumerate(DRAW_BOUNDS):
            assert _same_bits(tf.uniform(key, shape, torch.float32, lo, hi,
                                         device="cpu"), want[f"{tag}_u{j}"])
        for span in DRAW_SPANS:
            assert _same_bits(tf.randint(key, shape, 5, 5 + span,
                                         torch.int32, device="cpu"),
                              want[f"{tag}_r{span}"])
        got = tf.normal(key, shape, torch.float32, device="cpu").numpy()
        assert got.dtype == want[tag + "_n"].dtype
        assert _ulps(got, want[tag + "_n"]) <= NORMAL_ULP


def test_float32_faults_and_scenarios_are_jax_s(jax_f32):
    """At the float32 default (the port's counterpart of x64 off), fault
    masks and scenario draws are the JAX package's bitwise, the regime
    path's returns to TOL_SMOOTH."""
    data, want = jax_f32
    assert torch.get_default_dtype() == torch.float32
    spec = resil.FaultSpec.make(**CHAOS)
    for i, (stage, axis) in enumerate(FAULT_STAGES):
        got = faults.inject(stage, torch.from_numpy(data[f"fault_x{i}"]),
                            spec, date_axis=axis)
        assert _same_bits(got, want[f"fault_{i}"]), stage
    got = faults.inject_universe(torch.from_numpy(data["fault_uni"]), spec)
    np.testing.assert_array_equal(got.numpy(), want["fault_uni"])
    boot = scenarios.BootstrapSpec.make(**SCEN["boot"])
    reg = scenarios.RegimeSpec.make(**SCEN["regime"])
    adv = scenarios.AdversarialSpec.make(**SCEN["adv"])
    ret = torch.from_numpy(data["ret"])
    d, n = ret.shape
    for p in range(2):
        idx = boot.day_index(scenarios.path_key(boot, p), d)
        assert idx.dtype == want[f"boot_{p}"].dtype
        np.testing.assert_array_equal(idx, want[f"boot_{p}"])
        _held(reg.transform_returns(scenarios.path_key(reg, p), ret).numpy(),
              want[f"regime_{p}"], f"regime path {p}")
        key = scenarios.path_key(adv, p)
        sched = adv.schedule(key, d)
        for j, m in enumerate(sched):
            np.testing.assert_array_equal(m, want[f"adv_{p}_s{j}"])
        for j, m in enumerate(adv.cell_masks(key, (d, n), sched[0],
                                             device="cpu")):
            np.testing.assert_array_equal(m.numpy(), want[f"adv_{p}_c{j}"])


def _scaled_held(got, want, name):
    """``_held`` relative to the output's scale (its largest finite
    magnitude, 1 for an all-zero output)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin], equal_nan=True), name
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1.0)
    worst = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
    assert worst <= TOL_SMOOTH * scale, (
        f"{name}: max |d| {worst} > {TOL_SMOOTH} x {scale}")


def _port_op(name, data, scale, dtype):
    a = {k: torch.from_numpy(data[f"op_{scale}_{k}"]) for k in
         ("x", "y", "stack", "uni", "gid", "unit")}
    a = {k: v.to(dtype) if v.is_floating_point() else v for k, v in a.items()}
    out = eval(OPS[name], dict(m=ops, G=OP_GROUPS, a=a))
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(OPS))
def test_float32_ops_match_jax(jax_f32, name):
    data, want = jax_f32
    for j, got in enumerate(_port_op(name, data, "unit", torch.float32)):
        w = want[f"op_unit_{name}_{j}"]
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(got.numpy(), w)
        else:
            assert got.dtype == torch.float32, name
            _scaled_held(got.numpy(), w, name)


@pytest.mark.parametrize("name", list(OPS))
def test_float32_ill_conditioned_ops_within_jax_s_rounding(jax_f32, name):
    """Inputs at OP_BIG_SCALE: the port's float32 answer is as far from
    the port's float64 answer (same inputs, widened exactly) as the JAX
    package's float32 answer, within BIG_FACTOR and BIG_SLACK."""
    data, want = jax_f32
    got32 = _port_op(name, data, "big", torch.float32)
    got64 = _port_op(name, data, "big", torch.float64)
    for j, (g32, g64) in enumerate(zip(got32, got64)):
        w32 = want[f"op_big_{name}_{j}"]
        g32, g64 = g32.numpy(), g64.numpy()
        if w32.dtype.kind in "iub":
            np.testing.assert_array_equal(g32, w32)
            continue
        both = np.isfinite(g64) & np.isfinite(w32) & np.isfinite(g32)
        ours = float(np.abs(g32[both] - g64[both]).max(initial=0.0))
        theirs = float(np.abs(w32[both].astype(np.float64)
                              - g64[both]).max(initial=0.0))
        assert ours <= BIG_FACTOR * theirs + BIG_SLACK, (
            f"{name}: port f32 {ours} from f64, JAX f32 {theirs}")
        assert np.array_equal(np.isnan(g32), np.isnan(w32)), name


def test_float32_metric_tables_match_jax(jax_f32):
    data, want = jax_f32
    fac, ret = torch.from_numpy(data["fac"]), torch.from_numpy(data["ret"])
    uni = torch.from_numpy(data["uni"])
    tables = {"sfm": single_factor_metrics(fac, ret, universe=uni)}
    daily = daily_factor_stats(fac, ret, shift_periods=2, universe=uni)
    tables["agg"] = aggregate_metrics(daily)
    tables["roll"] = rolling_metrics(daily, METRIC_WINDOW)
    for tag, table in tables.items():
        keys = sorted(k[len(tag) + 1:] for k in want
                      if k.startswith(tag + "_"))
        assert sorted(table) == keys, tag
        for k, v in table.items():
            assert v.dtype == torch.float32, (tag, k)
            _scaled_held(v.numpy(), want[f"{tag}_{k}"], f"{tag} {k}")


@pytest.mark.parametrize("method", list(SELECTORS))
def test_float32_selectors_match_jax(jax_f32, method):
    data, want = jax_f32
    t = {k: torch.from_numpy(data[k]) for k in ("bf", "ret", "fr", "uni")}
    got = rolling_selection(t["bf"], t["ret"], t["fr"], METRIC_WINDOW,
                            method=method, method_kwargs=SELECTORS[method],
                            universe=t["uni"])
    assert got.dtype == torch.float32
    _scaled_held(got.numpy(), want["sel_" + method], method)
    assert np.count_nonzero(got.numpy()) > 0


def test_float32_compat_matches_jax(jax_f32):
    """The compat ops and a compat ``mvo_turnover`` simulation at the
    float32 default against the JAX package's x64-off compat, at
    ``tests/test_compat_f32.py``'s tolerances and gates, with the float32
    dtype contract."""
    import pandas as pd

    from factormodeling_tpu_torch.compat import operations as cops
    from factormodeling_tpu_torch.compat import portfolio_simulation as csim
    from tests import pandas_oracle as po

    data, want = jax_f32
    x = po.dense_to_long(data["c_arr"], data["c_uni"])
    for name, (op, args, atol) in COMPAT_OPS.items():
        got = getattr(cops, op)(x, *args, device="cpu")
        assert got.dtype == np.float32 and got.index.equals(x.index), name
        g, w = got.to_numpy(float), want["compat_" + name].astype(float)
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        np.testing.assert_allclose(np.nan_to_num(g), np.nan_to_num(w),
                                   atol=atol, rtol=0, err_msg=name)
    cd, cn = data["c_arr"].shape
    sig = po.dense_to_long(data["c_sig"])
    st = csim.SimulationSettings(
        returns=po.dense_to_long(data["c_ret"]),
        cap_flag=po.dense_to_long(np.ones((cd, cn))),
        investability_flag=po.dense_to_long(np.ones((cd, cn))),
        factors_df=pd.DataFrame(index=sig.index), device="cpu", **COMPAT_SIM)
    sim = csim.Simulation("f32", sig, st)
    lr = sim.run()["log_return"].to_numpy(np.float64)
    assert np.isfinite(np.nansum(lr))
    w, _ = sim._daily_trade_list()
    wd = po.long_to_dense(w, cd, cn)
    live = ~np.isnan(wd).all(axis=1)
    live[:COMPAT_WARMUP] = False
    for book in (wd, want["compat_sim_w"].astype(np.float64)):
        longs = np.where(np.nan_to_num(book) > 0, np.nan_to_num(book),
                         0).sum(axis=1)[live]
        assert (np.abs(longs - 1.0) < COMPAT_LEG_TOL).all()
    _held(lr, want["compat_sim_log_return"], "compat log_return")
    _held(wd, want["compat_sim_w"], "compat weights")


def _port_paths(data) -> dict:
    """The port's float32 outputs of ``_CHILD_PATHS``' paths, keyed as the
    child keys the JAX package's."""
    from factormodeling_tpu_torch.analytics import decay_sensitivity
    from factormodeling_tpu_torch.composite import composite_static
    from factormodeling_tpu_torch.multimanager import \
        run_multimanager_backtest
    from factormodeling_tpu_torch.parallel import streaming as pst
    from factormodeling_tpu_torch.parallel import sweep as psweep

    t = {k: torch.from_numpy(data[k]) for k in
         ("bf", "ret", "cap", "inv", "uni", "sig", "fr", "mm_fw")}
    settings = SimulationSettings(returns=t["ret"], cap_flag=t["cap"],
                                  investability_flag=t["inv"],
                                  universe=t["uni"], **PATHS_SIM)
    out = {}
    dec = decay_sensitivity(t["sig"][0], settings, DECAY_WINDOWS,
                            universe=t["uni"])
    for k in ("log_return", "annualized_return", "sharpe"):
        out["path_decay_" + k] = getattr(dec, k)
    mm = run_multimanager_backtest(t["bf"], t["mm_fw"], settings,
                                   device="cpu")
    out["path_mm_weights"], out["path_mm_long_count"] = (mm.weights,
                                                         mm.long_count)
    for k in mm.result._fields:
        out["path_mm_result_" + k] = getattr(mm.result, k)
    cw = psweep.combo_weight_matrix(np.asarray(COMBOS), len(NAMES),
                                    device="cpu")
    sw = psweep.manager_sweep(t["bf"], cw, settings, combo_batch=COMBO_BATCH,
                              device="cpu")
    for k in sw._fields:
        out["path_sweep_" + k] = getattr(sw, k)
    src, sl = pst.host_array_source(data["bf"], STREAM_CHUNK)
    for k, v in pst.streamed_factor_stats(src, len(sl), t["ret"],
                                          universe=t["uni"], shift_periods=2,
                                          device="cpu").items():
        out["path_stream_" + k] = v
    out["path_stream_composite"] = pst.streamed_weighted_composite(
        src, [torch.from_numpy(data["stream_w"][s]) for s in sl],
        universe=t["uni"], device="cpu")
    for m in ("zscore", "rank"):
        out["path_static_" + m] = composite_static(t["bf"], NAMES, m,
                                                   universe=t["uni"])
    return out


#: the paths' outputs held exactly: the counts
PATH_COUNTS = ("path_stream_n_pairs",)


@pytest.fixture(scope="module")
def port_paths(jax_f32):
    return _port_paths(jax_f32[0])


@pytest.mark.parametrize("path", ("decay", "mm", "sweep", "stream",
                                  "static"))
def test_float32_card_paths_match_jax(jax_f32, port_paths, path):
    """The paths the card runs in float32 (the decay sweep, the
    multi-manager backtest, the combo sweep, the streamed stats and
    composite, the static blend) against the JAX package's x64-off run, at
    ``TOL_SMOOTH`` relative to each output's scale, the counts exact."""
    _, want = jax_f32
    keys = sorted(k for k in want if k.startswith(f"path_{path}_"))
    assert keys and keys == sorted(k for k in port_paths
                                   if k.startswith(f"path_{path}_"))
    for k in keys:
        got = port_paths[k]
        if got.is_floating_point() and k not in PATH_COUNTS:
            assert got.dtype == torch.float32, k
            _scaled_held(got.numpy(), want[k], k)
        else:
            np.testing.assert_array_equal(got.numpy(), want[k], err_msg=k)


def test_float32_scenario_path_metrics_match_jax(jax_f32):
    """The scenario engine's risk rows (regime family, the equal tenant)
    over float32 panels against the JAX package's x64-off rows: each
    number at ``TOL_SMOOTH`` relative to its scale, the path counts
    exact."""
    data, want = jax_f32
    t = {k: torch.from_numpy(data[k]) for k in
         ("bf", "ret", "fr", "cap", "inv", "uni")}
    res = scenarios.run_scenarios(
        names=NAMES, template=TenantConfig(**SCEN_TENANT),
        spec=scenarios.RegimeSpec.make(**SCEN["regime"]),
        n_paths=SCEN_PATHS, chunk=SCEN_PATHS, factors=t["bf"],
        returns=t["ret"], factor_ret=t["fr"], cap_flag=t["cap"],
        investability=t["inv"], universe=t["uni"], device="cpu")
    ref = json.loads(str(want["path_scen_rows"]))
    assert [r["metric"] for r in res.rows] == [r["metric"] for r in ref]
    for got, exp in zip(res.rows, ref):
        assert got["paths"] == exp["paths"] == SCEN_PATHS
        for k in ("var", "es", "p50", "lo", "hi"):
            _scaled_held(np.asarray(got[k], np.float64),
                         np.asarray(exp[k], np.float64),
                         f"{exp['metric']} {k}")


def test_float32_chaos_smoke_verdict_is_jax_s(jax_f32):
    """The chaos matrix's smoke over every fault class and policy at the
    float32 default: each cell's verdict, watchdog stage and counters
    exactly the JAX package's x64-off matrix's."""
    from factormodeling_tpu_torch import chaos

    _, want = jax_f32
    ref = json.loads(str(want["chaos_smoke"]))
    got = chaos.run_chaos(device="cpu", progress=lambda _m: None,
                          **CHAOS_SMOKE)
    assert sorted(got["results"]) == sorted(ref["results"])
    assert (got["ok"], got["cells"], got["failed"]) == (
        ref["ok"], ref["cells"], ref["failed"])
    for cell, exp in ref["results"].items():
        res = got["results"][cell]
        assert {k: v for k, v in res.items() if k != "violations"} == \
            {k: v for k, v in exp.items() if k != "violations"}, cell
