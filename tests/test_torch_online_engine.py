"""The port's online engine on the CPU: the exactly-once contract, ported
case by case from the JAX package's ``tests/test_online.py`` and
``tests/test_resil.py``.

- every ingested date terminates in exactly one of APPLIED | REPLAYED |
  REJECTED, with reasons for the rejections (duplicate, out of order,
  malformed, NaN storm, universe collapse, unknown restatement);
- a restatement in the ring replays byte-equal to a clean run on the
  corrected panel; beyond the ring it takes the counted replay from
  genesis, or is rejected with retention off;
- a killed engine (the die hook, in a child interpreter) resumes from its
  checkpoint with no date applied twice and none lost, byte-equal to a
  straight-through run; a snapshot of another configuration never resumes;
- the engine's rows are the JAX engine's at the step tolerances, and its
  obs hooks record (their differentials are the ``test_torch_obs_*``
  files).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from factormodeling_tpu.online import DateSlice as JaxSlice
from factormodeling_tpu.online import OnlineEngine as JaxEngine
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu_torch import resil
from factormodeling_tpu_torch.online import (DateSlice, EngineGuards,
                                             OnlineEngine)
from factormodeling_tpu_torch.resil.checkpoint import tree_leaves
from factormodeling_tpu_torch.serve import TenantConfig
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
F, D, N = 6, 24, 12
SUFFIXES = ("_eq", "_flx", "_long", "_short")
NAMES = tuple(f"fac{i}{SUFFIXES[i % 4]}" for i in range(F))
TMPL = dict(window=6, lookback_period=6)


def make_market(seed=7):
    rng = np.random.default_rng(seed)
    fac = rng.normal(size=(F, D, N))
    ret = rng.normal(scale=0.02, size=(D, N))
    cap = rng.integers(1, 4, size=(D, N)).astype(float)
    invest = np.ones((D, N))
    fr = rng.normal(scale=0.01, size=(D, F))
    return fac, ret, cap, invest, fr, None


def slice_at(t, fac, ret, cap, invest, fr, universe):
    return DateSlice(factors=fac[:, t, :], returns=ret[t], factor_ret=fr[t],
                     cap_flag=cap[t], investability=invest[t],
                     universe=None if universe is None else universe[t])


def engine(**kw):
    kw.setdefault("template", TenantConfig(**TMPL))
    return OnlineEngine(names=NAMES, n_assets=N, device="cpu", **kw)


def feed(eng, market, dates=None):
    outs = []
    for t in (range(D) if dates is None else dates):
        outs.extend(eng.ingest(t, slice_at(t, *market)).outputs)
    return outs


def assert_rows_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def assert_states_equal(a, b):
    la, lb = tree_leaves(a._state), tree_leaves(b._state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.device == y.device
            assert x.numpy().tobytes() == y.numpy().tobytes()
        else:
            assert x == y


def test_engine_restatement_replays_byte_equal_to_clean_run():
    market = make_market()
    fac = market[0]
    eng = engine(horizon=5)
    feed(eng, market)
    fac2 = fac.copy()
    fac2[:, D - 3, :] *= 1.5
    corrected = (fac2,) + market[1:]
    v = eng.ingest(D - 3, slice_at(D - 3, *corrected), restate=True)
    assert v.status == "replayed" and v.reason == "ring"
    assert v.replayed_dates == (D - 3, D - 2, D - 1)
    clean = engine(horizon=5)
    clean_by_day = {int(o["day"]): o for o in feed(clean, corrected)}
    for o in v.outputs:
        assert_rows_equal([o], [clean_by_day[int(o["day"])]])
    assert_states_equal(eng, clean)
    assert eng.verdict_complete()


def test_engine_beyond_horizon_takes_counted_full_recompute():
    market = make_market()
    fac2 = market[0].copy()
    fac2[:, 2, :] *= 0.5
    corrected = (fac2,) + market[1:]
    eng = engine(horizon=3)
    feed(eng, market)
    v = eng.ingest(2, slice_at(2, *corrected), restate=True)
    assert v.status == "replayed" and v.reason == "full_recompute"
    assert eng.counters["full_recompute_fallbacks"] == 1
    clean = engine(horizon=3)
    assert_rows_equal(list(v.outputs), feed(clean, corrected))
    # the audit chain is append-only on both replay paths, and an identical
    # ingestion sequence reproduces it
    assert eng._chain != clean._chain
    twin = engine(horizon=3)
    feed(twin, market)
    twin.ingest(2, slice_at(2, *corrected), restate=True)
    assert twin._chain == eng._chain
    eng2 = engine(horizon=3, retain_history=False)
    feed(eng2, market)
    v2 = eng2.ingest(2, slice_at(2, *corrected), restate=True)
    assert v2.status == "rejected" and v2.reason == "restate_beyond_horizon"
    assert eng2.verdict_complete()


def test_engine_verdict_completeness_and_guards():
    fac, ret, cap, invest, fr, _ = make_market()
    universe = np.ones((D, N), bool)
    market = (fac, ret, cap, invest, fr, universe)
    eng = engine(has_universe=True,
                 guards=EngineGuards.guarded(nan_frac_max=0.5,
                                             min_universe=3))
    feed(eng, market, dates=range(D - 2))
    assert eng.ingest(D - 3, slice_at(D - 3, *market)).reason == "duplicate"
    eng.ingest(D - 1, slice_at(D - 1, *market))
    assert eng.ingest(D - 2, slice_at(D - 2, *market)).reason \
        == "out_of_order"
    storm = fac[:, 0, :].copy()
    storm[:] = np.nan
    v = eng.ingest(D + 1, DateSlice(
        factors=storm, returns=ret[0], factor_ret=fr[0], cap_flag=cap[0],
        investability=invest[0], universe=universe[0]))
    assert v.status == "rejected" and v.reason == "nan_storm"
    tiny = universe[0].copy()
    tiny[2:] = False
    v = eng.ingest(D + 2, DateSlice(
        factors=fac[:, 0, :], returns=ret[0], factor_ret=fr[0],
        cap_flag=cap[0], investability=invest[0], universe=tiny))
    assert v.status == "rejected" and v.reason == "universe_collapse"
    assert eng.ingest(D + 5, slice_at(0, *market),
                      restate=True).reason == "restate_unknown"
    assert eng.verdict_complete()
    assert eng.rejected_reasons == {"duplicate": 1, "out_of_order": 1,
                                    "nan_storm": 1, "universe_collapse": 1,
                                    "restate_unknown": 1}
    fields = eng.report_fields()
    assert fields["last_date"] == D - 1 and fields["horizon"] == 8
    assert fields["state_version"] == D - 1 == eng.version
    open_eng = engine(has_universe=True, guards=EngineGuards.open())
    open_eng.ingest(0, DateSlice(
        factors=storm, returns=ret[0], factor_ret=fr[0], cap_flag=cap[0],
        investability=invest[0], universe=universe[0]))
    assert open_eng.counters["applied_dates"] == 1


def test_engine_restatement_passes_the_admission_guards():
    fac, ret, cap, invest, fr, _ = make_market()
    universe = np.ones((D, N), bool)
    market = (fac, ret, cap, invest, fr, universe)
    eng = engine(has_universe=True, horizon=5,
                 guards=EngineGuards.guarded(nan_frac_max=0.5))
    feed(eng, market)
    before = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in tree_leaves(eng._state)]
    storm = fac.copy()
    storm[:, D - 2, :] = np.nan
    v = eng.ingest(D - 2, slice_at(D - 2, storm, ret, cap, invest, fr,
                                   universe), restate=True)
    assert v.status == "rejected" and v.reason == "nan_storm"
    for a, b in zip(before, tree_leaves(eng._state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
        else:
            assert a == b
    assert eng.verdict_complete()


def test_engine_rejects_malformed_slices_as_verdicts():
    market = make_market()
    eng = engine(horizon=4)
    for t in range(4):
        assert eng.ingest(t, slice_at(t, *market)).status == "applied"
    wide = np.zeros(N + 1)
    bad = DateSlice(factors=np.zeros((F, N + 1)), returns=wide,
                    factor_ret=np.zeros(F), cap_flag=wide,
                    investability=wide, universe=None)
    v = eng.ingest(4, bad)
    assert v.status == "rejected" and v.reason == "bad_slice_shape"
    good = slice_at(4, *market)
    v2 = eng.ingest(4, good._replace(universe=np.ones(N, bool)))
    assert v2.status == "rejected" and v2.reason == "bad_slice_fields"
    assert eng.ingest(4, good).status == "applied"
    fac2 = market[0].copy()
    fac2[:, 3, :] *= 1.5
    v3 = eng.ingest(3, slice_at(3, fac2, *market[1:]), restate=True)
    assert v3.status == "replayed" and v3.reason == "ring"
    assert eng.verdict_complete()


def test_engine_checkpoint_history_off_degrades_explicitly(tmp_path):
    market = make_market()
    fac2 = market[0].copy()
    fac2[:, D - 2, :] *= 1.5
    corrected = (fac2,) + market[1:]
    ck = tmp_path / "thin.snap"
    feed(engine(horizon=4, checkpoint=ck, checkpoint_history=False), market)
    resumed = engine(horizon=4, checkpoint=ck, checkpoint_history=False)
    assert resumed.last_date == D - 1
    v = resumed.ingest(D - 2, slice_at(D - 2, *corrected), restate=True)
    assert v.status == "replayed" and v.reason == "ring"
    fac3 = fac2.copy()
    fac3[:, 1, :] *= 0.5
    v2 = resumed.ingest(1, slice_at(1, fac3, *market[1:]), restate=True)
    assert v2.status == "rejected" and v2.reason == "restate_beyond_horizon"
    for t in range(D, D + 6):
        assert resumed.ingest(t, slice_at(t - D, *corrected)).status \
            == "applied"
    v3 = resumed.ingest(D, slice_at(0, *corrected), restate=True)
    assert v3.status == "rejected" and v3.reason == "restate_beyond_horizon"
    assert resumed.counters["full_recompute_fallbacks"] == 0
    assert resumed.verdict_complete()


_CHILD = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from test_torch_online_engine import engine, feed, make_market
eng = engine(horizon=4, checkpoint={ck!r})
feed(eng, make_market())
"""


def test_engine_kill_resume_is_exactly_once_and_byte_equal(tmp_path):
    """A child interpreter checkpoints every applied date and dies on the
    die hook right after date k's save; a new engine resumes from the
    snapshot, the re-sent date k is a duplicate, and the rest of the stream
    finishes byte-equal to a straight-through run."""
    market = make_market()
    ck = tmp_path / "engine.snap"
    k = D // 2
    env = dict(os.environ, _FMT_ONLINE_DIE_AFTER_DATE=str(k))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(root=str(ROOT),
                                             tests=str(ROOT / "tests"),
                                             ck=str(ck))],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 137, proc.stderr[-2000:]
    resumed = engine(horizon=4, checkpoint=ck)
    assert resumed.last_date == k
    assert resumed.counters["applied_dates"] == k + 1
    dup = resumed.ingest(k, slice_at(k, *market))
    assert dup.status == "rejected" and dup.reason == "duplicate"
    outs_b = feed(resumed, market, dates=range(k + 1, D))
    straight = engine(horizon=4)
    outs_c = feed(straight, market)
    assert_rows_equal(outs_b, outs_c[k:])
    assert_states_equal(resumed, straight)
    assert resumed._chain == straight._chain
    assert resumed.verdict_complete()
    # the resumed ring replays a restatement like the straight engine's
    fac2 = market[0].copy()
    fac2[:, D - 2, :] *= 1.5
    va = resumed.ingest(D - 2, slice_at(D - 2, fac2, *market[1:]),
                        restate=True)
    vb = straight.ingest(D - 2, slice_at(D - 2, fac2, *market[1:]),
                         restate=True)
    assert va.status == vb.status == "replayed"
    assert_rows_equal(list(va.outputs), list(vb.outputs))
    # a snapshot of another configuration is never resumed
    other = engine(template=TenantConfig(window=5, lookback_period=6),
                   horizon=4, checkpoint=ck)
    assert other.last_date is None


def test_engine_snapshot_is_the_jax_format_and_rows_match_jax(tmp_path):
    """The engine's checkpoint is a snapshot file the JAX package loads; its
    rows match the JAX engine's at the step tolerances."""
    market = make_market(seed=3)
    tmpl = dict(TMPL, method="mvo_turnover",
                sim_static={"qp_iters": 30, "mvo_batch": 8})
    ck = tmp_path / "e.snap"
    eng = engine(template=TenantConfig(**tmpl), checkpoint=ck)
    outs = feed(eng, market)
    from factormodeling_tpu import resil as jresil

    state, meta = jresil.load_snapshot(ck)
    assert meta["entry"] == "online_engine"
    assert state["applied"] == list(range(D))
    jeng = JaxEngine(names=NAMES, n_assets=N, template=JaxTenant(**tmpl))
    fac, ret, cap, invest, fr, _ = market
    jouts = []
    for t in range(D):
        jouts.extend(jeng.ingest(t, JaxSlice(
            factors=fac[:, t], returns=ret[t], factor_ret=fr[t],
            cap_flag=cap[t], investability=invest[t])).outputs)
    assert len(outs) == len(jouts) == D - 1
    for a, b in zip(outs, jouts):
        assert int(a["day"]) == int(b["day"])
        for key, tol in (("selection", 1e-10), ("signal", 1e-10),
                         ("weights", 1e-6), ("log_return", 1e-6)):
            np.testing.assert_allclose(a[key], b[key], atol=tol, rtol=0,
                                       equal_nan=True, err_msg=key)
        assert int(a["long_count"]) == int(b["long_count"])


def test_engine_unported_hooks_raise_and_default_is_the_card(tmp_path):
    # the engine's obs hooks are all ported now: each records, none raises
    # (their differentials against the JAX engine are in
    # test_torch_obs_lineage.py, test_torch_obs_sentry.py and
    # test_torch_obs_flight.py)
    for hook, rows in (("flight", "flight_rows"), ("lineage", "lineage_rows"),
                       ("sentry", "sentry_rows")):
        eng = engine(**{hook: True})
        feed(eng, make_market(), dates=range(3))
        assert getattr(eng, rows)() != [] or hook == "sentry"
        assert getattr(engine(), rows)() == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OnlineEngine(names=NAMES, n_assets=N,
                         template=TenantConfig(**TMPL))
    with pytest.raises(ValueError, match="horizon"):
        engine(horizon=0)
    # a checkpointer passed in is used as is: every third applied date
    ck = resil.Checkpointer(tmp_path / "e.snap", every=3)
    eng = engine(checkpoint=ck)
    feed(eng, make_market(), dates=range(5))
    state, _ = resil.load_snapshot(tmp_path / "e.snap")
    assert state["applied"] == [0, 1, 2]
