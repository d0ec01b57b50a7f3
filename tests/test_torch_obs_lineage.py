"""The port's provenance ledger and the engine's hooks against the JAX
package's, on the CPU in float64 (the renaming rule is
``torch_obs_streams``'s docstring).

- ``LineageLedger`` fed the same event sequence in both packages: rows,
  ``state()``, ``ledger_errors``, ``traffic_errors`` and ``explain_lines``
  byte-equal, and each package loads the other's ``state()``.
- ``OnlineEngine(flight=True, lineage=True, sentry=...)`` on one stream (a
  rejected NaN storm, a restatement in the ring, a duplicate) in both
  packages: the date-slice and genesis ids and the audit-chain heads byte
  for byte, the state ids up to renaming; the alert log byte-equal but for
  the ``output_ids`` an incident cites, which follow the renaming; the
  flight rows byte-equal; the rows at the step tolerances.
- Hooked checkpoints resume across the packages in both directions (the
  ledger and the alert log carry on, the first new edge's pre-state is the
  last restored output, the checkers stay clean), and within the port a
  resumed run is byte-equal to its straight-through run.
- ``checkpointed_manager_sweep(lineage=)``: the ``sweep_inputs`` id is the
  JAX package's (the same pytree leaves in its order), the chunk edges
  equal up to renaming, a resume byte-equal.
- ``TenantServer.serve(lineage=True)``: panels and config ids byte-equal,
  the dispatch edges up to renaming.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu import resil as jresil
from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.obs import lineage as jlin
from factormodeling_tpu.obs import sentry as jsn
from factormodeling_tpu.parallel import checkpointed_manager_sweep as jsweep
from factormodeling_tpu.parallel import combo_weight_matrix as jax_cw
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu.serve import TenantServer as JaxServer
from factormodeling_tpu_torch.obs import lineage as plin
from factormodeling_tpu_torch.obs import sentry as psn
from factormodeling_tpu_torch.serve import TenantConfig, TenantServer
from tests import torch_obs_streams as st

T = torch.from_numpy


def _events(mod):
    led = mod.LineageLedger()
    panels = led.source("a1" * 8, "panels")
    cfg = led.source("c0" * 8, "config", degraded=False)
    led.source("c0" * 8, "config", degraded=False)       # idempotent
    first = led.edge("b1" * 8, "dispatch", [panels, cfg],
                     code={"static_key": "k", "bucket": "b", "rung": 4,
                           "mesh": None}, trace={"dispatch": 0}, rid=3,
                     tenant="t3")
    gen = led.source("e0" * 8, "state_genesis")
    s1 = led.source("d1" * 8, "date_slice", date=1)
    a1 = led.edge("f1" * 8, "applied", [gen, s1],
                  state={"version": 1, "chain": "9" * 16, "replays": 0},
                  date=1)
    s1b = led.source("d2" * 8, "date_slice", date=1)
    led.edge("f2" * 8, "replayed", [gen, s1b],
             state={"version": 1, "chain": "8" * 16, "replays": 1}, date=1,
             supersedes=a1)
    led.edge("99" * 8, "sweep_chunk", [first], chunk=0, combos=[0, 4])
    return led


def test_ledger_event_sequence_is_byte_equal_to_jax():
    port, jax_ = _events(plin), _events(jlin)
    assert port.rows("q") == jax_.rows("q")
    assert port.state() == jax_.state()
    rows = port.rows("q") + [
        {"kind": "traffic", "name": "q", "rid": 3, "verdict": "SERVED"},
        {"kind": "serving", "name": "q", "submitted": 1, "served": 1,
         "shed_count": 0, "deadline_miss_count": 0, "failed_count": 0}]
    assert plin.ledger_errors(rows) == jlin.ledger_errors(rows) == []
    assert plin.traffic_errors(rows) == jlin.traffic_errors(rows)
    for kw in (dict(rid=3), dict(date=1), dict(output_id="99" * 8)):
        assert plin.explain_lines(rows, **kw) == jlin.explain_lines(rows,
                                                                    **kw)
    broken = [dict(r, inputs=["0" * 16]) if r.get("edge_kind") == "applied"
              else r for r in rows]
    assert plin.ledger_errors(broken) == jlin.ledger_errors(broken) != []
    for a, b in ((plin.LineageLedger(), jax_), (jlin.LineageLedger(), port)):
        a.load_state(b.state())
        assert a.state() == b.state() and a.known("f2" * 8)
    assert port.last_edge(date=1)["output_id"] == "f2" * 8


# ------------------------------------------------------ the hooked engine

@pytest.fixture(scope="module")
def engines():
    market = st.make_market()
    port = st.port_engine(flight=True, lineage=True)
    jeng = st.jax_engine(flight=True, lineage=True)
    dates = list(range(st.D))
    return (port, st.feed(port, market, dates, st.DateSlice),
            jeng, st.feed(jeng, market, dates, st.JaxSlice))


def test_engine_ledger_matches_jax_up_to_renaming(engines):
    port, pv, jeng, jv = engines
    assert [v.status for v in pv] == [v.status for v in jv]
    assert [v.reason for v in pv] == [v.reason for v in jv]
    assert {"applied", "replayed", "rejected"} <= {v.status for v in pv}
    rows, jrows = port.lineage_rows(), jeng.lineage_rows()
    ids = st.renaming(rows, jrows)
    # byte for byte: the slices, the genesis state and the audit chain
    # (the edges' state.chain, compared by renaming() with every field)
    kinds = [r["edge_kind"] for r in rows]
    assert kinds.count("applied") == st.D - 1 and "replayed" in kinds
    assert rows[0]["what"] == "state_genesis"
    assert port._chain == jeng._chain
    assert plin.ledger_errors(rows) == [] == jlin.ledger_errors(jrows)
    # the pre-state of each applied edge is the previous edge's output
    applied = [r for r in rows if r["edge_kind"] == "applied"]
    for prev, cur in zip(applied, applied[1:]):
        assert cur["inputs"][0] == prev["output_id"]
    assert len(ids) == len({r["output_id"] for r in rows})
    # the rows at the step tolerances
    for a, b in zip(pv, jv):
        for x, y in zip(a.outputs, b.outputs):
            for key, tol in (("selection", 1e-10), ("weights", 1e-6)):
                np.testing.assert_allclose(x[key], y[key], atol=tol, rtol=0,
                                           equal_nan=True)


def test_engine_alert_log_and_flight_rows_match_jax(engines):
    port, _, jeng, _ = engines
    ids = st.renaming(port.lineage_rows(), jeng.lineage_rows())
    rows, jrows = port.sentry_rows(), jeng.sentry_rows()
    assert len(rows) == len(jrows)
    incidents = 0
    for a, b in zip(rows, jrows):
        if a["kind"] == "incident":
            incidents += 1
            assert [ids[i] for i in a["output_ids"]] == b["output_ids"]
            a = dict(a, output_ids=b["output_ids"])
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    fired = [r["signal"] for r in rows if r["kind"] == "alert"
             and not r.get("summary")]
    assert {"reject_rate", "replay_rate"} <= set(fired) and incidents
    assert psn.sentry_errors(rows + port.lineage_rows()) == []
    assert port.flight_rows() == jeng.flight_rows()
    assert len(port.flight_rows()) == port.counters["ingested_dates"]


def _kill_and_resume(first, second, market, tmp_path, name):
    """``first`` (an engine factory) takes dates 0..K with a checkpoint,
    ``second`` resumes from the snapshot and takes the rest."""
    ck = tmp_path / f"{name}.snap"
    k = 14
    a = first(checkpoint=ck, lineage=True)
    st.feed(a, market, list(range(k + 1)), _slice_of(a))
    last = a._lineage.last_edge()["output_id"]
    b = second(checkpoint=ck, lineage=True)
    assert b.last_date == k and b._lineage.state() == a._lineage.state()
    assert b._sentry.state() == a._sentry.state()
    verdicts = st.feed(b, market, list(range(k + 1, st.D)), _slice_of(b))
    first_new = next(e for e in b._lineage.edges
                     if e["edge_kind"] == "applied" and e["date"] == k + 1)
    assert first_new["inputs"][0] == last
    return b, verdicts


def _slice_of(eng):
    return st.DateSlice if isinstance(eng, st.OnlineEngine) \
        else st.JaxSlice


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_hooked_checkpoints_resume_across_the_packages(engines, tmp_path,
                                                       direction):
    port, pv, jeng, jv = engines
    market = st.make_market()
    pair = ((st.jax_engine, st.port_engine) if direction == "jax_to_port"
            else (st.port_engine, st.jax_engine))
    resumed, verdicts = _kill_and_resume(*pair, market, tmp_path, direction)
    ref_rows = (port if direction == "port_to_jax" else jeng)
    # the resumed ledger is the other package's straight run's up to
    # renaming, clean, and its rows match the step tolerances
    st.renaming(resumed._lineage.rows("x"), ref_rows._lineage.rows("x")) \
        if direction == "port_to_jax" else \
        st.renaming(resumed._lineage.rows("x"), jeng._lineage.rows("x"))
    rows = resumed.lineage_rows() + resumed.sentry_rows()
    mod = psn if direction == "jax_to_port" else jsn
    lin = plin if direction == "jax_to_port" else jlin
    assert lin.ledger_errors(rows) == [] and mod.sentry_errors(rows) == []
    want = jv[15:] if direction == "jax_to_port" else pv[15:]
    assert [v.status for v in verdicts] == [v.status for v in want]
    for a, b in zip(verdicts, want):
        for x, y in zip(a.outputs, b.outputs):
            np.testing.assert_allclose(x["weights"], y["weights"], atol=1e-6,
                                       rtol=0, equal_nan=True)


def test_resumed_port_engine_is_byte_equal_to_straight(tmp_path):
    # the straight run checkpoints to the path the killed run writes
    # afterwards: an incident cites the checkpoint
    market = st.make_market()
    ck = tmp_path / "port.snap"
    port = st.port_engine(checkpoint=ck, lineage=True)
    pv = st.feed(port, market, list(range(st.D)), st.DateSlice)
    ck.unlink()
    resumed, verdicts = _kill_and_resume(st.port_engine, st.port_engine,
                                         market, tmp_path, "port")
    assert resumed._lineage.state() == port._lineage.state()
    assert resumed._sentry.state() == port._sentry.state()
    assert resumed._chain == port._chain
    for a, b in zip(verdicts, pv[15:]):
        for x, y in zip(a.outputs, b.outputs):
            for key in x:
                assert np.asarray(x[key]).tobytes() == \
                    np.asarray(y[key]).tobytes(), key


# --------------------------------------------------------------- the sweep

def _sweep_case():
    rng = np.random.default_rng(11)
    factors = rng.normal(size=(5, 24, 12))
    returns = rng.normal(scale=0.02, size=(24, 12))
    cap = rng.integers(1, 4, size=(24, 12)).astype(float)
    combos = rng.integers(0, 5, size=(10, 2))
    settings = dict(method="equal", pct=0.3, max_weight=0.05)
    return factors, returns, cap, combos, settings


def test_sweep_ledger_matches_jax_and_resumes(tmp_path):
    factors, returns, cap, combos, kw = _sweep_case()
    pol = dict(min_universe=2, quarantine_nan_frac=0.5)
    ps = fmt.SimulationSettings(
        returns=T(returns), cap_flag=T(cap),
        investability_flag=torch.ones((24, 12), dtype=torch.float64),
        degrade=fmt.resil.DegradePolicy.make(**pol), **kw)
    js = JaxSettings(returns=jnp.asarray(returns), cap_flag=jnp.asarray(cap),
                     investability_flag=jnp.ones((24, 12)),
                     degrade=jresil.DegradePolicy.make(**pol), **kw)
    led, jled = plin.LineageLedger(), jlin.LineageLedger()
    out = fmt.parallel.checkpointed_manager_sweep(
        T(factors), fmt.parallel.combo_weight_matrix(combos, 5, device="cpu"),
        ps, combo_batch=2, chunk_combos=4, lineage=led, device="cpu")
    jout = jsweep(jnp.asarray(factors), jax_cw(combos, 5), js, combo_batch=2,
                  chunk_combos=4, lineage=jled)
    st.renaming(led.rows("s"), jled.rows("s"))
    assert led.edges[0]["output_id"] == jled.edges[0]["output_id"]
    assert [e["combos"] for e in led.edges[1:]] == [[0, 4], [4, 8], [8, 10]]
    np.testing.assert_allclose(out.log_return.numpy(),
                               np.asarray(jout.log_return), atol=1e-12,
                               rtol=0)
    # killed after its first chunk and resumed: byte-equal to straight
    from factormodeling_tpu_torch.parallel import sweep as sweep_mod

    ck = tmp_path / "s.snap"
    real, calls = sweep_mod._combine_and_pnl, {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("killed")
        return real(*a, **k)

    args = (T(factors), fmt.parallel.combo_weight_matrix(combos, 5,
                                                         device="cpu"), ps)
    sweep_mod._combine_and_pnl = dying
    try:
        with pytest.raises(RuntimeError, match="killed"):
            fmt.parallel.checkpointed_manager_sweep(
                *args, combo_batch=2, chunk_combos=4,
                checkpoint=fmt.resil.Checkpointer(ck),
                lineage=plin.LineageLedger(), device="cpu")
    finally:
        sweep_mod._combine_and_pnl = real
    resumed = plin.LineageLedger()
    fmt.parallel.checkpointed_manager_sweep(
        *args, combo_batch=2, chunk_combos=4,
        checkpoint=fmt.resil.Checkpointer(ck), lineage=resumed, device="cpu")
    assert resumed.state() == led.state()


# ------------------------------------------------------- serve(lineage=)

def test_serve_ledger_matches_jax_up_to_renaming():
    rng = np.random.default_rng(3)
    f, d, n = 4, 20, 8
    names = ("a_flx", "b_eq", "c_long", "d_flx")
    market = dict(factors=rng.normal(size=(f, d, n)),
                  returns=rng.normal(scale=0.02, size=(d, n)),
                  factor_ret=rng.normal(scale=0.01, size=(d, f)),
                  cap_flag=rng.integers(1, 4, size=(d, n)).astype(float),
                  investability=np.ones((d, n)),
                  universe=rng.uniform(size=(d, n)) > 0.05)
    cfgs = [dict(top_k=1 + i % f, icir_threshold=-1.0, window=6,
                 method="equal", pct=0.2 + 0.05 * i) for i in range(3)]
    led, jled = plin.LineageLedger(), jlin.LineageLedger()
    server = TenantServer(names=names, pad_ladder=(1, 4), device="cpu",
                          **market)
    got = server.serve([TenantConfig(**c) for c in cfgs], lineage=led)
    jserver = JaxServer(names=names, pad_ladder=(1, 4), **market)
    jserver.serve([JaxTenant(**c) for c in cfgs], lineage=jled)
    rows, jrows = led.rows("serve/sync"), jled.rows("serve/sync")
    ids = st.renaming(rows, jrows)
    assert [r["edge_kind"] for r in rows].count("dispatch") == 3
    assert rows[0]["output_id"] == server.panels_fingerprint() \
        == jserver.panels_fingerprint()
    assert plin.ledger_errors(rows) == []
    # the book ids hash the served lanes' weights
    books = [r for r in rows if r["edge_kind"] == "dispatch"]
    assert books[1]["output_id"] == fmt.resil.checkpoint.fingerprint(
        got[1].output.sim.weights)
    assert len(ids) == len(rows)
