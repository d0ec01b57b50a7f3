"""Shared streams of the obs-layer differential tests
(``tests/test_torch_obs_*.py``): a small market fed to both packages'
``OnlineEngine`` with every hook on, and the helpers that hold two
provenance ledgers equal up to a renaming of the ids of computed content.

Renaming rule: the ids of host content both packages hold bitwise (date
slices, the genesis state, panels, configs, sweep inputs) must be equal
byte for byte; the ids of computed state or outputs (an advanced state, a
served book, a sweep chunk) may differ by the rounding of the computation,
so they are held by a consistent one-to-one map: the same edges in the same
order, with the same kinds, dates, fields, parents and ``supersedes``
pattern. An edge's ``code.bucket`` names the entry point as
``serve/bucket/<tag>``; the tag hashes the entry's identity, which holds
torch dtypes in the port, so only the name before the tag is compared.
"""

import re

import numpy as np

from factormodeling_tpu.online import DateSlice as JaxSlice
from factormodeling_tpu.online import EngineGuards as JaxGuards
from factormodeling_tpu.online import OnlineEngine as JaxEngine
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu_torch.online import (DateSlice, EngineGuards,
                                             OnlineEngine)
from factormodeling_tpu_torch.serve import TenantConfig

F, D, N = 6, 24, 12
SUFFIXES = ("_eq", "_flx", "_long", "_short")
NAMES = tuple(f"fac{i}{SUFFIXES[i % 4]}" for i in range(F))
TMPL = dict(window=6, lookback_period=6, method="mvo_turnover",
            sim_static={"qp_iters": 30, "mvo_batch": 8})
HORIZON = 4
#: a NaN storm on this date (rejected by the guard); a restatement of
#: RESTATE (in the ring) after the last date, and a duplicate of it
STORM, RESTATE = 9, D - 3
EXACT_SOURCES = ("date_slice", "state_genesis", "panels", "config",
                 "sweep_inputs")


def make_market(seed=7):
    rng = np.random.default_rng(seed)
    fac = rng.normal(size=(F, D, N))
    fac[rng.uniform(size=fac.shape) < 0.03] = np.nan
    fac[:, STORM, : N // 2 + 2] = np.nan
    ret = rng.normal(scale=0.02, size=(D, N))
    cap = rng.integers(1, 4, size=(D, N)).astype(float)
    invest = np.ones((D, N))
    fr = rng.normal(scale=0.01, size=(D, F))
    universe = rng.uniform(size=(D, N)) > 0.1
    return fac, ret, cap, invest, fr, universe


def slice_at(cls, t, fac, ret, cap, invest, fr, universe, scale=1.0):
    return cls(factors=fac[:, t, :] * scale, returns=ret[t], factor_ret=fr[t],
               cap_flag=cap[t], investability=invest[t],
               universe=universe[t])


def sentry(mod):
    """The engine's sentry of either package (``mod``: its obs.sentry):
    zero-budget burns over rejected and replayed dates and drift on the
    slice's NaN share and universe count."""
    return mod.Sentry(detectors=[
        mod.BurnRateDetector("reject_rate", bad="rejected",
                             total="ingested", budget=0.0),
        mod.BurnRateDetector("replay_rate", bad="replayed",
                             total="ingested", budget=0.0),
        mod.CusumDetector("nan_frac", k=0.5, h=4.0, warmup=4),
        mod.EwmaBandDetector("universe_count", warmup=4)])


def port_engine(**kw):
    from factormodeling_tpu_torch.obs import sentry as sn

    kw.setdefault("sentry", sentry(sn))
    return OnlineEngine(names=NAMES, n_assets=N, device="cpu",
                        template=TenantConfig(**TMPL), has_universe=True,
                        horizon=HORIZON, guards=EngineGuards.guarded(),
                        **kw)


def jax_engine(**kw):
    from factormodeling_tpu.obs import sentry as jsn

    kw.setdefault("sentry", sentry(jsn))
    return JaxEngine(names=NAMES, n_assets=N, template=JaxTenant(**TMPL),
                     has_universe=True, horizon=HORIZON,
                     guards=JaxGuards.guarded(), **kw)


def feed(eng, market, dates, cls):
    """Ingest ``dates``; the stream's restatement and duplicate follow the
    last date. Returns the verdicts."""
    out = []
    for t in dates:
        out.append(eng.ingest(t, slice_at(cls, t, *market)))
    if dates and dates[-1] == D - 1:
        out.append(eng.ingest(RESTATE, slice_at(cls, RESTATE, *market,
                                                scale=1.5), restate=True))
        out.append(eng.ingest(RESTATE - 1, slice_at(cls, RESTATE - 1,
                                                    *market)))
    return out


def _untagged(value):
    if isinstance(value, dict) and "bucket" in value:
        return dict(value, bucket=re.sub(r"/[0-9a-f]{6}$", "",
                                         str(value["bucket"])))
    return value


def renaming(port_edges, jax_edges, exact=EXACT_SOURCES) -> dict:
    """The port-id -> JAX-id map under which two ledgers' edges are equal
    (module docs); raises AssertionError when there is none."""
    assert len(port_edges) == len(jax_edges)
    ids: dict = {}

    def bind(p, j):
        assert ids.setdefault(p, j) == j, (p, j)

    for p, j in zip(port_edges, jax_edges):
        assert sorted(p) == sorted(j), (p, j)
        for key in p:
            if key not in ("output_id", "inputs", "supersedes"):
                assert _untagged(p[key]) == _untagged(j[key]), (key, p, j)
        if p.get("edge_kind") == "source" and p.get("what") in exact:
            assert p["output_id"] == j["output_id"], p
        for key in ("inputs",):
            assert len(p[key]) == len(j[key])
            for a, b in zip(p[key], j[key]):
                assert ids[a] == b, (a, b)
        if "supersedes" in p:
            assert ids[p["supersedes"]] == j["supersedes"]
        bind(p["output_id"], j["output_id"])
    assert len(set(ids.values())) == len(ids)
    return ids
