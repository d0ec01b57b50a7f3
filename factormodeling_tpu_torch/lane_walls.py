"""Walls of the serving lanes on the card, this checkout beside another.

``python -m factormodeling_tpu_torch.lane_walls [--parent DIR] [--dates D]
[--online-dates T]`` times, at ``chip_smoke.py``'s market (F=50, N=1000,
float32, window 60, icir_top, zscore; data from seed 0) on its first ``D``
dates: one ``mvo_turnover`` tenant's research step (path 10b's tenant 0),
the bucket of path 10b's three tenants through ``TenantServer.serve``,
and ``advance_all`` for one tenant and for path 10d's two over ``T`` dates
(the wall a date, fenced, after the first). Each run also counts the
segment kernel's single-lane and lane launches (``ops._cuda_admm``).

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked with
``git archive`` into a directory ``.gitignore`` lists) the runs go parent,
this, this, parent, each in a fresh interpreter that imports the package
of its checkout and builds its kernels first, so two versions are compared
in one call on one card. Only public entry points present in both versions
are called. Prints one JSON line a run and the card's ``nvidia-smi``
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

F, N, WINDOW, LOOKBACK = 50, 1000, 60, 60


def _market(d: int):
    rng = np.random.default_rng(0)
    full = 1332
    factors = rng.normal(size=(F, full, N)).astype(np.float32)
    factors[rng.uniform(size=factors.shape) < 0.03] = np.nan
    returns = rng.normal(scale=0.02, size=(full, N)).astype(np.float32)
    factor_ret = rng.normal(scale=0.01, size=(full, F)).astype(np.float32)
    cap = rng.integers(1, 4, size=(full, N)).astype(np.float32)
    return dict(factors=factors[:, :d], returns=returns[:d],
                factor_ret=factor_ret[:d], cap_flag=cap[:d],
                investability=np.ones((d, N), np.float32),
                universe=np.ones((d, N), bool))


def _names():
    prefixes = ("alpha", "beta", "gamma", "delta", "eps", "zeta", "eta",
                "theta")
    suffixes = ("_eq", "_flx", "_long", "_short")
    return tuple(f"{prefixes[i % 8]}{i // 8}{suffixes[i % 4]}"
                 for i in range(F))


def measure(dates: int, online_dates: int, device: str = "cuda") -> dict:
    """One run with the package first on ``sys.path`` (``device="cpu"``
    for a dry run of the script itself)."""
    import dataclasses

    import torch

    import factormodeling_tpu_torch as fmt
    from factormodeling_tpu_torch import _build
    from factormodeling_tpu_torch.online import DateSlice
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    if device == "cuda":
        _build.build()
    market = _market(dates)
    names = _names()
    t0 = fmt.serve.TenantConfig(
        method="mvo_turnover", window=WINDOW, lookback_period=LOOKBACK,
        top_k=5, icir_threshold=0.03, max_weight=0.03, pct=0.1,
        turnover_penalty=0.1, sim_static={"solver_kernel": "fused"})
    configs = [t0, dataclasses.replace(t0, turnover_penalty=0.05,
                                       max_weight=0.02, tcost_scale=0.5),
               dataclasses.replace(t0, turnover_penalty=0.2,
                                   max_weight=0.05, tcost_scale=2.0)]
    panels = [torch.as_tensor(market[k], device=device) for k in
              ("factors", "returns", "factor_ret", "cap_flag",
               "investability", "universe")]

    def fence():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        fence()
        start = time.perf_counter()
        out = fn()
        fence()
        return out, time.perf_counter() - start

    def counted(fn):
        ak.launches = ak.lane_launches = 0
        _, secs = timed(fn)
        return secs, {"single": ak.launches - ak.lane_launches,
                      "lanes": ak.lane_launches}

    step = fmt.serve.make_tenant_research_step(names=names, template=t0)
    tenant = t0.normalized(F, F, dtype=np.float32)
    short = [p[:, :WINDOW + 8] if p.ndim == 3 else p[:WINDOW + 8]
             for p in panels]
    step(tenant, *short)                                  # warm-up
    out = {}
    out["step_s"], out["step_k2"] = counted(lambda: step(tenant, *panels))
    server = fmt.serve.TenantServer(names=names, **market, device=device)
    server.serve(configs[:1])                             # warm-up
    out["bucket_s"], out["bucket_k2"] = counted(lambda: server.serve(configs))
    out["bucket_over_step"] = out["bucket_s"] / out["step_s"]

    def advance(cfgs):
        srv = fmt.serve.TenantServer(names=names, **market, device=device)
        srv.online_begin(cfgs)
        walls = []
        ak.launches = ak.lane_launches = 0
        for t in range(online_dates):
            s = DateSlice(factors=market["factors"][:, t],
                          returns=market["returns"][t],
                          factor_ret=market["factor_ret"][t],
                          cap_flag=market["cap_flag"][t],
                          investability=market["investability"][t],
                          universe=market["universe"][t])
            walls.append(timed(lambda: srv.advance_all(s))[1])
        ms = np.asarray(walls[1:]) * 1e3
        return {"p50_ms": float(np.percentile(ms, 50)),
                "p99_ms": float(np.percentile(ms, 99)),
                "k2": {"single": ak.launches - ak.lane_launches,
                       "lanes": ak.lane_launches}}

    out["advance_1"] = advance(configs[:1])
    out["advance_2"] = advance([configs[0], configs[2]])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--dates", type=int, default=166)
    ap.add_argument("--online-dates", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    order = ([("parent", args.parent), ("this", here), ("this", here),
              ("parent", args.parent)] if args.parent else [("this", here)])
    for label, root in order:
        root = os.path.abspath(root)
        # a fresh interpreter: the checkout's package first on sys.path,
        # this file loaded by its path for measure()
        code = ("import importlib.util, json, sys\n"
                f"sys.path.insert(0, {root!r})\n"
                "spec = importlib.util.spec_from_file_location("
                f"'lane_walls_run', {os.path.abspath(__file__)!r})\n"
                "mod = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(mod)\n"
                f"print(json.dumps(mod.measure({args.dates}, "
                f"{args.online_dates}, {args.device!r})))\n")
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(json.dumps({"run": label, **json.loads(
            proc.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
