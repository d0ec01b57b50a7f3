"""The tenant research configuration: per-tenant knobs as value leaves,
program-shaping residue as static fields (port of
``factormodeling_tpu/serve/tenant.py``, not its ``mesh_key``).

- **value leaves**: knobs that enter the computation as VALUES (the top-k
  count, the ICIR threshold, a manager-mix weight vector over the factor
  books, a per-prefix-group blend tilt, the simulation's ``max_weight`` /
  ``pct`` / ``shrinkage_intensity`` / ``turnover_penalty`` /
  ``return_weight``, a t-cost rate scale). Python numbers, numpy values or
  0-d tensors; the vectors numpy arrays or tensors.
- **static residue**: knobs that change the PROGRAM (the weight scheme, the
  window, the selector and blend methods, the qp/covariance knobs). They
  form :meth:`TenantConfig.static_key`; configs sharing it form one
  signature bucket.

The optional vector leaves (``manager_mix``, ``blend_tilt``) join the
static key by PRESENCE.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["TenantConfig", "config_leaves", "mesh_key", "stack_configs"]

#: weight schemes a tenant may request (SimulationSettings.method)
_METHODS = ("equal", "linear", "mvo", "mvo_turnover")
_BLENDS = ("zscore", "rank")
#: per-tenant traced knobs + panel/market fields: a ``sim_static`` entry
#: under one of these names would silently shadow the traced leaf (or the
#: server's panels) with a per-bucket constant — rejected at validation
_VALUE_LEAVES = ("top_k", "icir_threshold", "manager_mix", "blend_tilt",
                 "max_weight", "pct", "shrinkage_intensity",
                 "turnover_penalty", "return_weight", "tcost_scale")
_RESERVED_SIM_KEYS = frozenset({
    "returns", "cap_flag", "investability_flag", "universe", "degrade",
    "method", "max_weight", "pct", "shrinkage_intensity",
    "turnover_penalty", "return_weight", "tcost_scale", "lookback_period",
})


def config_leaves(config) -> list:
    """A config's value leaves as host arrays, in the JAX package's pytree
    order (None leaves absent): what its fingerprints hash."""
    return [np.asarray(getattr(config, name)) for name in _VALUE_LEAVES
            if getattr(config, name) is not None]


def _sim_settings_cls():
    # imported lazily: the settings import pulls the backtest package only
    # when a config carries sim_static extras to check
    from factormodeling_tpu_torch.backtest.settings import SimulationSettings

    return SimulationSettings


def _host(name, v) -> np.ndarray:
    """A leaf as a host array for validation; a tensor on the card is
    refused (validation reads host-concrete configs only)."""
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu":
            raise ValueError(f"{name} is a tensor on {v.device}; validation "
                             f"reads host-concrete configs only")
        return v.numpy()
    return np.asarray(v)


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's research configuration (see module docs).

    Scalar leaf defaults reproduce the repo's single-config defaults
    (``icir_top`` at ``top_x=5``/``icir_threshold=0.03``,
    ``SimulationSettings`` at ``max_weight=0.03``/``pct=0.1``/...), so a
    default config matches a default
    :func:`~factormodeling_tpu_torch.parallel.build_research_step` run.
    """

    # ---- value leaves (Python numbers, numpy values or 0-d tensors) ----
    # top-k selection count: drives `rank_of < top_k` in icir_top_selector
    top_k: Any = 5
    icir_threshold: Any = 0.03
    # [F] manager-mix weights: how the tenant splits capital among the
    # day's SELECTED factor books (selection * mix, row-renormalized by
    # the selection step) — the multimanager combination applied at the
    # factor-weight level. None = equal split, the reference behavior.
    manager_mix: Any = None
    # [G] per-prefix-group blend tilt (composite_weighted's group_tilt);
    # None = untilted
    blend_tilt: Any = None
    max_weight: Any = 0.03
    pct: Any = 0.1
    shrinkage_intensity: Any = 0.1
    turnover_penalty: Any = 0.1
    return_weight: Any = 0.0
    # one-way t-cost rate scale on the cap-tier table (1.0 = reference)
    tcost_scale: Any = 1.0

    # ---- static residue (the signature bucket) ----
    method: str = "equal"
    window: int = 20
    select_method: str = "icir_top"
    blend_method: str = "zscore"
    use_rank_icir: bool = True
    lookback_period: int = 60
    # extra static selector kwargs (non-icir methods) and extra static
    # SimulationSettings knobs (qp_*, covariance, turnover_mode, ...),
    # as sorted (key, value) tuples — dicts are accepted and normalized
    select_static: tuple = ()
    sim_static: tuple = ()

    def __post_init__(self):
        for name in ("select_static", "sim_static"):
            v = getattr(self, name)
            if isinstance(v, dict):
                v = tuple(sorted(v.items()))
                object.__setattr__(self, name, v)
            elif not isinstance(v, tuple):
                raise ValueError(f"{name} must be a dict or a tuple of "
                                 f"(key, value) pairs, got {type(v).__name__}")
        if self.method not in _METHODS:
            raise ValueError(f"Unknown method {self.method!r} "
                             f"(expected one of {_METHODS})")
        if self.blend_method not in _BLENDS:
            raise ValueError(f"Unknown blend_method {self.blend_method!r}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        bad = _RESERVED_SIM_KEYS.intersection(k for k, _ in self.sim_static)
        if bad:
            raise ValueError(
                f"sim_static keys {sorted(bad)} shadow per-tenant traced "
                f"knobs or market panels — set them through the "
                f"TenantConfig field instead")
        # every sim_static key must be a real SimulationSettings field:
        # a typo would otherwise sail past the front end's validation and
        # explode as a raw TypeError at dispatch, AFTER other buckets may
        # have dispatched — breaking the rejected-before-compile contract
        if self.sim_static:
            sim_fields = {f.name for f in
                          dataclasses.fields(_sim_settings_cls())}
            unknown = [k for k, _ in self.sim_static if k not in sim_fields]
            if unknown:
                raise ValueError(
                    f"sim_static keys {unknown} are not SimulationSettings "
                    f"fields (known extras include qp_iters, qp_rho, "
                    f"qp_anderson, qp_polish, qp_warm_start, solver_kernel, "
                    f"mvo_batch, covariance, risk_*, turnover_*)")
        # cheap host-scalar checks here; the full shape-aware validation
        # is validate(). Leaf values beyond plain python/numpy scalars
        # (tensors) are left to validate().
        k = self.top_k
        if isinstance(k, (bool, np.bool_)):
            raise ValueError(f"top_k must be an integer count, got {k!r}")
        if isinstance(k, (float, np.floating)):
            if k != int(k):
                raise ValueError(f"top_k must be an integer count, "
                                 f"got {k!r}")
            k = int(k)
        if isinstance(k, (int, np.integer)) and k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k!r}")

    # ------------------------------------------------------------ buckets

    def static_key(self) -> tuple:
        """The program-shaping residue: configs sharing this key run the
        same program (one signature bucket). Optional vector leaves
        contribute their PRESENCE."""
        return (self.method, self.window, self.select_method,
                self.blend_method, self.use_rank_icir, self.lookback_period,
                self.select_static, self.sim_static,
                self.manager_mix is not None, self.blend_tilt is not None)

    # --------------------------------------------------------- validation

    def validate(self, n_factors: int, n_groups: int | None = None,
                 n_dates: int | None = None) -> None:
        """Reject an invalid config with a clear ValueError before anything
        runs. Tensors on the card cannot be validated and raise: validation
        reads host-concrete configs only."""

        concrete = _host

        k = concrete("top_k", self.top_k)
        if k.ndim != 0:
            raise ValueError(f"top_k must be a scalar count, got shape "
                             f"{k.shape}")
        if int(k) < 1:
            raise ValueError(f"top_k must be >= 1, got {int(k)}")
        if self.select_method == "icir_top" and int(k) > n_factors:
            # only the rank-mask selector consumes top_k; other selectors
            # ignore it, so the factor-count bound would reject the
            # DEFAULT config for no reason
            raise ValueError(f"top_k must be in [1, {n_factors}] "
                             f"(the factor count), got {int(k)}")
        for name, lo, hi in (("icir_threshold", None, None),
                             ("max_weight", 0.0, None),
                             ("pct", 0.0, 1.0),
                             ("shrinkage_intensity", 0.0, 1.0),
                             ("turnover_penalty", 0.0, None),
                             ("return_weight", None, None),
                             ("tcost_scale", 0.0, None)):
            v = concrete(name, getattr(self, name))
            if v.ndim != 0 or not np.isfinite(v):
                raise ValueError(f"{name} must be a finite scalar, "
                                 f"got {getattr(self, name)!r}")
            v = float(v)
            if lo is not None and v < lo:
                raise ValueError(f"{name} must be >= {lo}, got {v}")
            if hi is not None and v > hi:
                raise ValueError(f"{name} must be <= {hi}, got {v}")
        if float(concrete("max_weight", self.max_weight)) == 0.0:
            raise ValueError("max_weight must be > 0")
        if float(concrete("pct", self.pct)) == 0.0:
            raise ValueError("pct must be > 0")
        for name, size in (("manager_mix", n_factors),
                           ("blend_tilt", n_groups)):
            v = getattr(self, name)
            if v is None:
                continue
            v = concrete(name, v)
            if size is not None and v.shape != (size,):
                raise ValueError(f"{name} must have shape ({size},), "
                                 f"got {v.shape}")
            if not np.all(np.isfinite(v)) or np.any(v < 0):
                raise ValueError(f"{name} must be finite and >= 0")
            if not np.any(v > 0):
                raise ValueError(f"{name} must have at least one positive "
                                 f"entry (an all-zero {name} selects "
                                 f"nothing every day)")
        if n_dates is not None and self.window >= n_dates:
            raise ValueError(
                f"window {self.window} >= {n_dates} dates: the processed "
                f"range dates[window:-1] is empty, nothing would be served")

    # ------------------------------------------------------ normalization

    def normalized(self, n_factors: int, n_groups: int,
                   dtype=np.float64) -> "TenantConfig":
        """Leaves as uniform host numpy values (``top_k`` -> int32, floats
        -> ``dtype``, vectors shape-checked), so same-bucket configs stack
        into one batch with :func:`stack_configs`."""
        def f(v):
            return np.asarray(_host("leaf", v), dtype=dtype)

        def vec(v, size, name):
            if v is None:
                return None
            v = np.asarray(_host(name, v), dtype=dtype)
            if v.shape != (size,):
                raise ValueError(f"{name} must have shape ({size},), "
                                 f"got {v.shape}")
            return v

        return dataclasses.replace(
            self,
            top_k=np.asarray(self.top_k, dtype=np.int32),
            icir_threshold=f(self.icir_threshold),
            manager_mix=vec(self.manager_mix, n_factors, "manager_mix"),
            blend_tilt=vec(self.blend_tilt, n_groups, "blend_tilt"),
            max_weight=f(self.max_weight), pct=f(self.pct),
            shrinkage_intensity=f(self.shrinkage_intensity),
            turnover_penalty=f(self.turnover_penalty),
            return_weight=f(self.return_weight),
            tcost_scale=f(self.tcost_scale))


def mesh_key(mesh) -> tuple:
    """Hashable placement descriptor of a mesh, for the cache keys of
    built steps: the axis names, the per-axis sizes, the rank grid (one
    rank a device, flattened) and the device type. The same config on
    another mesh runs other collectives on other groups, so the mesh joins
    :meth:`TenantConfig.static_key` wherever steps are cached (the
    server's ``_entry_key``). ``None`` (the unsharded server) keys as
    ``()``, so unsharded keys are unchanged."""
    if mesh is None:
        return ()
    return (tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.shape),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()),
            str(mesh.device_type))


def stack_configs(configs) -> TenantConfig:
    """Stack same-bucket configs into one batched config: every value leaf
    gains a leading config axis ``C`` (numpy). Configs must already be
    :meth:`TenantConfig.normalized` (uniform leaf dtypes/shapes) and share
    one :meth:`~TenantConfig.static_key`."""
    configs = list(configs)
    if not configs:
        raise ValueError("cannot stack an empty config list")
    keys = {c.static_key() for c in configs}
    if len(keys) > 1:
        raise ValueError(
            f"configs span {len(keys)} signature buckets; stack one "
            f"bucket at a time (the front end partitions by static_key)")
    first = configs[0]
    return dataclasses.replace(first, **{
        name: (None if getattr(first, name) is None
               else np.stack([getattr(c, name) for c in configs]))
        for name in _VALUE_LEAVES})
