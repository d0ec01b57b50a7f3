"""Asset-axis layout plan for the cross-sectional stages (port of
``factormodeling_tpu/ops/_assetspec.py``; inactive by default).

When the asset axis ``N`` is sharded over a mesh
(``parallel/asset_shard.py``), every sort or quantile along it has to see
whole rows, and the data movement that gets them there is a choice. The
JAX package constrains each sort operand's sharding and lets its
partitioner move the data. The port has no partitioner and no distributed
sort, so it moves the data itself, with the collectives of
``parallel/mesh.py``, once a stage: the asset-sharded step holds the
factor stack as this rank's ``[F, D/d, N/s]`` block (``s`` ranks on the
asset axis, ``d`` on the date axis when the mesh has one), and each
cross-sectional stage turns that block into whole rows (:func:`hint`),
computes on the rows it holds, and gathers its row results back along the
dates (:meth:`AssetSpecPlan.gather_rows`). The modes differ in which rows
a rank holds, so in where the stage's compute runs and in what moves:

- ``"auto"``: the asset axis is gathered and every other axis keeps its
  sharding, the layout XLA's partitioner gives a sort along a sharded dim
  when left alone: a rank holds its date block's whole rows
  (``[D/d, N]``; ``S-1`` blocks a rank move), and the ``s`` ranks of a
  date block compute the same rows.
- ``"reshard"``: an ``all_to_all`` moves the asset axis onto the dates: a
  rank holds ``1/s`` of its date block's rows, whole (``[D/(d s), N]``;
  ``(S-1)/S`` of the block moves), so every rank computes different rows,
  and the row results are gathered over both axes. Rows that the asset
  axis does not divide have nowhere to reshard to and take ``auto``'s
  layout.
- ``"gather"``: the operand is gathered over every axis: each rank holds
  every row and computes all of them, and nothing is gathered after.

Every mode gives the stage the same rows, and each row the same values,
so the outputs agree across modes; the comms ledger (``obs/comms.py``)
charges each mode's collectives to the stage's name. With no plan
installed (the default) :func:`hint` is the identity and issues nothing.

The plan binds by STAGE NAME: the port's stages that form whole rows are
the scoring (its sort site is the rank-IC sort, ``metrics/rank_ic``) and
the blend (its sort sites are the rank transform and the pooled
percentiles, ``composite/blend``). The backtest runs on the gathered
signal on every rank, as in ``parallel/pipeline.py``'s sharded step (its
turnover day loop and its outputs need every row), so the JAX package's
``backtest/weights`` and ``solver/iterates`` sites hold whole rows already
and are no plan stage here. The chooser
(``parallel/asset_shard.choose_asset_specs``) ranks each stage's modes by
the ledger's bytes.
"""

from __future__ import annotations

from contextlib import contextmanager

__all__ = ["ASSET_SORT_STAGES", "AssetSpecPlan", "active_plan", "hint",
           "plan"]

#: the stages the asset-sharded step forms whole rows in (module docs)
ASSET_SORT_STAGES = ("metrics/rank_ic", "composite/blend")

_MODES = ("auto", "reshard", "gather")

_PLAN = None


class AssetSpecPlan:
    """One layout decision per stage (module docs).

    Args:
      mesh: the ``DeviceMesh`` carrying the asset axis.
      axis: the mesh axis name the asset dimension is sharded over.
      modes: ``{stage: mode}``; stages not listed use ``default``.
      default: mode for unlisted stages (``"auto"``).
    """

    def __init__(self, mesh, axis: str = "assets", modes=None,
                 default: str = "auto"):
        if axis not in tuple(mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no {axis!r} axis "
                             f"(axes: {tuple(mesh.mesh_dim_names or ())})")
        self.mesh = mesh
        self.axis = axis
        self.modes = dict(modes or {})
        for stage, mode in self.modes.items():
            if mode not in _MODES:
                raise ValueError(f"unknown asset-spec mode {mode!r} for "
                                 f"stage {stage!r} (expected one of "
                                 f"{_MODES})")
        if default not in _MODES:
            raise ValueError(f"unknown default mode {default!r}")
        self.default = default

    def mode_for(self, stage: str) -> str:
        return self.modes.get(stage, self.default)

    def _layout(self, stage: str, block_rows: int) -> str:
        """The mode's layout for a date block of ``block_rows`` rows
        (``reshard`` takes ``auto``'s when the asset axis does not divide
        them)."""
        from factormodeling_tpu_torch.parallel.mesh import axis_size

        mode = self.mode_for(stage)
        if mode == "reshard" and block_rows % axis_size(self.mesh,
                                                        self.axis):
            return "auto"
        return mode

    def rows(self, x, stage: str, *, sort_dim: int = -1,
             batch_dim: int = -2, batch_axis: str | None = None,
             batch_whole: bool = False):
        """This rank's rows of an operand, whole along ``sort_dim``.

        ``x`` is this rank's block: its ``sort_dim`` is the asset block of
        the plan's axis, its ``batch_dim`` (the dates) this rank's block
        along ``batch_axis`` (None: no such axis), or every date when
        ``batch_whole``. Returns the rows :meth:`row_span` names."""
        from factormodeling_tpu_torch.obs.trace import stage as obs_stage
        from factormodeling_tpu_torch.parallel.mesh import (_block,
                                                            all_gather,
                                                            all_to_all,
                                                            axis_index,
                                                            axis_size)

        m, a = self.mesh, self.axis
        sort_dim, batch_dim = sort_dim % x.ndim, batch_dim % x.ndim
        if batch_whole and batch_axis is not None:
            n = x.shape[batch_dim]
        else:
            n = x.shape[batch_dim] * axis_size(m, batch_axis)
        layout = self._layout(stage, n // axis_size(m, batch_axis))
        with obs_stage(stage):
            if layout == "gather":
                x = all_gather(x, m, a, dim=sort_dim)
                if batch_axis is not None and not batch_whole:
                    x = all_gather(x, m, batch_axis, dim=batch_dim)
                return x
            if batch_whole and batch_axis is not None:
                blk = _block(n, axis_size(m, batch_axis),
                             axis_index(m, batch_axis))
                x = x.narrow(batch_dim, blk.start, blk.stop - blk.start)
            if layout == "reshard":
                return all_to_all(x, m, a, split_dim=batch_dim,
                                  concat_dim=sort_dim)
            return all_gather(x, m, a, dim=sort_dim)

    def row_span(self, stage: str, n: int,
                 batch_axis: str | None = None) -> slice:
        """The rows of ``n`` (global date indices) :meth:`rows` leaves
        this rank."""
        from factormodeling_tpu_torch.parallel.mesh import (_block,
                                                            axis_index,
                                                            axis_size)

        m = self.mesh
        d = axis_size(m, batch_axis)
        layout = self._layout(stage, n // d)
        if layout == "gather":
            return slice(0, n)
        blk = _block(n, d, axis_index(m, batch_axis))
        if layout == "auto":
            return blk
        sub = _block(n // d, axis_size(m, self.axis),
                     axis_index(m, self.axis))
        return slice(blk.start + sub.start, blk.start + sub.stop)

    def gather_rows(self, y, stage: str, n: int, *, dim: int = 0,
                    batch_axis: str | None = None):
        """Every row of a stage's row result ``y`` (this rank's
        :meth:`row_span` along ``dim``), on every rank."""
        from factormodeling_tpu_torch.obs.trace import stage as obs_stage
        from factormodeling_tpu_torch.parallel.mesh import (all_gather,
                                                            axis_size)

        layout = self._layout(stage, n // axis_size(self.mesh, batch_axis))
        with obs_stage(stage):
            if layout == "reshard":
                y = all_gather(y, self.mesh, self.axis, dim=dim)
            if layout != "gather" and batch_axis is not None:
                y = all_gather(y, self.mesh, batch_axis, dim=dim)
        return y

    def spec_table(self) -> dict:
        """``{stage: mode}`` over :data:`ASSET_SORT_STAGES` (what the
        spec_choice rows record)."""
        return {s: self.mode_for(s) for s in ASSET_SORT_STAGES}


def active_plan():
    return _PLAN


@contextmanager
def plan(p: AssetSpecPlan | None):
    """Install ``p`` as the active plan for the block (None deactivates);
    ``parallel/asset_shard.py`` wraps each call of its step in it."""
    global _PLAN
    prev, _PLAN = _PLAN, p
    try:
        yield p
    finally:
        _PLAN = prev


def hint(x, stage: str, *, sort_dim: int = -1, batch_dim: int = -2,
         batch_axis: str | None = None, batch_whole: bool = False):
    """This rank's whole rows of the operand block ``x`` under the active
    plan's layout for ``stage`` (:meth:`AssetSpecPlan.rows`); the identity
    when no plan is active (nothing issued)."""
    if _PLAN is None:
        return x
    return _PLAN.rows(x, stage, sort_dim=sort_dim, batch_dim=batch_dim,
                      batch_axis=batch_axis, batch_whole=batch_whole)
