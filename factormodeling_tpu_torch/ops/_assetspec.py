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

The plan binds by STAGE NAME, the JAX package's five
(:data:`ASSET_SORT_STAGES`):

- ``metrics/rank_ic``: the scoring's rank-IC rows;
- ``ops/rank``: the blend's rank transform (``blend_method="rank"``);
- ``ops/quantile``: the blend's pooled percentiles and its suffix rules;
  the blend forms its rows here, and a rank transform whose mode gives
  the rank other rows moves the group proxies from these rows to its own
  (:meth:`AssetSpecPlan.relayout`), so where the two modes give a rank
  the same rows they are formed once;
- ``backtest/weights``: the leg-selection ranks of the equal and linear
  schemes, the one-day masked shift and the P&L, on the rows with their
  returns, cap, investability and universe rows;
- ``solver/iterates``: the QP schemes' solves (plain ``mvo``, the
  ``mvo_turnover`` scan), on the rows with their returns rows and a halo
  of the covariance window's rows before them.

Under a mode that splits the dates over ranks, the rows of a stage are
row blocks in date order along :meth:`AssetSpecPlan.row_axes`
(``parallel/mesh.block_index``); a stage that reads earlier rows (the
shift, the turnover, the covariance window, the turnover scan's carry)
takes them from the block before through ``parallel/mesh.permute``. The
chooser (``parallel/asset_shard.choose_asset_specs``) ranks each stage's
modes by the ledger's bytes.
"""

from __future__ import annotations

from contextlib import contextmanager

__all__ = ["ASSET_SORT_STAGES", "AssetSpecPlan", "active_plan", "hint",
           "plan"]

#: the stages the asset-sharded step forms whole rows in (module docs):
#: the JAX package's plan stages, in its order
ASSET_SORT_STAGES = ("metrics/rank_ic", "ops/rank", "ops/quantile",
                     "backtest/weights", "solver/iterates")

#: the modes' rows on one rank, nested: reshard's within auto's within
#: gather's
_NEST = {"reshard": 0, "auto": 1, "gather": 2}

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
             batch_dim: int = -2, batch_axis: str | None = None):
        """This rank's rows of an operand, whole along ``sort_dim``.

        ``x`` is this rank's block: its ``sort_dim`` is the asset block of
        the plan's axis, its ``batch_dim`` (the dates) this rank's block
        along ``batch_axis`` (None: no such axis). Returns the rows
        :meth:`row_span` names."""
        from factormodeling_tpu_torch.obs.trace import stage as obs_stage
        from factormodeling_tpu_torch.parallel.mesh import (all_gather,
                                                            all_to_all)

        m, a = self.mesh, self.axis
        sort_dim, batch_dim = sort_dim % x.ndim, batch_dim % x.ndim
        layout = self._layout(stage, x.shape[batch_dim])
        with obs_stage(stage):
            if layout == "gather":
                x = all_gather(x, m, a, dim=sort_dim)
                if batch_axis is not None:
                    x = all_gather(x, m, batch_axis, dim=batch_dim)
                return x
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

    def row_axes(self, stage: str, n: int,
                 batch_axis: str | None = None) -> tuple:
        """The mesh axes along which the rows :meth:`rows` leaves the
        ranks are blocks in date order (the first major; ``()``: every
        rank holds every row of ``n``)."""
        from factormodeling_tpu_torch.parallel.mesh import axis_size

        layout = self._layout(stage, n // axis_size(self.mesh, batch_axis))
        axes = () if batch_axis is None or layout == "gather" else (
            batch_axis,)
        return axes + ((self.axis,) if layout == "reshard" else ())

    def relayout(self, y, src: str, dst: str, n: int, *, dim: int = -2,
                 batch_axis: str | None = None):
        """Stage ``src``'s rows of ``y`` (whole along the assets, this
        rank's :meth:`row_span` of ``n`` along ``dim``) as stage ``dst``'s:
        a narrower layout slices them, a wider one gathers them (reshard's
        rows over the plan's axis, auto's over ``batch_axis``)."""
        from factormodeling_tpu_torch.obs.trace import stage as obs_stage
        from factormodeling_tpu_torch.parallel.mesh import (all_gather,
                                                            axis_size)

        d = axis_size(self.mesh, batch_axis)
        a, b = self._layout(src, n // d), self._layout(dst, n // d)
        if _NEST[b] > _NEST[a]:
            with obs_stage(dst):
                if a == "reshard":
                    y = all_gather(y, self.mesh, self.axis, dim=dim)
                if b == "gather" and batch_axis is not None:
                    y = all_gather(y, self.mesh, batch_axis, dim=dim)
            return y
        have = self.row_span(src, n, batch_axis)
        want = self.row_span(dst, n, batch_axis)
        return y.narrow(dim, want.start - have.start, want.stop - want.start)

    def to_block(self, y, stage: str, n: int, *, dim: int = -2,
                 batch_axis: str | None = None):
        """Stage ``stage``'s rows of ``y`` (whole along the last, asset,
        dim) as this rank's input block: its date block along
        ``batch_axis`` and its asset block of the plan's axis (an
        ``all_to_all`` under reshard, a slice otherwise)."""
        from factormodeling_tpu_torch.obs.trace import stage as obs_stage
        from factormodeling_tpu_torch.parallel.mesh import (_block,
                                                            all_to_all,
                                                            axis_index,
                                                            axis_size)

        m = self.mesh
        d = axis_size(m, batch_axis)
        if self._layout(stage, n // d) == "reshard":
            with obs_stage(stage):
                return all_to_all(y, m, self.axis, split_dim=-1,
                                  concat_dim=dim)
        have = self.row_span(stage, n, batch_axis)
        blk = _block(n, d, axis_index(m, batch_axis))
        cols = _block(y.shape[-1], axis_size(m, self.axis),
                      axis_index(m, self.axis))
        return y.narrow(dim, blk.start - have.start,
                        blk.stop - blk.start).narrow(
                            -1, cols.start, cols.stop - cols.start)

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
         batch_axis: str | None = None):
    """This rank's whole rows of the operand block ``x`` under the active
    plan's layout for ``stage`` (:meth:`AssetSpecPlan.rows`); the identity
    when no plan is active (nothing issued)."""
    if _PLAN is None:
        return x
    return _PLAN.rows(x, stage, sort_dim=sort_dim, batch_dim=batch_dim,
                      batch_axis=batch_axis)
