"""Matplotlib dashboards (port of ``factormodeling_tpu/analytics/plots.py``):
the reference's performance dashboard, factor distribution grid and
quantile-backtest panels, host-side presentation over fetched arrays.
matplotlib is imported inside each function (Agg unless a backend is set),
so importing this module needs none; figures are returned, not shown.
"""

from __future__ import annotations

import math

import numpy as np

from factormodeling_tpu_torch._device import host_array

__all__ = ["plot_full_performance", "plot_factor_distributions",
           "plot_quantile_backtests"]


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_full_performance(analyzer, counts=None):
    """The reference's multi-panel dashboard: summary table, cumulative
    total/long/short with drawdown + monthly bars, rolling MAs, turnover
    (masking turnover > 1.5 to 0 for display, ``portfolio_analyzer.py:196``),
    leg counts, rolling Sharpe. ``analyzer``: a
    :class:`~factormodeling_tpu_torch.analytics.PortfolioAnalyzer`;
    ``counts``: optional (dates, long_count, short_count)."""
    plt = _plt()
    from matplotlib.gridspec import GridSpec

    cols = analyzer.columns
    dates = analyzer.dates
    has_turnover = "turnover" in cols
    has_counts = counts is not None
    n_rows = 4 + int(has_turnover) + int(has_counts)
    heights = [0.6, 2, 0.8, 0.8] + [0.8] * (int(has_turnover) + int(has_counts))

    fig = plt.figure(figsize=(14, 4 * n_rows))
    gs = GridSpec(n_rows, 1, height_ratios=heights, hspace=0.3)

    # summary table
    ax_txt = fig.add_subplot(gs[0, :])
    ax_txt.axis("off")
    items = list(analyzer.summary().items())
    mid = len(items) // 2
    table_rows = [[lm, str(lv), rm, str(rv)]
                  for (lm, lv), (rm, rv) in zip(items[:mid], items[mid:])]
    tbl = ax_txt.table(cellText=table_rows,
                       colLabels=["Metric", "Value", "Metric", "Value"],
                       cellLoc="center", colLoc="center", loc="center")
    tbl.auto_set_font_size(False)
    tbl.set_fontsize(12)
    tbl.scale(1, 1.5)

    # cumulative returns + drawdown + monthly bars
    ax_main = fig.add_subplot(gs[1, :])
    ax_ret = ax_main.twinx()
    ax_main.plot(dates, analyzer.cumulative_return, color="black", label="Total")
    ax_main.plot(dates, analyzer.max_drawdown_curve(), color="red",
                 linestyle="--", label="Max Drawdown Curve")
    for key, style in (("long_return", dict(color="green", linestyle=":", label="Long Leg")),
                       ("short_return", dict(color="orange", linestyle="-.", label="Short Leg"))):
        if key in cols:
            cum = np.exp(np.cumsum(np.nan_to_num(cols[key]))) - 1.0
            ax_main.plot(dates, cum, **style)
    ax_main.set_ylabel("Cumulative Return")
    ax_main.set_title("Cumulative Return (Total / Long / Short) with Monthly Bars")
    ax_main.legend(loc="upper left")
    ax_main.grid(True)
    # percent axes, like the reference (portfolio_analyzer.py:154,160)
    import matplotlib.ticker as mtick

    ax_main.yaxis.set_major_formatter(mtick.PercentFormatter(xmax=1.0))
    months, mret = analyzer.monthly_return()
    ax_ret.bar(months.astype("datetime64[ns]"), mret, width=20,
               color=["green" if v >= 0 else "red" for v in mret], alpha=0.4)
    ax_ret.set_ylabel("Monthly Return", color="gray")
    ax_ret.tick_params(axis="y", labelcolor="gray")
    ax_ret.yaxis.set_major_formatter(mtick.PercentFormatter(xmax=1.0))

    # rolling MAs of daily returns
    ax_ma = fig.add_subplot(gs[2, :], sharex=ax_main)
    for w, color in ((120, "darkred"), (252, "navy")):
        ma = _rolling_mean(analyzer.log_return, w)
        ax_ma.fill_between(dates, ma, color=color, alpha=0.5, label=f"{w}d MA")
    ax_ma.set_ylabel("MA(Return)")
    ax_ma.set_title("Rolling MA of Daily Returns")
    ax_ma.legend(loc="upper left")
    ax_ma.grid(True)
    # percent y-axis + year ticks (portfolio_analyzer.py:185-190)
    import matplotlib.dates as mdates

    ax_ma.yaxis.set_major_formatter(mtick.PercentFormatter(xmax=1.0))
    ax_ma.xaxis.set_major_locator(mdates.YearLocator())
    ax_ma.xaxis.set_major_formatter(mdates.DateFormatter("%Y"))

    row = 3
    if has_turnover:
        ax_t = fig.add_subplot(gs[row, :], sharex=ax_main)
        turn = cols["turnover"].copy()
        avg = turn.mean()
        masked = np.where(turn > 1.5, 0.0, turn)
        ax_t.plot(dates, masked, color="purple", linewidth=1.2, label="Total Turnover")
        for key, color in (("long_turnover", "green"), ("short_turnover", "red")):
            if key in cols:
                leg = np.where(cols["turnover"] > 1.5, 0.0, cols[key])
                ax_t.plot(dates, leg, color=color, linestyle="--",
                          label=key.replace("_", " ").title())
        ax_t.axhline(avg, color="gray", linestyle=":", linewidth=1.2,
                     label=f"Avg: {avg:.2%}")
        ax_t.set_ylabel("Turnover")
        ax_t.set_title("Portfolio Turnover (Total / Long / Short)")
        ax_t.legend(loc="upper right")
        ax_t.grid(True)
        row += 1

    if has_counts:
        cdates, lc, sc = counts
        ax_c = fig.add_subplot(gs[row, :], sharex=ax_main)
        ax_c.plot(cdates, lc, label="Long Count", color="green")
        ax_c.plot(cdates, sc, label="Short Count", color="red")
        ax_c.set_title("Number of Symbols in Long and Short Legs Over Time")
        ax_c.set_ylabel("Count")
        ax_c.legend()
        ax_c.grid(True)
        row += 1

    ax_s = fig.add_subplot(gs[row, :], sharex=ax_main)
    for w, color in ((120, "darkred"), (252, "navy")):
        mu = _rolling_mean(analyzer.log_return, w)
        sd = _rolling_std(analyzer.log_return, w)
        ax_s.plot(dates, mu / sd * np.sqrt(252), label=f"{w}d Sharpe",
                  color=color, linewidth=1.5)
    ax_s.set_title("Rolling Sharpe Ratios")
    ax_s.set_ylabel("Sharpe")
    ax_s.set_xlabel("Date")
    ax_s.legend(loc="upper left", fontsize="small")
    ax_s.grid(True)
    return fig


def _rolling_mean(x, w):
    out = np.full(len(x), np.nan)
    if len(x) >= w:
        c = np.convolve(x, np.ones(w) / w, mode="valid")
        out[w - 1:] = c
    return out


def _rolling_std(x, w):
    """Trailing-window std (ddof=1) via cumulative sums; centering first
    keeps the sum-of-squares difference numerically stable."""
    x = np.asarray(x, dtype=np.float64)
    xc = x - x.mean()
    c1 = np.cumsum(np.concatenate([[0.0], xc]))
    c2 = np.cumsum(np.concatenate([[0.0], xc * xc]))
    s = c1[w:] - c1[:-w]
    s2 = c2[w:] - c2[:-w]
    var = np.maximum(s2 - s * s / w, 0.0) / (w - 1)
    out = np.full(len(x), np.nan)
    out[w - 1:] = np.sqrt(var)
    return out


def plot_factor_distributions(factors, names, exclude=None, bins=50, ncols=3,
                              figsize=(15, 5)):
    """Histogram grid of factor value distributions
    (``composite_factor.py:17-44``). ``factors``: [F, D, N] array."""
    plt = _plt()
    exclude = set(exclude or [])
    keep = [(i, n) for i, n in enumerate(names) if n not in exclude]
    nrows = max(math.ceil(len(keep) / ncols), 1)
    fig, axes = plt.subplots(nrows, ncols, figsize=(figsize[0], figsize[1] * nrows),
                             squeeze=False)
    flat = axes.ravel()
    for ax, (i, name) in zip(flat, keep):
        data = host_array(factors[i]).ravel()
        data = data[np.isfinite(data)]
        ax.hist(data, bins=bins, density=True, alpha=0.7)
        ax.set_title(name)
        ax.set_xlabel("Value")
        ax.set_ylabel("Density")
    for ax in flat[len(keep):]:
        ax.axis("off")
    fig.tight_layout()
    return fig


def plot_quantile_backtests(results: dict, dates, n_groups=5, ncols=2,
                            figsize=(20, 6)):
    """Cumulative bucket P&L per factor with the L1-Sn spread in black
    (``composite_factor.py:47-134``). ``results``: name ->
    :class:`~factormodeling_tpu_torch.analytics.quantile.QuantileBacktest`."""
    plt = _plt()
    names = list(results)
    nrows = max(math.ceil(len(names) / ncols), 1)
    fig, axes = plt.subplots(nrows, ncols, figsize=(figsize[0], figsize[1] * nrows),
                             squeeze=False)
    for idx, name in enumerate(names):
        ax = axes[divmod(idx, ncols)[0]][divmod(idx, ncols)[1]]
        qb = results[name]
        cum = host_array(qb.cum)
        for g in range(n_groups):
            ax.plot(dates, cum[:, g], label=str(g + 1))
        ax.plot(dates, host_array(qb.spread_cum), label=f"DN_L1-S{n_groups}",
                color="black", linewidth=2)
        ax.set_title(name)
        ax.set_xlabel("Date")
        ax.set_ylabel("Cumulative Return")
        ax.legend(loc="upper left", fontsize="small")
        ax.grid(True)
    total = nrows * ncols
    for empty_idx in range(len(names), total):
        r, c = divmod(empty_idx, ncols)
        fig.delaxes(axes[r][c])
    fig.tight_layout()
    return fig
