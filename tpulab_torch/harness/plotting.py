"""Benchmark bar charts (the reference's ``median_execution_time.png``).

Grouped median kernel times by (device, kernel_size) with a sample-count
and metadata legend — the reference chart layout (tester.py:325-407).
matplotlib is imported inside the function: the package imports without
it, and the tester skips the chart where it is missing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from tpulab_torch.harness.tester import summarize


def plot_median_times(
    rows: Sequence[Dict[str, Any]],
    out_path: str,
    metadata_columns: Optional[List[str]] = None,
    title: str = "Median kernel execution time",
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    med = [s for s in summarize(rows) if s["count"]]
    labels = [f"{s['device']}\n{s['kernel_size']}" for s in med]
    colors = ["tab:orange" if s["device"] == "CPU" else "tab:blue" for s in med]

    fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(labels)), 4.5))
    bars = ax.bar(range(len(med)), [s["median"] for s in med], color=colors)
    ax.set_xticks(range(len(med)))
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_ylabel("median kernel time, ms")
    ax.set_title(title)
    ax.set_yscale("log")
    for rect, s in zip(bars, med):
        ax.annotate(
            f"{s['median']:.5f}\nn={s['count']}",
            (rect.get_x() + rect.get_width() / 2, rect.get_height()),
            ha="center",
            va="bottom",
            fontsize=7,
        )
    legend_lines = []
    for col in metadata_columns or []:
        vals = sorted({str(r[col]) for r in rows if r.get(col) is not None})[:6]
        if vals:
            legend_lines.append(f"{col}: {', '.join(vals)}")
    if legend_lines:
        ax.text(
            0.99,
            0.98,
            "\n".join(legend_lines),
            transform=ax.transAxes,
            ha="right",
            va="top",
            fontsize=7,
            bbox=dict(boxstyle="round", alpha=0.15),
        )
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
