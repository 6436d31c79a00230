"""Live covariance monitor (port of ``aprilslam_tpu/viz/monitor.py``) —
parity with src/analysis/covarience.py:19-67.

Polls a CSV's mtime and refreshes two panels: a bar chart of parameter
covariances against the translation error, and the error-over-readings
scatter. Works headless (save_path mode) or interactively. matplotlib is
imported when a figure is drawn, not with this module.
"""

from __future__ import annotations

import os
import time

from ..eval.analysis import covariance_report
from .visualizer import pyplot


def render_covariance_dashboard(
    csv_path: str,
    target: str = "Translation_Error",
    save_path: str | None = None,
    fig=None,
):
    """One refresh of the dashboard. Returns the figure."""
    rep = covariance_report(csv_path, target=target)
    import csv as _csv

    with open(csv_path) as f:
        rows = list(_csv.DictReader(f))
    errors = [float(r[target]) for r in rows if target in r]

    plt = pyplot()
    if fig is None:
        fig = plt.figure(figsize=(10, 4))
    fig.clf()
    ax1 = fig.add_subplot(121)
    names = list(rep.keys())
    ax1.bar(range(len(names)), [rep[n] for n in names])
    ax1.set_xticks(range(len(names)))
    ax1.set_xticklabels(names, rotation=60, ha="right", fontsize=7)
    ax1.set_title(f"Covariance vs {target}")
    ax2 = fig.add_subplot(122)
    ax2.scatter(range(len(errors)), errors, s=6)
    ax2.set_xlabel("reading")
    ax2.set_ylabel(target)
    ax2.set_title("Error over readings")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig


def watch(csv_path: str, target: str = "Translation_Error",
          save_path: str | None = None, poll_s: float = 0.5,
          max_iterations: int | None = None):
    """mtime-polling loop (covarience.py:37-61). Ctrl-C or max_iterations to
    stop; tolerates partial reads like the reference (retry on error)."""
    last_mtime = 0.0
    fig = None
    it = 0
    interactive = bool(os.environ.get("DISPLAY"))
    plt = pyplot()
    if interactive:
        plt.ion()
    while max_iterations is None or it < max_iterations:
        it += 1
        try:
            m = os.path.getmtime(csv_path)
            if m != last_mtime:
                last_mtime = m
                fig = render_covariance_dashboard(csv_path, target, save_path, fig)
                if interactive:
                    plt.pause(0.01)
        except (OSError, ValueError, KeyError):
            pass  # partial write; retry next poll
        time.sleep(poll_s)
    return fig
