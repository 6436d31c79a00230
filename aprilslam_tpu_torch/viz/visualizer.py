"""SLAM visualizers (port of ``aprilslam_tpu/viz/visualizer.py``) — parity
with the reference SLAMVisualizer (slam_visualizer.py:8-176): a 3D map/pose
scatter, a graph-structure plot, and a planar error graph. Headless-safe (Agg
backend unless a display is configured); every figure can also be saved to a
file, which is the primary mode for batch runs.

The port's ``GraphState`` is read from one CPU copy per figure. matplotlib
is imported when a visualizer is built, not with this module: the machine
with the card has none, and nothing on the card's path builds one."""

from __future__ import annotations

import os

import numpy as np

from ..slam.graph import GraphState


def pyplot():
    """matplotlib.pyplot, on the Agg backend unless a display is configured."""
    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(state: GraphState) -> dict:
    """Every field of the graph as a numpy array, one CPU copy each."""
    return {k: v.detach().cpu().numpy() for k, v in vars(state).items()}


class SlamVisualizer:
    """Renders graph state snapshots. Construct once, call update methods."""

    def __init__(self, interactive: bool | None = None):
        self._plt = plt = pyplot()
        self.interactive = bool(os.environ.get("DISPLAY")) if interactive is None else interactive
        if self.interactive:
            plt.ion()
        self._fig3d = None
        self._fig_graph = None
        self._fig_err = None

    # ------------------------------------------------------------- 3D view
    def vis_slam(
        self,
        state: GraphState,
        ground_truth: np.ndarray | None = None,
        save_path: str | None = None,
    ):
        """3D scatter of node world positions + estimate (+ GT), colour-coded
        by visible/updated — reference slam_visualizer.py:20-79."""
        if self._fig3d is None:
            self._fig3d = self._plt.figure(figsize=(7, 6))
        fig = self._fig3d
        fig.clf()
        ax = fig.add_subplot(111, projection="3d")
        g = _host(state)
        present, world, visible, updated = g["present"], g["world"], g["visible"], g["updated"]
        for i in np.nonzero(present)[0]:
            p = world[i][:3, 3]
            color = "green" if visible[i] else ("orange" if updated[i] else "red")
            ax.scatter(*p, c=color, s=60)
            ax.text(p[0], p[1], p[2], f"tag {i}", fontsize=8)
        est = g["estimated_pose"]
        if bool(g["has_estimate"]):
            ax.scatter(*est[:3, 3], c="purple", marker="^", s=80, label="estimate")
        if ground_truth is not None:
            ax.scatter(*np.asarray(ground_truth)[:3, 3], c="blue", marker="s", s=80, label="GT")
        ax.set_xlabel("X")
        ax.set_ylabel("Y")
        ax.set_zlabel("Z")
        ax.legend(loc="upper left", fontsize=8)
        ax.set_title("SLAM map (world frame = anchor tag)")
        self._finish(fig, save_path)

    # ---------------------------------------------------------- graph view
    def slam_graph(self, state: GraphState, save_path: str | None = None):
        """Graph-structure plot: nodes on a circle, edges to their chaining
        reference labelled with weights — reference slam_visualizer.py:81-112
        (networkx circular layout, reimplemented without networkx)."""
        if self._fig_graph is None:
            self._fig_graph = self._plt.figure(figsize=(6, 6))
        fig = self._fig_graph
        fig.clf()
        ax = fig.add_subplot(111)
        g = _host(state)
        present = np.nonzero(g["present"])[0]
        n = len(present)
        if n == 0:
            ax.text(0.5, 0.5, "empty graph", ha="center")
            self._finish(fig, save_path)
            return
        ang = {tid: 2 * np.pi * k / n for k, tid in enumerate(present)}
        pos = {tid: (np.cos(a), np.sin(a)) for tid, a in ang.items()}
        ref = g["reference"]
        wgt = g["weight"]
        for tid in present:
            r = int(ref[tid])
            if r in pos and r != tid:
                x0, y0 = pos[tid]
                x1, y1 = pos[r]
                ax.plot([x0, x1], [y0, y1], "k-", lw=1, alpha=0.6)
                ax.text((x0 + x1) / 2, (y0 + y1) / 2, f"{wgt[tid]:.0f}", fontsize=8, color="gray")
        for tid in present:
            x, y = pos[tid]
            anchor = tid == int(g["coordinate_id"])
            ax.scatter([x], [y], s=600, c="gold" if anchor else "lightblue",
                       edgecolors="k", zorder=3)
            ax.text(x, y, str(tid), ha="center", va="center", zorder=4)
        ax.set_xlim(-1.4, 1.4)
        ax.set_ylim(-1.4, 1.4)
        ax.set_aspect("equal")
        ax.axis("off")
        ax.set_title("SLAM graph (anchor gold)")
        self._finish(fig, save_path)

    # ------------------------------------------------------------ error view
    def error_graph(
        self,
        state: GraphState,
        gt_world_dist: dict[int, float],
        gt_local_dist: dict[int, float],
        save_path: str | None = None,
        thresholds: tuple[float, float, float] = (1.0, 2.5, 5.0),
    ):
        """Planar error graph: per-node |est - GT| distance errors vs the
        anchor ('world') and vs the camera ('local'), edges colour-coded by
        the reference's 1/2.5/5 thresholds (slam_visualizer.py:114-176)."""
        if self._fig_err is None:
            self._fig_err = self._plt.figure(figsize=(7, 5))
        fig = self._fig_err
        fig.clf()
        ax = fig.add_subplot(111)
        g = _host(state)
        present = np.nonzero(g["present"])[0]
        world = g["world"]
        local = g["local"]

        def colour(err):
            t1, t2, t3 = thresholds
            if err < t1:
                return "green"
            if err < t2:
                return "yellow"
            if err < t3:
                return "orange"
            return "red"

        for k, tid in enumerate(present):
            x = float(k)
            west = float(np.linalg.norm(world[tid][:3, 3]))
            lest = float(np.linalg.norm(local[tid][:3, 3]))
            werr = abs(west - gt_world_dist.get(int(tid), west))
            lerr = abs(lest - gt_local_dist.get(int(tid), lest))
            ax.plot([x, x], [0, 1], color=colour(werr), lw=3)
            ax.plot([x, x + 0.4], [1, 2], color=colour(lerr), lw=3)
            ax.text(x, -0.15, f"tag {tid}", ha="center", fontsize=8)
            ax.text(x, 1.05, f"w:{werr:.2f}", ha="center", fontsize=7)
            ax.text(x + 0.4, 2.05, f"l:{lerr:.2f}", ha="center", fontsize=7)
        ax.set_ylim(-0.5, 2.5)
        ax.axis("off")
        ax.set_title("Per-node distance errors (world / local)")
        self._finish(fig, save_path)

    def _finish(self, fig, save_path):
        if save_path:
            fig.savefig(save_path, dpi=110, bbox_inches="tight")
        if self.interactive:
            fig.canvas.draw_idle()
            self._plt.pause(0.001)

    def close(self):
        for f in (self._fig3d, self._fig_graph, self._fig_err):
            if f is not None:
                self._plt.close(f)
