"""Frontend monitor: per keyframe the trajectory's x/y, the attitude
(minus the ground truth's where it is given) and the gyroscope bias, drawn
as a 1x3 panel at every window rollup. It draws into a live matplotlib
window where a display exists and into a PNG (the Agg backend) where none
does."""

from __future__ import annotations

import os

import numpy as np

from .geodesy import R2ypr


class FrontendMonitor:
    def __init__(self, cfg, gt_dict=None, save_path=None, live=None):
        self.gt = gt_dict
        self.save_path = save_path or os.path.join(
            cfg.get("output", {}).get("save_dir", "output/run"),
            "monitor.png")
        self.live = bool(os.environ.get("DISPLAY")) if live is None else live
        self.t = []
        self.pos = []      # (x, y)
        self.att = []      # yaw, pitch, roll in degrees (minus the truth's)
        self.bias = []     # gyroscope bias xyz
        self._fig = None

    def _gt_at(self, t):
        ts = self.gt["timestamps"]
        k = min(np.searchsorted(ts, t), len(ts) - 1)
        return self.gt["c2ws"][k]

    def record(self, frontend):
        """Append the newest solved keyframe's state. Reading the poses
        waits for the device: the frontend calls this only when
        `frontend.show_plot` is set."""
        video = frontend.video
        k = frontend.t1 - 1
        if k < 0 or k >= video.counter:
            return
        c2w = np.asarray(video.c2w_matrices())[k]
        t = float(video.tstamps_host[k])
        att = R2ypr(c2w[:3, :3])
        if self.gt is not None:
            att = att - R2ypr(self._gt_at(t)[:3, :3])
        bg = np.zeros(3)
        if frontend.inertial is not None and \
                k < len(frontend.inertial.states):
            bg = np.asarray(frontend.inertial.states[k].b[:3])
        self.t.append(t)
        self.pos.append(c2w[:3, 3][:2].copy())
        self.att.append(np.asarray(att))
        self.bias.append(bg)

    def render(self):
        if not self.t:
            return
        import matplotlib
        if not self.live:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if self._fig is None:
            self._fig = plt.figure("monitor", figsize=(13, 4))
            if self.live:
                plt.ion()
        fig = self._fig
        fig.clf()
        pos = np.asarray(self.pos)
        att = np.asarray(self.att)
        bias = np.asarray(self.bias)

        ax = fig.add_subplot(1, 3, 1)
        ax.set_title("Trajectory")
        ax.set_aspect(1)
        ax.plot(pos[:, 0], pos[:, 1], marker="^", ms=3)

        ax = fig.add_subplot(1, 3, 2)
        ax.set_title("Attitude Error/Attitude")
        for i, c in enumerate("rgb"):
            ax.plot(self.t, att[:, i], c=c)
        if self.gt is not None:
            ax.set_ylim([-10, 10])

        ax = fig.add_subplot(1, 3, 3)
        ax.set_title("Gyroscope Bias")
        for i, c in enumerate("rgb"):
            ax.plot(self.t, bias[:, i], c=c)

        if self.live:
            plt.pause(0.1)
        else:
            os.makedirs(os.path.dirname(self.save_path) or ".",
                        exist_ok=True)
            fig.savefig(self.save_path, dpi=80)
