"""Geometric synthetic sequence with analytic ground truth.

Ray-casts a procedurally-textured cube room (6 axis-aligned planes) from a
smooth camera trajectory, in closed-form numpy. Unlike `synthetic.py`'s
flat photometric pattern, frames here are views of ONE static 3D scene, so
they carry real parallax and a well-defined trajectory/depth ground truth:

  * a trajectory error against `load_gt_dict()` is meaningful;
  * exact flow/depth supervision is available without any dataset files.

The wall texture is a smooth multi-frequency function of the 3D hit point
(view-independent -> photometrically consistent across frames).
"""

from __future__ import annotations

import numpy as np


def texture_params(seed=0, n_waves=6, sharpness=0.0):
    """Random multi-scale sinusoid mixture parameters: per channel,
    n_waves (frequency vector, phase, amplitude) triples with 1/f
    amplitude falloff. seed=0 reproduces a fixed default scene.

    sharpness > 0 adds a per-wave square-wave shaping weight in
    [0, sharpness] (tanh-saturated sinusoids): the texture stays a
    world-space function (view-consistent), but gains hard edges whose
    intersections form true localizable corners — required for
    keypoint-detector self-training (smooth sinusoids have no corner
    whose sub-pixel position is even well-defined)."""
    rng = np.random.default_rng(seed)
    freq = rng.uniform(0.5, 12.0, (3, n_waves, 3)) * \
        rng.choice([-1, 1], (3, n_waves, 3))
    phase = rng.uniform(0, 2 * np.pi, (3, n_waves))
    fmag = np.linalg.norm(freq, axis=-1)
    amp = rng.uniform(0.5, 1.0, (3, n_waves)) / (1.0 + 0.4 * fmag)
    amp = 0.45 * amp / amp.sum(-1, keepdims=True)
    tex = {"freq": freq, "phase": phase, "amp": amp}
    if sharpness > 0.0:
        tex["sq"] = rng.uniform(0.0, sharpness, (3, n_waves))
    return tex


def _texture(p, tex=None):
    """(...,3) world point -> (...,3) rgb in [0,1]; smooth, multi-scale."""
    if tex is None:
        tex = texture_params(0)
    proj = np.einsum("...d,cwd->...cw", p, tex["freq"])
    waves = np.sin(proj + tex["phase"])
    sq = tex.get("sq")
    if sq is not None:
        k = 1.0 + 15.0 * sq
        waves = np.tanh(k * waves) / np.tanh(k)
    rgb = 0.5 + np.einsum("...cw,cw->...c", waves, tex["amp"])
    return np.clip(rgb, 0.0, 1.0)


def render_room(c2w, intr, h, w, room=4.0, tex=None):
    """Ray-cast the [-room, room]^3 box interior. Returns rgb (h,w,3) f32
    and depth (h,w) f32 (z-depth along the camera axis)."""
    fx, fy, cx, cy = [float(v) for v in intr]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy,
                      np.ones_like(xs, np.float64)], -1)
    R, t = c2w[:3, :3], c2w[:3, 3]
    d = d_cam @ R.T                                   # (h, w, 3)
    o = t[None, None]
    best_t = np.full((h, w), np.inf)
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            denom = d[..., axis]
            safe = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            tt = (sgn * room - o[..., axis]) / safe
            best_t = np.where((tt > 1e-6) & (tt < best_t), tt, best_t)
    pts = o + best_t[..., None] * d
    rgb = _texture(pts, tex).astype(np.float32)
    # z-depth (what the pipeline's disps parameterize), via the
    # camera-frame hit point
    p_cam = (pts - t) @ R
    depth = p_cam[..., 2].astype(np.float32)
    return rgb, depth


def trajectory_c2w(k, n, room=4.0, revs=0.6):
    """Smooth loop inside the room: circle in xz + gentle y bob + slow yaw
    following the motion direction. ~0.08 units translation per frame.
    revs = fraction of a full circle covered over the n frames; every term
    is a function of th, so revs > 1 revisits earlier poses EXACTLY —
    the long-trajectory eval uses that to trigger genuine loop closures."""
    th = 2.0 * np.pi * k / max(n, 1) * revs
    rad = 0.45 * room
    pos = np.asarray([rad * np.sin(th), 0.3 * np.sin(2.1 * th),
                      rad * np.cos(th) - 0.2 * room])
    yaw = 0.35 * np.sin(th + 0.5)
    pitch = 0.12 * np.sin(1.7 * th)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.asarray([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
    Rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    c2w = np.eye(4)
    c2w[:3, :3] = Ry @ Rx
    c2w[:3, 3] = pos
    return c2w


class Synthetic3DDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.h = int(cfg["frontend"]["image_size"][0])
        self.w = int(cfg["frontend"]["image_size"][1])
        ds = cfg["dataset"]
        self.n = int(ds.get("n_frames", 60))
        self.room = float(ds.get("room", 4.0))
        self.revs = float(ds.get("revs", 0.6))
        f = float(ds.get("focal", 0.9 * self.w))
        self.intr = np.asarray([f, f, self.w / 2, self.h / 2], np.float32)
        self.with_depth = bool(ds.get("with_depth", False))
        self.tex = texture_params(int(ds.get("tex_seed", 0)),
                                  sharpness=float(ds.get("sharpness", 0.0)))
        self.c2i = np.eye(4)

    def __len__(self):
        return self.n

    def gt_c2w(self, k):
        return trajectory_c2w(k, self.n, self.room, self.revs)

    def __getitem__(self, k):
        c2w = self.gt_c2w(k)
        rgb, depth = render_room(c2w, self.intr, self.h, self.w, self.room,
                                 tex=self.tex)
        pkt = {"timestamp": float(k), "rgb": rgb, "intrinsic": self.intr}
        if self.with_depth:
            pkt["depth"] = depth
        return pkt

    def preload_camtimestamp(self):
        return np.arange(self.n, dtype=np.float64)[:, None]

    def preload_imu(self):
        m = self.n * 100
        imu = np.zeros((m, 7))
        imu[:, 0] = np.arange(m) / 100.0
        imu[:, 6] = 9.81
        return imu

    def load_gt_dict(self):
        return {"timestamps": np.arange(self.n, dtype=np.float64),
                "c2ws": [self.gt_c2w(k) for k in range(self.n)]}


def get_dataset(cfg):
    return Synthetic3DDataset(cfg)
