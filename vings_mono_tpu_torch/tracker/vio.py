"""Inertial fusion layer: the multi-sensor state, the multi-sensor DBA step
and the visual-inertial initialization of the original system's
MultiSensorState / multi-sensor bundle adjustment.

Division of labor: the depth-marginalized vision Hessian comes from the
device (ops.ba.ba_hessian over the fused GRU targets); everything
15-dof-per-frame (IMU preintegration, priors, marginal prior, LM) runs in
float64 on the host (tracker/factor_graph.py). After each LM solve, the
body-frame pose deltas are conjugated back to the DBA convention and applied
with ops.ba.ba_retract on the device, which also back-substitutes the
per-pixel depths.

Each outer iteration of `multi_sensor_ba` makes ONE device-to-host copy: the
free window's block of S and of v, flattened into one tensor. The
marginalization's vision factor makes one more when it runs. The layer's
writes into the video (IMU-predicted poses, the aligned trajectory and its
rescaled disparities) go into `video.bufs` in place, on the video's device.

Frame indices are window-local: they shift on rollup, and a culled
keyframe's interval merges into the previous one.

`stats` counts what a run costs: multi-sensor updates, device-to-host
copies and their bytes, the host's LM and marginalization seconds, and (on
CUDA, from events on the stream) the device milliseconds of `ba_hessian` and
of the copies.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import factor_graph as fg
from . import imu_native
from .imu import ImuParams, Preintegration, so3_log
from ..ops import ba as ba_ops
from ..ops import lie
from ..utils import geodesy

DEFAULT_NOISE = {  # the original system's hardware constants (MEMS datasheet)
    "acc_n": 0.0003924 * 25,
    "gyr_n": 0.000205689024915 * 25,
    "acc_w": 0.004905 * 10,
    "gyr_w": 0.000001454441043 * 500,
}


def _w2c_from_wTb(R_wb, p_wb, T_bc):
    T_wb = np.eye(4)
    T_wb[:3, :3] = R_wb
    T_wb[:3, 3] = p_wb
    return np.linalg.inv(T_wb @ T_bc)


class InertialFusion:
    def __init__(self, video, cfg, all_imu, c2i, all_gnss=None,
                 all_odo=None):
        self.video = video
        self.cfg = cfg
        fe = cfg["frontend"]
        noise = {**DEFAULT_NOISE, **fe.get("imu_noise", {})}
        self.params = ImuParams(noise["acc_n"], noise["gyr_n"],
                                noise["acc_w"], noise["gyr_w"])
        self.T_bc = np.asarray(c2i, np.float64)   # camera in body (Ti1c)
        self.all_imu = np.asarray(all_imu, np.float64)
        self.all_gnss = (np.zeros((0, 4)) if all_gnss is None
                         else np.asarray(all_gnss, np.float64))
        self.all_odo = (np.zeros((0, 4)) if all_odo is None
                        else np.asarray(all_odo, np.float64))
        self.imu_enabled = False

        # per-keyframe state (window-local lists)
        self.states: list[fg.FrameState] = []
        self.preints: list[Preintegration] = []   # interval i -> i+1
        self.gnss_meas: list = []
        self.odo_meas: list = []

        # factor-graph bookkeeping
        self.prior_factors = {}      # frame -> [factors]
        self.marg_prior = None
        self.last_t0 = 0
        self.last_t1 = 0
        self.cur_ii = np.zeros(0, np.int64)
        self.cur_jj = np.zeros(0, np.int64)
        self.cur_valid = np.zeros(0, bool)
        self.cur_target = None
        self.cur_weight = None
        self.cur_eta = None
        self.cur_base = 0

        # The original's [1,1,1e-4,1,1,1] is in GTSAM's rotation-first Pose3
        # tangent ordering (the 1e-4 pins YAW); this factor graph uses
        # translation-first tangents, so the yaw-gauge anchor sits in the
        # last slot here.
        self.init_pose_sigma = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1e-4])
        self.init_bias_sigma = np.full(6, 0.1)
        self.vi_init_t1 = -1
        self.vi_init_time = 1e18
        self.vi_warmup = int(fe.get("vi_warmup", 12))
        # GNSS geo-referencing + ZUPT gate
        self.zupt = bool(fe.get("zupt", False))
        self.tbg = np.asarray(fe.get("gnss_lever_arm", [0.0, 0.0, 0.0]),
                              np.float64)
        self.gnss_sigma = np.asarray(fe.get("gnss_sigma", [1.0, 1.0, 5.0]),
                                     np.float64)
        self.gnss_init_t1 = -1
        self.ten0 = None            # ECEF reference of the local frame
        self.reinit = False
        self.visual_only = cfg.get("mode", "vo") in ("vo", "vo_nerfslam")
        self.stats = {"updates": 0, "pulls": 0, "pull_bytes": 0, "lm_s": 0.0,
                      "marg_s": 0.0, "marg_pulls": 0, "hessian_ms": 0.0,
                      "pull_ms": 0.0}

    # ------------------------------------------------------------------
    # device access
    def _set_window(self, t1, w2c, scale=None):
        """poses[:t1] = w2c (numpy (t1, 4, 4)); disps[:t1] /= scale."""
        b = self.video.bufs
        w2c = torch.as_tensor(np.asarray(w2c), dtype=torch.float32,
                              device=b.poses.device)
        b.poses[:t1] = lie.se3_from_matrix(w2c)
        if scale is not None:
            b.disps[:t1] = b.disps[:t1] / scale

    def _hessian_pull(self, lo, hi, *args):
        """ba_hessian(*args, fixedp=0), then ONE device-to-host copy of its
        S[lo:hi, lo:hi] and v[lo:hi], flattened into one tensor. Returns
        (S, v) as float64 numpy and the retraction's aux. On CUDA, events
        on the stream time the Hessian and the copy."""
        cuda = args[0].is_cuda
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if cuda else None
        # the stream of the tensors' card, which need not be the current one
        stream = torch.cuda.current_stream(args[0].device) if cuda else None
        if cuda:
            ev[0].record(stream)
        S, v, aux = ba_ops.ba_hessian(*args, fixedp=0)
        S, v = S[lo:hi, lo:hi], v[lo:hi]
        flat = torch.cat([S.reshape(-1), v.reshape(-1)])
        if cuda:
            ev[1].record(stream)
        host = flat.cpu() if cuda else flat.clone()
        if cuda:
            ev[2].record(stream)
            ev[2].synchronize()
            self.stats["hessian_ms"] += ev[0].elapsed_time(ev[1])
            self.stats["pull_ms"] += ev[1].elapsed_time(ev[2])
        self.stats["pulls"] += 1
        self.stats["pull_bytes"] += flat.numel() * flat.element_size()
        host = host.numpy().astype(np.float64)
        n = S.numel()
        return host[:n].reshape(S.shape), host[n:].reshape(v.shape), aux

    # ------------------------------------------------------------------
    # state bookkeeping driven by the frontend
    def init_states(self):
        """Seed one state + preintegration per warmup keyframe."""
        n = self.video.counter
        self.states = [fg.FrameState() for _ in range(n)]
        self.preints = []
        self.gnss_meas = [None] * n
        self.odo_meas = [None] * n
        ts = self.video.tstamps_host
        for i in range(n - 1):
            self.preints.append(self._integrate_interval(ts[i], ts[i + 1]))
        self.preints.append(Preintegration(self.params))

    def _integrate_interval(self, t_a, t_b, bias=None):
        m = (self.all_imu[:, 0] >= t_a) & (self.all_imu[:, 0] < t_b)
        rows = self.all_imu[m]
        # [dt, acc(3), gyro_rad(3)] batch, closing the tail to t_b
        dts = np.diff(np.concatenate([[t_a], rows[:, 0]])) \
            if len(rows) else np.zeros(0)
        # IMU stream gaps >25 ms get the inflated "loose" noise params
        params = self.params.loose() if len(dts) and dts.max() > 0.025 \
            else self.params
        pre = Preintegration(params,
                             bg=None if bias is None else bias[:3],
                             ba=None if bias is None else bias[3:])
        if len(rows) == 0:
            return pre
        batch = np.concatenate(
            [dts[:, None], rows[:, 4:7], np.deg2rad(rows[:, 1:4])], axis=1)
        if t_b > rows[-1, 0]:
            batch = np.concatenate(
                [batch, [[t_b - rows[-1, 0], *rows[-1, 4:7],
                          *np.deg2rad(rows[-1, 1:4])]]])
        imu_native.integrate_batch(pre, batch)
        return pre

    def on_new_frame(self, t1):
        """Frame t1-1 just arrived: integrate IMU over the last interval,
        predict its state, start a fresh preintegration."""
        ts = self.video.tstamps_host
        t_prev, t_cur = ts[t1 - 2], ts[t1 - 1]
        bias = self.states[t1 - 2].b if len(self.states) >= t1 - 1 else None
        pre = self._integrate_interval(t_prev, t_cur, bias)
        # replace the placeholder for interval (t1-2 -> t1-1)
        while len(self.preints) < t1 - 1:
            self.preints.append(Preintegration(self.params))
        self.preints[t1 - 2] = pre
        s_prev = self.states[t1 - 2]
        R, p, v = pre.predict(s_prev.R, s_prev.p, s_prev.v,
                              s_prev.b[:3], s_prev.b[3:])
        new_state = fg.FrameState(R, p, v, s_prev.b.copy())
        if len(self.states) < t1:
            self.states.append(new_state)
            self.preints.append(Preintegration(self.params))
            self.gnss_meas.append(None)
            self.odo_meas.append(None)
        else:
            self.states[t1 - 1] = new_state

        self._attach_gnss_odo(t1 - 1, t_cur)

        # ZUPT: a long stationary interval with near-zero velocity pins the
        # frame with a zero body-velocity factor
        if self.zupt and t1 >= 3 and self.odo_meas[t1 - 1] is None and \
                self.preints[t1 - 3].dt > 3.0 and \
                np.linalg.norm(self.states[t1 - 2].v) < 0.025:
            self.odo_meas[t1 - 1] = np.zeros(3)

        if self.imu_enabled:
            w2c = _w2c_from_wTb(R, p, self.T_bc)
            b = self.video.bufs
            b.poses[t1 - 1] = lie.se3_from_matrix(torch.as_tensor(
                w2c, dtype=torch.float32, device=b.poses.device))
            if ts[t1 - 1] - self.vi_init_time > 5.0:
                self.reinit = True
                self.vi_init_time = 1e18

    def _attach_gnss_odo(self, i, t_cur):
        if len(self.all_gnss):
            k = np.searchsorted(self.all_gnss[:, 0], t_cur - 1e-6)
            if 0 < k < len(self.all_gnss) and \
                    self.all_gnss[k, 0] - t_cur < 0.01:
                self.gnss_meas[i] = self.all_gnss[k, 1:4]
        if len(self.all_odo):
            k = np.searchsorted(self.all_odo[:, 0], t_cur - 1e-6)
            if 0 < k < len(self.all_odo) and \
                    self.all_odo[k, 0] - t_cur < 0.01:
                self.odo_meas[i] = self.all_odo[k, 1:4]

    def on_rm_keyframe(self, ix):
        """Keyframe ix culled: merge its interval into the previous one."""
        if ix - 1 >= 0 and ix < len(self.preints):
            self.preints[ix - 1].merge_from(self.preints[ix])
        del self.preints[ix]
        del self.states[ix]
        del self.gnss_meas[ix]
        del self.odo_meas[ix]

    def on_rollup(self, n):
        self.states = self.states[n:]
        self.preints = self.preints[n:]
        self.gnss_meas = self.gnss_meas[n:]
        self.odo_meas = self.odo_meas[n:]
        self.last_t0 = max(0, self.last_t0 - n)
        self.last_t1 = max(0, self.last_t1 - n)
        self.cur_ii = self.cur_ii - n
        self.cur_jj = self.cur_jj - n
        self.cur_base = self.cur_base - n
        self.prior_factors = {k - n: v for k, v in
                              self.prior_factors.items()}
        for fs in self.prior_factors.values():
            for f in fs:
                f.i -= n
        if self.marg_prior is not None:
            self.marg_prior.rekey({k: k - n for k in
                                   self.marg_prior.frames})
        self.vi_init_t1 = max(-1, self.vi_init_t1 - n)
        if self.gnss_init_t1 > 0:
            self.gnss_init_t1 = max(1, self.gnss_init_t1 - n)

    # ------------------------------------------------------------------
    def set_prior(self, t0, t1):
        """Anchor priors on the first two window frames."""
        for i in (t0, t0 + 1):
            if i >= len(self.states):
                continue
            s = self.states[i]
            fs = [fg.PriorPoseFactor(i, s.R, s.p, self.init_pose_sigma)]
            fs.append(fg.PriorBiasFactor(i, s.b, self.init_bias_sigma))
            self.prior_factors[i] = fs
        self.last_t0 = t0
        self.last_t1 = t1

    def _imu_factors(self, lo, hi):
        return [fg.ImuFactor(i, i + 1, self.preints[i])
                for i in range(lo, hi - 1)
                if self.preints[i].dt > 0]

    def _aux_factors(self, lo, hi):
        out = []
        for i in range(lo, hi):
            if self.odo_meas[i] is not None:
                out.append(fg.VelBodyFactor(i, self.odo_meas[i],
                                            np.full(3, 2.0)))
            if self.gnss_init_t1 > 0 and self.gnss_meas[i] is not None:
                # ECEF -> local ENU, minus the antenna lever arm
                p = geodesy.ecef_to_enu(self.gnss_meas[i], self.ten0)
                p = p - self.states[i].R @ self.tbg
                out.append(fg.GpsFactor(i, p, self.gnss_sigma))
        return out

    # ------------------------------------------------------------------
    # the multi-sensor DBA step
    def multi_sensor_ba(self, target, weight, eta, ii, jj, edge_valid,
                        edges_host, base, t1, poses_win, disps_win, intr_win,
                        outer_iters=2):
        """target/weight/eta/ii/jj/edge_valid and the window tensors are
        device tensors in window coordinates (see tracker/graph.py);
        edges_host = (ii, jj, edge_valid) of the same edges as host numpy,
        so that choosing the free window reads nothing back. Returns the
        updated (poses_win, disps_win)."""
        ii_np, jj_np, ev = edges_host
        act = ev & (ii_np >= 0)
        if act.sum() == 0:
            return poses_win, disps_win
        t0 = int(min(ii_np[act].min(), jj_np[act].min())) + base
        t1 = int(t1)

        t_marg = time.perf_counter()
        self._maybe_marginalize(t0, t1)
        self.stats["marg_s"] += time.perf_counter() - t_marg
        self.stats["updates"] += 1

        x = {i: self.states[i].copy() for i in range(t0, t1)}
        frames = list(range(t0, t1))
        static_factors = self._imu_factors(t0, t1) + \
            self._aux_factors(t0, t1)
        for i in sorted(list(self.prior_factors)):
            if t0 <= i < t1:
                static_factors += self.prior_factors[i]
        if self.marg_prior is not None and \
                all(t0 <= f < t1 for f in self.marg_prior.frames):
            static_factors = static_factors + [self.marg_prior]

        # the active edges of this update, kept (live rows, on the device)
        # for the next marginalization pass
        self.cur_ii = ii_np + base
        self.cur_jj = jj_np + base
        self.cur_valid = act
        self.cur_target = target
        self.cur_weight = weight
        self.cur_eta = eta
        self.cur_base = base

        for _ in range(outer_iters):
            S_np, v_np, aux = self._hessian_pull(
                t0 - base, t1 - base, target, weight, eta, poses_win,
                disps_win, intr_win, ii, jj, edge_valid)
            t_lm = time.perf_counter()
            for d in range(6):
                S_np[0, 0, d, d] += 0.00025   # stability
            Hb, vb, A = fg.conjugate_vision_hessian(S_np, v_np, self.T_bc)
            vis = fg.QuadraticPoseFactor(frames, Hb, vb, x)
            x_new = fg.optimize(x, static_factors + [vis], frames, iters=4)

            # body deltas -> DBA camera-frame deltas, retract on the device
            dx = np.zeros((poses_win.shape[0], 6), np.float32)
            for i in frames:
                zeta = x[i].local(x_new[i])[0:6]
                dx[i - base] = (A @ zeta).astype(np.float32)
            self.stats["lm_s"] += time.perf_counter() - t_lm
            dx_dev = torch.from_numpy(dx).to(poses_win.device)
            poses_win, disps_win = ba_ops.ba_retract(
                poses_win, disps_win, dx_dev, aux, fixedp=0)
            x = x_new
        for i in frames:
            self.states[i] = x[i]
        return poses_win, disps_win

    def _maybe_marginalize(self, t0, t1):
        """Old states fall out of the active window: fold their factors into
        a dense prior."""
        if self.last_t1 == t1 and self.last_t0 == t0:
            return
        if self.last_t0 >= t0:
            self.last_t0, self.last_t1 = max(t0, self.last_t0), t1
            return
        lo, hi = self.last_t0, t0
        marg_frames = list(range(lo, hi))
        factors = []
        # vision factor over edges fully inside the marginalized band
        m = (self.cur_valid & (self.cur_ii >= lo) & (self.cur_ii < hi)
             & (self.cur_ii < self.last_t1 - 2)
             & (self.cur_jj < self.last_t1 - 2))
        if m.sum() > 0 and self.cur_target is not None:
            marg_t1 = int(self.cur_jj[m].max()) + 1
            w_ba = self.cur_eta.shape[0]
            base = self.cur_base
            b = self.video.bufs
            win = slice(base, base + w_ba)
            dev = b.poses.device
            idx = torch.from_numpy(np.stack([
                np.clip(self.cur_ii - base, 0, w_ba - 1),
                np.clip(self.cur_jj - base, 0, w_ba - 1),
                m.astype(np.int64)])).to(dev)
            S_np, v_np, _ = self._hessian_pull(
                lo - base, marg_t1 - base, self.cur_target, self.cur_weight,
                self.cur_eta, b.poses[win], b.disps[win], b.intrinsics[win],
                idx[0], idx[1], idx[2].bool())
            self.stats["marg_pulls"] += 1
            for d in range(6):
                S_np[0, 0, d, d] += 0.00025
            Hb, vb, _ = fg.conjugate_vision_hessian(S_np, v_np, self.T_bc)
            vis_frames = list(range(lo, marg_t1))
            x_all = {i: self.states[i] for i in vis_frames}
            factors.append(fg.QuadraticPoseFactor(vis_frames, Hb, vb,
                                                  x_all))
            marg_t1 = max(marg_t1, hi)
        else:
            marg_t1 = hi

        factors += self._imu_factors(lo, marg_t1)
        factors += self._aux_factors(lo, marg_t1)
        for i in sorted(list(self.prior_factors)):
            if i < t0:
                factors += self.prior_factors.pop(i)
        if self.marg_prior is not None:
            factors.append(self.marg_prior)
        x = {i: self.states[i] for i in range(lo, max(marg_t1, t1))}
        self.marg_prior = fg.marginalize(x, factors, marg_frames)
        if not self.marg_prior.frames:
            # no factor links the band to a kept frame (no vision edge
            # across it, and the band's IMU factors end inside it): the
            # prior carries no information. The JAX package keeps it and
            # fails on it in the next solve (ROADMAP.md, section C).
            self.marg_prior = None
        elif self.reinit:
            # bias covariance inflation: drop bias information
            self.marg_prior.H[9:15, :] *= 0.0
            self.marg_prior.H[:, 9:15] *= 0.0
            self.marg_prior.g[9:15] *= 0.0
            self.reinit = False
        self.last_t0, self.last_t1 = t0, t1

    # ------------------------------------------------------------------
    # VI initialization (VINS-Mono style)
    def excitation(self, t1):
        """Spread of the preintegrated mean acceleration dv/dt over the
        last 7 intervals (None with fewer than 3 usable ones): the gate of
        `maybe_initialize`."""
        vs = []
        for i in range(t1 - 8, t1 - 1):
            pre = self.preints[i]
            if pre.dt > 0:
                vs.append(pre.dv / pre.dt)
        if len(vs) < 3:
            return None
        vs = np.asarray(vs)
        return math.sqrt(np.mean(np.sum((vs - vs.mean(0)) ** 2, axis=1)))

    def maybe_initialize(self, t1):
        if self.vi_init_t1 >= 0 or t1 <= self.vi_warmup:
            return
        var_g = self.excitation(t1)
        if var_g is None:
            return
        if var_g < 0.25:
            self.video.visual_only_init = True
            self.set_prior(self.last_t0, t1)
            return
        self.visual_imu_alignment(max(t1 - 8, 0), t1, ignore_lever=True)
        self.visual_imu_alignment(max(t1 - 8, 0), t1, ignore_lever=False)
        if not self.visual_only:
            self.imu_enabled = True
            self.video.imu_enabled = True
        else:
            self.video.visual_only_init = True
        self.set_prior(self.last_t0, t1)
        self.vi_init_t1 = t1
        self.vi_init_time = self.video.tstamps_host[t1 - 1]

    def maybe_init_gnss(self, t1):
        """Geo-reference the VIO frame against the GNSS track once IMU
        fusion is live: estimate heading + metric scale from the first/last
        GNSS fixes in the recent window, then rotate/scale every state,
        camera pose and disparity into the local ENU frame. The ECEF
        reference is the first GNSS fix."""
        if not self.imu_enabled or self.gnss_init_t1 > 0 or \
                len(self.all_gnss) == 0:
            return False
        idx = [i for i in range(max(0, t1 - 10), t1)
               if self.gnss_meas[i] is not None]
        if len(idx) < 2:
            return False
        if self.ten0 is None:
            self.ten0 = np.asarray(self.gnss_meas[idx[0]], np.float64)
        tn0 = np.asarray([geodesy.ecef_to_enu(self.gnss_meas[i], self.ten0)
                          for i in idx])
        tw = np.asarray([self.states[i].p for i in idx])
        if np.linalg.norm(tn0[-1] - tn0[0]) < 10.0:
            return False                      # baseline too short
        heading_w = math.atan2(tw[-1, 1] - tw[0, 1], tw[-1, 0] - tw[0, 0])
        heading_n0 = math.atan2(tn0[-1, 1] - tn0[0, 1],
                                tn0[-1, 0] - tn0[0, 0])
        s = np.linalg.norm(tn0[-1] - tn0[0]) / \
            max(np.linalg.norm(tw[-1] - tw[0]), 1e-9)
        dh = heading_n0 - heading_w
        Rn0w = np.array([[math.cos(dh), -math.sin(dh), 0.0],
                         [math.sin(dh), math.cos(dh), 0.0],
                         [0.0, 0.0, 1.0]])
        # anchor so the first GNSS frame lands on its ENU fix
        t_off = tn0[0] - Rn0w @ (tw[0] * s)

        for i in range(t1):
            st = self.states[i]
            self.states[i] = fg.FrameState(
                Rn0w @ st.R, Rn0w @ (st.p * s) + t_off, Rn0w @ (st.v * s),
                st.b)

        # write transformed camera poses + rescaled disparities back
        wTbs = np.stack([np.eye(4)] * t1)
        for i in range(t1):
            wTbs[i, :3, :3] = self.states[i].R
            wTbs[i, :3, 3] = self.states[i].p
        self._set_window(t1, np.linalg.inv(wTbs @ self.T_bc[None]), scale=s)

        # the marginal prior's linearization states are in the pre-transform
        # frame; keeping it would pull states back toward the old
        # heading/scale. Drop it; it re-accumulates on the next
        # marginalization.
        self.marg_prior = None
        self.gnss_init_t1 = t1
        self.set_prior(self.last_t0, t1)
        return True

    def _wTbs_from_video(self, t1, ignore_lever):
        w2c = lie.se3_matrix(self.video.bufs.poses[:t1]).cpu().numpy() \
            .astype(np.float64)
        wTc = np.linalg.inv(w2c)
        Tcb = np.linalg.inv(self.T_bc)
        if ignore_lever:
            Tcb = Tcb.copy()
            Tcb[0:3, 3] = 0.0
        return wTc @ Tcb[None]

    def visual_imu_alignment(self, t0, t1, ignore_lever=True,
                             disable_scale=False):
        """Gyro-bias solve -> linear alignment -> gravity refinement ->
        scale/gravity application (VINS-Mono initialization)."""
        wTbs = self._wTbs_from_video(t1, ignore_lever)

        # --- solve gyroscope bias from rotation-only residuals
        A = np.zeros((3, 3))
        b = np.zeros(3)
        for i in range(t0, t1 - 1):
            pre = self.preints[i]
            if pre.dt <= 0:
                continue
            Rij = wTbs[i, :3, :3].T @ wTbs[i + 1, :3, :3]
            r = so3_log(pre.dR.T @ Rij)
            J = pre.J_Rbg
            A += J.T @ J
            b += J.T @ r
        bg = np.linalg.solve(A + np.eye(3) * 1e-8, b)

        # re-integrate everything at the new gyro bias (the numpy loop, as
        # the JAX package does here)
        for i in range(0, t1 - 1):
            old = self.preints[i]
            pre = Preintegration(self.params, bg=bg)
            for acc, gyro, dt in old.meas:
                pre.integrate(acc, gyro, dt)
            self.preints[i] = pre
        for i in range(0, t1):
            self.states[i].b = np.concatenate([bg, np.zeros(3)])

        # --- linear alignment for velocities, gravity, scale
        F = t1 - t0
        n = F * 3 + 3 + 1
        A = np.zeros((n, n))
        b = np.zeros(n)
        for k, i in enumerate(range(t0, t1 - 1)):
            pre = self.preints[i]
            dt = pre.dt
            Ri = wTbs[i, :3, :3]
            Rj = wTbs[i + 1, :3, :3]
            ti = wTbs[i, :3, 3]
            tj = wTbs[i + 1, :3, 3]
            tA = np.zeros((6, 10))
            tb = np.zeros(6)
            tA[0:3, 0:3] = -dt * np.eye(3)
            tA[0:3, 6:9] = Ri.T * dt * dt / 2
            tA[0:3, 9] = Ri.T @ (tj - ti) / 100.0
            tb[0:3] = pre.dp
            tA[3:6, 0:3] = -np.eye(3)
            tA[3:6, 3:6] = Ri.T @ Rj
            tA[3:6, 6:9] = Ri.T * dt
            tb[3:6] = pre.dv
            rA = tA.T @ tA
            rb = tA.T @ tb
            s0 = k * 3
            A[s0:s0 + 6, s0:s0 + 6] += rA[0:6, 0:6]
            b[s0:s0 + 6] += rb[0:6]
            A[-4:, -4:] += rA[-4:, -4:]
            b[-4:] += rb[-4:]
            A[s0:s0 + 6, -4:] += rA[0:6, -4:]
            A[-4:, s0:s0 + 6] += rA[-4:, 0:6]
        x = np.linalg.solve(A * 1000.0 + np.eye(n) * 1e-8, b * 1000.0)
        g = x[-4:-1]
        s = x[-1] / 100.0

        # --- refine gravity on its 2-dof tangent
        g0 = g / max(np.linalg.norm(g), 1e-9) * 9.81
        n = F * 3 + 2 + 1
        for _ in range(4):
            aa = g0 / np.linalg.norm(g0)
            tmp = np.array([0.0, 0.0, 1.0])
            bb = tmp - (aa @ tmp) * aa
            bb /= max(np.linalg.norm(bb), 1e-9)
            cc = np.cross(aa, bb)
            lxly = np.stack([bb, cc], axis=1)
            A = np.zeros((n, n))
            b = np.zeros(n)
            for k, i in enumerate(range(t0, t1 - 1)):
                pre = self.preints[i]
                dt = pre.dt
                Ri = wTbs[i, :3, :3]
                Rj = wTbs[i + 1, :3, :3]
                ti = wTbs[i, :3, 3]
                tj = wTbs[i + 1, :3, 3]
                tA = np.zeros((6, 9))
                tb = np.zeros(6)
                tA[0:3, 0:3] = -dt * np.eye(3)
                tA[0:3, 6:8] = Ri.T @ lxly * dt * dt / 2
                tA[0:3, 8] = Ri.T @ (tj - ti) / 100.0
                tb[0:3] = pre.dp - Ri.T @ g0 * dt * dt / 2
                tA[3:6, 0:3] = -np.eye(3)
                tA[3:6, 3:6] = Ri.T @ Rj
                tA[3:6, 6:8] = Ri.T @ lxly * dt
                tb[3:6] = pre.dv - Ri.T @ g0 * dt
                rA = tA.T @ tA
                rb = tA.T @ tb
                s0 = k * 3
                A[s0:s0 + 6, s0:s0 + 6] += rA[0:6, 0:6]
                b[s0:s0 + 6] += rb[0:6]
                A[-3:, -3:] += rA[-3:, -3:]
                b[-3:] += rb[-3:]
                A[s0:s0 + 6, -3:] += rA[0:6, -3:]
                A[-3:, s0:s0 + 6] += rA[-3:, 0:6]
            x = np.linalg.solve(A * 1000.0 + np.eye(n) * 1e-8, b * 1000.0)
            g0 = g0 + lxly @ x[-3:-1]
            g0 = g0 / np.linalg.norm(g0) * 9.81
            s = x[-1] / 100.0

        if disable_scale:
            s = 1.0
        if s <= 0:
            return False

        # --- apply scale, rotate gravity to -z, write back states + video
        wTbs[:, 0:3, 3] *= s
        vels = np.zeros((t1, 3))
        for k, i in enumerate(range(t0, t1)):
            vels[i] = wTbs[i, 0:3, 0:3] @ x[k * 3:k * 3 + 3] \
                if k * 3 + 3 <= F * 3 else vels[i - 1]

        ng1 = g0 / np.linalg.norm(g0)
        ng2 = np.array([0.0, 0.0, 1.0])
        # rotation taking measured gravity direction to +z, yaw-free
        vcross = np.cross(ng1, ng2)
        c = float(ng1 @ ng2)
        K = np.array([[0, -vcross[2], vcross[1]],
                      [vcross[2], 0, -vcross[0]],
                      [-vcross[1], vcross[0], 0]])
        R0 = np.eye(3) + K + K @ K / max(1 + c, 1e-9)
        yaw = math.atan2(R0[1, 0], R0[0, 0])
        Ry = np.array([[math.cos(-yaw), -math.sin(-yaw), 0],
                       [math.sin(-yaw), math.cos(-yaw), 0], [0, 0, 1]])
        R0 = Ry @ R0

        for i in range(0, t1):
            wTbs[i, 0:3, 3] = R0 @ wTbs[i, 0:3, 3]
            wTbs[i, 0:3, 0:3] = R0 @ wTbs[i, 0:3, 0:3]
            vels[i] = R0 @ vels[i]
            self.states[i] = fg.FrameState(wTbs[i, :3, :3], wTbs[i, :3, 3],
                                           vels[i], self.states[i].b)

        # write scaled/rotated camera poses + scaled disparities back
        Tbc = self.T_bc.copy()
        if ignore_lever:
            Tbc[0:3, 3] = 0.0
        self._set_window(t1, np.linalg.inv(wTbs @ Tbc[None]), scale=s)
        return True
