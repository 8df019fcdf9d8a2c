"""IMU preintegration (Forster combined model) in float64 numpy.

Replaces gtsam.PreintegratedCombinedMeasurements. The window factor graph
is tiny (<= 25 frames x 15 dof), so it lives on the host in double
precision; the device does the dense vision part. numpy only: a copy of the
JAX package's `tracker/imu.py`, so that the port imports nothing of it.

State between keyframes i -> j (body frame of i):
  dR (3x3), dv, dp, dt, bias linearization point (bg, ba),
  bias Jacobians J_Rbg, J_vbg, J_vba, J_pbg, J_pba,
  15x15 covariance over [phi, v, p, bg, ba].

Residual of the combined factor (15,) over (Ti, vi, bi, Tj, vj, bj):
  r_R = Log( (dR Exp(J_Rbg dbg))^T Ri^T Rj )
  r_v = Ri^T (vj - vi - g dt)            - (dv + J_vbg dbg + J_vba dba)
  r_p = Ri^T (pj - pi - vi dt - .5 g t^2) - (dp + J_pbg dbg + J_pba dba)
  r_b = bj - bi
Analytic Jacobians are exercised against finite differences in
tests/test_imu.py.
"""

from __future__ import annotations

import numpy as np

GRAVITY = np.array([0.0, 0.0, -9.81])


def skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                     [-v[1], v[0], 0]], np.float64)


def so3_exp(phi):
    th = np.linalg.norm(phi)
    K = skew(phi)
    if th < 1e-8:
        return np.eye(3) + K + 0.5 * K @ K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th**2 * K @ K)


def so3_log(R):
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-8:
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]]) * 0.5
        return w
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def right_jacobian(phi):
    th = np.linalg.norm(phi)
    K = skew(phi)
    if th < 1e-8:
        return np.eye(3) - 0.5 * K + K @ K / 6.0
    return (np.eye(3) - (1 - np.cos(th)) / th**2 * K
            + (th - np.sin(th)) / th**3 * K @ K)


def right_jacobian_inv(phi):
    th = np.linalg.norm(phi)
    K = skew(phi)
    if th < 1e-8:
        return np.eye(3) + 0.5 * K + K @ K / 12.0
    return (np.eye(3) + 0.5 * K
            + (1 / th**2 - (1 + np.cos(th)) / (2 * th * np.sin(th)))
            * K @ K)


class ImuParams:
    """Continuous-time noise densities; the loose variant is the original
    system's handling of gaps in the IMU stream."""

    def __init__(self, acc_n=0.1, gyr_n=0.01, acc_w=1e-3, gyr_w=1e-4,
                 integration_n=1e-4, gravity=GRAVITY):
        self.acc_n = acc_n
        self.gyr_n = gyr_n
        self.acc_w = acc_w
        self.gyr_w = gyr_w
        self.integration_n = integration_n
        self.g = np.asarray(gravity, np.float64)

    def loose(self, factor=100.0):
        # The original system scales the noise COVARIANCE by `factor`; the
        # propagation squares the sigmas, so the sigmas scale by
        # sqrt(factor).
        s = float(np.sqrt(factor))
        return ImuParams(self.acc_n * s, self.gyr_n * s,
                         self.acc_w, self.gyr_w, self.integration_n, self.g)


class Preintegration:
    def __init__(self, params: ImuParams, bg=None, ba=None):
        self.params = params
        self.bg = np.zeros(3) if bg is None else np.asarray(bg, np.float64)
        self.ba = np.zeros(3) if ba is None else np.asarray(ba, np.float64)
        self.reset()

    def reset(self):
        self.dR = np.eye(3)
        self.dv = np.zeros(3)
        self.dp = np.zeros(3)
        self.dt = 0.0
        self.J_Rbg = np.zeros((3, 3))
        self.J_vbg = np.zeros((3, 3))
        self.J_vba = np.zeros((3, 3))
        self.J_pbg = np.zeros((3, 3))
        self.J_pba = np.zeros((3, 3))
        self.cov = np.zeros((15, 15))   # [phi, v, p, bg, ba]
        self.meas = []                  # (acc, gyro, dt) log for re-integ.

    def integrate(self, acc, gyro, dt, record=True):
        if dt <= 0:
            return
        acc = np.asarray(acc, np.float64) - self.ba
        gyro = np.asarray(gyro, np.float64) - self.bg
        if record:
            self.meas.append((np.asarray(acc + self.ba),
                              np.asarray(gyro + self.bg), float(dt)))

        dRk = self.dR
        w_dt = gyro * dt
        dR_inc = so3_exp(w_dt)
        Jr = right_jacobian(w_dt)
        a_hat = skew(acc)

        # bias jacobians BEFORE state update (use current dR)
        self.J_pba += self.J_vba * dt - 0.5 * dRk * dt**2
        self.J_pbg += self.J_vbg * dt - 0.5 * dRk @ a_hat @ self.J_Rbg \
            * dt**2
        self.J_vba += -dRk * dt
        self.J_vbg += -dRk @ a_hat @ self.J_Rbg * dt
        self.J_Rbg = dR_inc.T @ self.J_Rbg - Jr * dt

        # covariance propagation [phi, v, p, bg, ba]
        A = np.eye(15)
        A[0:3, 0:3] = dR_inc.T
        A[0:3, 9:12] = -Jr * dt
        A[3:6, 0:3] = -dRk @ a_hat * dt
        A[3:6, 12:15] = -dRk * dt
        A[6:9, 0:3] = -0.5 * dRk @ a_hat * dt**2
        A[6:9, 3:6] = np.eye(3) * dt
        A[6:9, 12:15] = -0.5 * dRk * dt**2
        B = np.zeros((15, 12))          # noise [gyr, acc, bgw, baw]
        B[0:3, 0:3] = Jr * dt
        B[3:6, 3:6] = dRk * dt
        B[6:9, 3:6] = 0.5 * dRk * dt**2
        B[9:12, 6:9] = np.eye(3)
        B[12:15, 9:12] = np.eye(3)
        p = self.params
        Q = np.diag(np.concatenate([
            np.full(3, p.gyr_n**2 / dt),
            np.full(3, p.acc_n**2 / dt),
            np.full(3, p.gyr_w**2 * dt),
            np.full(3, p.acc_w**2 * dt)]))
        self.cov = A @ self.cov @ A.T + B @ Q @ B.T
        self.cov[6:9, 6:9] += np.eye(3) * p.integration_n**2 * dt

        # state update
        self.dp = self.dp + self.dv * dt + 0.5 * dRk @ acc * dt**2
        self.dv = self.dv + dRk @ acc * dt
        self.dR = dRk @ dR_inc
        self.dt += dt

    # ------------------------------------------------------------------
    def predict(self, R_i, p_i, v_i, bg=None, ba=None):
        """NavState propagation of a state over the interval."""
        dbg = (np.zeros(3) if bg is None else bg) - self.bg
        dba = (np.zeros(3) if ba is None else ba) - self.ba
        dR = self.dR @ so3_exp(self.J_Rbg @ dbg)
        dv = self.dv + self.J_vbg @ dbg + self.J_vba @ dba
        dp = self.dp + self.J_pbg @ dbg + self.J_pba @ dba
        g = self.params.g
        t = self.dt
        R_j = R_i @ dR
        v_j = v_i + g * t + R_i @ dv
        p_j = p_i + v_i * t + 0.5 * g * t**2 + R_i @ dp
        return R_j, p_j, v_j

    def merge_from(self, other):
        """Re-integrate `other`'s raw measurements into self: the merge of
        two intervals when the keyframe between them is culled."""
        for acc, gyro, dt in other.meas:
            self.integrate(acc, gyro, dt)

    # ------------------------------------------------------------------
    def residual(self, R_i, p_i, v_i, bg_i, ba_i, R_j, p_j, v_j, bg_j,
                 ba_j):
        """(15,) residual + per-variable analytic Jacobians.

        Variables use right-perturbation tangents: pose [tau, phi] with
        T' = T Exp([tau, phi]) (translation-first, matching ops.lie)."""
        g = self.params.g
        t = self.dt
        dbg = bg_i - self.bg
        dba = ba_i - self.ba

        dR_corr = self.dR @ so3_exp(self.J_Rbg @ dbg)
        dv_corr = self.dv + self.J_vbg @ dbg + self.J_vba @ dba
        dp_corr = self.dp + self.J_pbg @ dbg + self.J_pba @ dba

        E = dR_corr.T @ R_i.T @ R_j
        r_R = so3_log(E)
        r_v = R_i.T @ (v_j - v_i - g * t) - dv_corr
        r_p = R_i.T @ (p_j - p_i - v_i * t - 0.5 * g * t**2) - dp_corr
        r_b = np.concatenate([bg_j - bg_i, ba_j - ba_i])
        r = np.concatenate([r_R, r_v, r_p, r_b])

        Jri = right_jacobian_inv(r_R)
        Z = np.zeros((3, 3))
        I = np.eye(3)

        # d r / d (pose_i = [tau_i, phi_i] right-pert of T_wb_i)
        # p_i' = p_i + R_i tau ; R_i' = R_i Exp(phi)
        dRr_dphii = -Jri @ R_j.T @ R_i
        dRv_dphii = skew(R_i.T @ (v_j - v_i - g * t))
        dRp_dphii = skew(R_i.T @ (p_j - p_i - v_i * t - 0.5 * g * t**2))
        drp_dtaui = -I
        J_pose_i = np.zeros((15, 6))
        J_pose_i[0:3, 3:6] = dRr_dphii
        J_pose_i[3:6, 3:6] = dRv_dphii
        J_pose_i[6:9, 0:3] = drp_dtaui
        J_pose_i[6:9, 3:6] = dRp_dphii

        J_vel_i = np.zeros((15, 3))
        J_vel_i[3:6] = -R_i.T
        J_vel_i[6:9] = -R_i.T * t

        J_bias_i = np.zeros((15, 6))    # [bg, ba]
        J_bias_i[0:3, 0:3] = -Jri @ E.T @ right_jacobian(
            self.J_Rbg @ dbg) @ self.J_Rbg
        J_bias_i[3:6, 0:3] = -self.J_vbg
        J_bias_i[3:6, 3:6] = -self.J_vba
        J_bias_i[6:9, 0:3] = -self.J_pbg
        J_bias_i[6:9, 3:6] = -self.J_pba
        J_bias_i[9:15] = -np.eye(6)

        J_pose_j = np.zeros((15, 6))
        J_pose_j[0:3, 3:6] = Jri
        J_pose_j[6:9, 0:3] = R_i.T @ R_j   # p_j' = p_j + R_j tau

        J_vel_j = np.zeros((15, 3))
        J_vel_j[3:6] = R_i.T

        J_bias_j = np.zeros((15, 6))
        J_bias_j[9:15] = np.eye(6)

        return r, (J_pose_i, J_vel_i, J_bias_i, J_pose_j, J_vel_j,
                   J_bias_j)

    def information(self):
        """Residual information matrix (inverse covariance), regularized."""
        cov = self.cov.copy()
        # residual order [phi, v, p, bg, ba] matches cov order; the bias
        # random-walk block covers r_b
        cov += np.eye(15) * 1e-12
        return np.linalg.inv(cov)
