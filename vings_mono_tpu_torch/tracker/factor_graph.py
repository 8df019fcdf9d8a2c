"""Dense sliding-window factor graph + LM optimizer + marginalization, in
float64 numpy: the replacement for the original system's GTSAM layer. The
windows are <= ~25 frames x 15 dof, so dense normal equations beat general
sparse elimination, and the double precision on the host is where the
original ran this too. A copy of the JAX package's `tracker/factor_graph.py`
except `conjugate_vision_hessian`, which takes the port's `ops.lie`.

Variables per frame: T_wb (R, p) with right-perturbation tangent
[tau, phi] (T' = T Exp(xi), translation-first like ops.lie), velocity v (3)
and bias b = [bg, ba] (6) -> 15 dof per frame.

Factor types: IMU preintegration (tracker/imu.py), pose/bias/vel priors,
GPS (robust Cauchy) and body-velocity/odometry factors, the DBA vision
Hessian (depth-marginalized, conjugated from camera-left to body-right
perturbation by -Adj(T_bc^-1), GTSAM's BA2GTSAM in the original), and the
dense marginal prior produced by `marginalize` (gtsam.marginalizeOut).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .imu import (Preintegration, right_jacobian_inv, skew, so3_exp,
                  so3_log)

POSE, VEL, BIAS = 0, 1, 2
DOF = {POSE: 6, VEL: 3, BIAS: 6}


class FrameState:
    __slots__ = ("R", "p", "v", "b")

    def __init__(self, R=None, p=None, v=None, b=None):
        self.R = np.eye(3) if R is None else np.asarray(R, np.float64)
        self.p = np.zeros(3) if p is None else np.asarray(p, np.float64)
        self.v = np.zeros(3) if v is None else np.asarray(v, np.float64)
        self.b = np.zeros(6) if b is None else np.asarray(b, np.float64)

    def copy(self):
        return FrameState(self.R.copy(), self.p.copy(), self.v.copy(),
                          self.b.copy())

    def retract(self, d15):
        out = self.copy()
        out.p = self.p + self.R @ d15[0:3]
        out.R = self.R @ so3_exp(d15[3:6])
        out.v = self.v + d15[6:9]
        out.b = self.b + d15[9:15]
        return out

    def local(self, other):
        """d such that other ~= self.retract(d)."""
        d = np.zeros(15)
        d[0:3] = self.R.T @ (other.p - self.p)
        d[3:6] = so3_log(self.R.T @ other.R)
        d[6:9] = other.v - self.v
        d[9:15] = other.b - self.b
        return d


class ImuFactor:
    def __init__(self, i, j, preint: Preintegration):
        self.i, self.j = i, j
        self.preint = preint
        self.info = preint.information()

    def keys(self):
        return [self.i, self.j]

    def linearize(self, x: Dict[int, FrameState]):
        si, sj = x[self.i], x[self.j]
        r, (Jpi, Jvi, Jbi, Jpj, Jvj, Jbj) = self.preint.residual(
            si.R, si.p, si.v, si.b[0:3], si.b[3:6],
            sj.R, sj.p, sj.v, sj.b[0:3], sj.b[3:6])
        Ji = np.concatenate([Jpi, Jvi, Jbi], axis=1)   # (15, 15)
        Jj = np.concatenate([Jpj, Jvj, Jbj], axis=1)
        return r, {self.i: Ji, self.j: Jj}, self.info


class PriorPoseFactor:
    def __init__(self, i, R0, p0, sigmas6):
        self.i = i
        self.R0, self.p0 = np.asarray(R0), np.asarray(p0)
        self.info15 = None
        s = np.asarray(sigmas6, np.float64)
        self.Lam = np.diag(1.0 / s**2)

    def keys(self):
        return [self.i]

    def linearize(self, x):
        s = x[self.i]
        r = np.zeros(6)
        r[0:3] = self.R0.T @ (s.p - self.p0)
        r[3:6] = so3_log(self.R0.T @ s.R)
        J = np.zeros((6, 15))
        J[0:3, 0:3] = self.R0.T @ s.R
        J[3:6, 3:6] = right_jacobian_inv(r[3:6])
        return r, {self.i: J}, self.Lam


class PriorBiasFactor:
    def __init__(self, i, b0, sigmas6):
        self.i = i
        self.b0 = np.asarray(b0, np.float64)
        self.Lam = np.diag(1.0 / np.asarray(sigmas6, np.float64)**2)

    def keys(self):
        return [self.i]

    def linearize(self, x):
        r = x[self.i].b - self.b0
        J = np.zeros((6, 15))
        J[:, 9:15] = np.eye(6)
        return r, {self.i: J}, self.Lam


class PriorVelFactor:
    def __init__(self, i, v0, sigmas3):
        self.i = i
        self.v0 = np.asarray(v0, np.float64)
        self.Lam = np.diag(1.0 / np.asarray(sigmas3, np.float64)**2)

    def keys(self):
        return [self.i]

    def linearize(self, x):
        r = x[self.i].v - self.v0
        J = np.zeros((3, 15))
        J[:, 6:9] = np.eye(3)
        return r, {self.i: J}, self.Lam


class GpsFactor:
    """Position measurement with a Cauchy robust kernel."""

    def __init__(self, i, p_meas, sigmas3, cauchy=0.08):
        self.i = i
        self.p_meas = np.asarray(p_meas, np.float64)
        self.Lam = np.diag(1.0 / np.asarray(sigmas3, np.float64)**2)
        self.cauchy = cauchy

    def keys(self):
        return [self.i]

    def linearize(self, x):
        s = x[self.i]
        r = s.p - self.p_meas
        J = np.zeros((3, 15))
        J[:, 0:3] = s.R
        # Cauchy weight on the whitened norm
        e2 = float(r @ self.Lam @ r)
        c2 = self.cauchy**2
        w = c2 / (c2 + e2)
        return r, {self.i: J}, self.Lam * w


class VelBodyFactor:
    """Body-frame velocity (odometry / ZUPT), gtsam.VelFactor."""

    def __init__(self, i, v_body, sigmas3):
        self.i = i
        self.v_meas = np.asarray(v_body, np.float64)
        self.Lam = np.diag(1.0 / np.asarray(sigmas3, np.float64)**2)

    def keys(self):
        return [self.i]

    def linearize(self, x):
        s = x[self.i]
        r = s.R.T @ s.v - self.v_meas
        J = np.zeros((3, 15))
        J[:, 3:6] = skew(s.R.T @ s.v)
        J[:, 6:9] = s.R.T
        return r, {self.i: J}, self.Lam


class QuadraticPoseFactor:
    """The DBA vision factor: 0.5 d^T H d - v^T d over the body-frame pose
    perturbations of frames `frames` around the stored linearization states
    (rebuilt each outer iteration, as GTSAM's CustomHessianFactor is)."""

    def __init__(self, frames: List[int], H, v, lin: Dict[int, FrameState]):
        self.frames = list(frames)
        self.H = np.asarray(H, np.float64)
        self.v = np.asarray(v, np.float64)
        self.lin = {k: lin[k].copy() for k in frames}

    def pose_deltas(self, x):
        return np.concatenate([self.lin[k].local(x[k])[0:6]
                               for k in self.frames])

    def keys(self):
        return self.frames


class MarginalPrior:
    """Dense linear prior from marginalization: energy
    0.5 d^T H d - g^T d with d = local deviation from the stored
    linearization point (gtsam.LinearContainerFactor semantics)."""

    def __init__(self, frames: List[int], H, g, lin: Dict[int, FrameState]):
        self.frames = list(frames)
        self.H = H
        self.g = g
        self.lin = {k: s.copy() for k, s in lin.items()}

    def keys(self):
        return self.frames

    def rekey(self, mapping):
        self.frames = [mapping.get(f, f) for f in self.frames]
        self.lin = {mapping.get(k, k): v for k, v in self.lin.items()}


def _accumulate(Hbig, bbig, idx, r, Js, Lam):
    for ka, Ja in Js.items():
        ia = idx[ka]
        bbig[ia:ia + 15] -= Ja.T @ Lam @ r
        for kb, Jb in Js.items():
            ib = idx[kb]
            Hbig[ia:ia + 15, ib:ib + 15] += Ja.T @ Lam @ Jb


def _accumulate_quadratic(Hbig, bbig, idx, fac, x):
    if isinstance(fac, QuadraticPoseFactor):
        # pose-only blocks; gradient shifted by the motion since the
        # factor's linearization: grad = v - H * delta
        delta = fac.pose_deltas(x)
        grad = fac.v - fac.H @ delta
        for a, ka in enumerate(fac.frames):
            ia = idx[ka]
            bbig[ia:ia + 6] += grad[a * 6:(a + 1) * 6]
            for b, kb in enumerate(fac.frames):
                ib = idx[kb]
                Hbig[ia:ia + 6, ib:ib + 6] += \
                    fac.H[a * 6:(a + 1) * 6, b * 6:(b + 1) * 6]
    elif isinstance(fac, MarginalPrior):
        # relinearize: b contribution g - H * delta(current, lin)
        deltas = np.concatenate([fac.lin[k].local(x[k]) for k in
                                 fac.frames])
        grad = fac.g - fac.H @ deltas
        for a, ka in enumerate(fac.frames):
            ia = idx[ka]
            bbig[ia:ia + 15] += grad[a * 15:(a + 1) * 15]
            for b, kb in enumerate(fac.frames):
                ib = idx[kb]
                Hbig[ia:ia + 15, ib:ib + 15] += \
                    fac.H[a * 15:(a + 1) * 15, b * 15:(b + 1) * 15]
    else:
        raise TypeError(fac)


def build_normal_equations(x: Dict[int, FrameState], factors, frames):
    idx = {f: 15 * k for k, f in enumerate(frames)}
    n = 15 * len(frames)
    H = np.zeros((n, n))
    b = np.zeros(n)
    for fac in factors:
        if isinstance(fac, (QuadraticPoseFactor, MarginalPrior)):
            _accumulate_quadratic(H, b, idx, fac, x)
        else:
            r, Js, Lam = fac.linearize(x)
            _accumulate(H, b, idx, r, Js, Lam)
    return H, b, idx


def total_error(x, factors):
    e = 0.0
    for fac in factors:
        if isinstance(fac, QuadraticPoseFactor):
            d = fac.pose_deltas(x)
            e += 0.5 * d @ fac.H @ d - fac.v @ d
            continue
        if isinstance(fac, MarginalPrior):
            d = np.concatenate([fac.lin[k].local(x[k]) for k in fac.frames])
            e += 0.5 * d @ fac.H @ d - fac.g @ d
            continue
        r, _, Lam = fac.linearize(x)
        e += 0.5 * r @ Lam @ r
    return e


def optimize(x: Dict[int, FrameState], factors, frames, iters=6,
             lm_init=1e-4):
    """Levenberg-Marquardt over the window. Returns (new_x, delta_dict)."""
    x = {k: s.copy() for k, s in x.items()}
    lam = lm_init
    for _ in range(iters):
        H, b, idx = build_normal_equations(x, factors, frames)
        err0 = total_error(x, factors)
        for _ in range(6):
            A = H + lam * np.diag(np.maximum(np.diag(H), 1.0))
            try:
                d = np.linalg.solve(A, b)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            x_new = {k: (x[k].retract(d[idx[k]:idx[k] + 15])
                         if k in idx else x[k]) for k in x}
            if total_error(x_new, factors) < err0 + 1e-12:
                x = x_new
                lam = max(lam / 3, 1e-9)
                break
            lam *= 10
    return x


def marginalize(x: Dict[int, FrameState], factors, marg_frames):
    """Schur-complement the 15-dof blocks of `marg_frames` out of the given
    factors; returns a MarginalPrior over the remaining frames those factors
    touch (gtsam.marginalizeOut equivalent)."""
    keep, seen = [], set()
    for fac in factors:
        for k in fac.keys():
            if k not in marg_frames and k not in seen:
                seen.add(k)
                keep.append(k)
    keep = sorted(keep)
    frames = sorted(set(marg_frames)) + keep
    H, b, idx = build_normal_equations(x, factors, frames)
    nm = 15 * len(set(marg_frames))
    Hmm = H[:nm, :nm] + np.eye(nm) * 1e-9
    Hmk = H[:nm, nm:]
    Hkk = H[nm:, nm:]
    bm = b[:nm]
    bk = b[nm:]
    sol = np.linalg.solve(Hmm, np.concatenate([Hmk, bm[:, None]], axis=1))
    H_new = Hkk - Hmk.T @ sol[:, :-1]
    g_new = bk - Hmk.T @ sol[:, -1]
    lin = {k: x[k] for k in keep}
    return MarginalPrior(keep, H_new, g_new, lin)


def conjugate_vision_hessian(S, v, T_bc):
    """Camera-frame/left-perturbation DBA Hessian -> body-frame/right-
    perturbation (GTSAM's BA2GTSAM in the original system, without its
    rotation-first reorder: the tangent here stays translation-first).

    S (P,P,6,6), v (P,6) from ops.ba.ba_hessian; T_bc (4,4) camera-in-body.
    xi_cam = -Adj(T_bc^{-1}) zeta_body per frame. The adjoint is built in
    float32 by ops.lie and widened to float64, as the JAX package builds it.
    """
    import torch
    from ..ops import lie
    Tcb = np.linalg.inv(np.asarray(T_bc, np.float64))
    A = -lie.se3_adjoint(lie.se3_from_matrix(
        torch.as_tensor(Tcb, dtype=torch.float32))).numpy().astype(np.float64)
    P = v.shape[0]
    Hc = np.transpose(np.asarray(S, np.float64), (0, 2, 1, 3)).reshape(
        6 * P, 6 * P)
    vc = np.asarray(v, np.float64).reshape(6 * P)
    J = np.kron(np.eye(P), A)
    return J.T @ Hc @ J, J.T @ vc, A
