"""SE(3)/SO(3) Lie-group math on torch tensors.

Conventions (lietorch's, so DROID-style BA math carries over):
  * quaternions are stored **xyzw** (last component = scalar) unless a
    function name says `wxyz` (the mapper's 3DGS-convention helpers live in
    `ops.quat_wxyz`).
  * an SE3 element is a 7-vector ``[tx ty tz qx qy qz qw]``; acting on a point
    is ``R @ p + t``.
  * tangent vectors are ``[tau(3), phi(3)]`` (translation first), and
    retraction is **left**-multiplicative: ``retr(X, xi) = exp(xi) * X``.

All functions broadcast over leading batch dims and work in the input dtype
and on the input's device.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


# ---------------------------------------------------------------------------
# quaternions (xyzw)
# ---------------------------------------------------------------------------

def quat_identity(shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_mul(q1, q2):
    """Hamilton product, xyzw layout."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate 3-vectors v by unit quaternions q (xyzw)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_matrix(q):
    """Unit quaternion (xyzw) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion (xyzw). Branchless Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1)

    # four candidate constructions; pick the numerically best
    q0 = mk(m21 - m12, m02 - m20, m10 - m01, 1 + tr)
    q1 = mk(1 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12)
    q2 = mk(m01 + m10, 1 - m00 + m11 - m22, m12 + m21, m02 - m20)
    q3 = mk(m02 + m20, m12 + m21, 1 - m00 - m11 + m22, m10 - m01)
    # squared 4*w^2, 4*x^2, 4*y^2, 4*z^2
    vals = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                        1 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(vals, dim=-1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    q = torch.gather(cand, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def _skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SO(3) exp/log
# ---------------------------------------------------------------------------

def so3_exp(phi):
    """Axis-angle (3,) -> quaternion (xyzw), Taylor series near 0. The
    large-angle branch is evaluated at a safe theta, so neither branch ever
    divides by zero."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta_sq / 48.0,
                            torch.sin(half) / theta)
    cos_half = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([phi * sinc_half, cos_half], dim=-1)


def so3_log(q):
    """Quaternion (xyzw) -> axis-angle, Taylor series near identity."""
    w = q[..., 3:4]
    q = q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))  # w >= 0
    qv = q[..., :3]
    qw = q[..., 3].clamp(-1.0, 1.0)
    sin_sq = torch.sum(qv * qv, dim=-1)
    small = sin_sq < 1e-12
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(sin_sq),
                                      sin_sq))
    theta = 2.0 * torch.atan2(sin_half, qw)
    scale = torch.where(small, 2.0 / qw.clamp(min=_EPS), theta / sin_half)
    return qv * scale[..., None]


def _so3_left_jacobian(phi):
    """V matrix such that exp([tau,phi]).t = V @ tau."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    K = _skew(phi)
    KK = K @ K
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (safe_sq * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def _so3_left_jacobian_inv(phi):
    theta_sq = torch.sum(phi * phi, dim=-1)
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    K = _skew(phi)
    KK = K @ K
    half = 0.5 * theta
    cot = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.where(small, torch.ones_like(half), torch.sin(half)))
        / safe_sq)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * K + cot[..., None, None] * KK


# ---------------------------------------------------------------------------
# SE(3): 7-vectors [t(3), q_xyzw(4)]
# ---------------------------------------------------------------------------

def se3_identity(shape=(), dtype=torch.float32, device=None):
    p = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    p[..., 6] = 1.0
    return p


def se3_mul(a, b):
    """Compose: (a * b) acts as a(b(x))."""
    t = quat_rotate(a[..., 3:7], b[..., :3]) + a[..., :3]
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    return torch.cat([t, q], dim=-1)


def se3_inv(p):
    qinv = quat_conj(p[..., 3:7])
    t = -quat_rotate(qinv, p[..., :3])
    return torch.cat([t, qinv], dim=-1)


def se3_act(p, x):
    """Apply pose to points x (..., 3)."""
    return quat_rotate(p[..., 3:7], x) + p[..., :3]


def se3_exp(xi):
    """Tangent [tau, phi] -> SE3 7-vector."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    t = (V @ tau[..., None])[..., 0]
    return torch.cat([t, q], dim=-1)


def se3_log(p):
    phi = so3_log(p[..., 3:7])
    Vinv = _so3_left_jacobian_inv(phi)
    tau = (Vinv @ p[..., :3, None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def se3_retr(p, xi):
    """Left-multiplicative retraction: exp(xi) * p (lietorch convention)."""
    return se3_mul(se3_exp(xi), p)


def se3_matrix(p):
    """7-vector -> homogeneous (..., 4, 4)."""
    R = quat_to_matrix(quat_normalize(p[..., 3:7]))
    M = torch.zeros(p.shape[:-1] + (4, 4), dtype=p.dtype, device=p.device)
    M[..., :3, :3] = R
    M[..., :3, 3] = p[..., :3]
    M[..., 3, 3] = 1.0
    return M


def se3_from_matrix(M):
    q = matrix_to_quat(M[..., :3, :3])
    t = M[..., :3, 3]
    return torch.cat([t, q], dim=-1)


def se3_adjoint(p):
    """Adjoint matrix (..., 6, 6): Adj(X) [tau,phi] with translation-first
    tangent layout — [[R, skew(t) R], [0, R]]."""
    R = quat_to_matrix(quat_normalize(p[..., 3:7]))
    tR = _skew(p[..., :3]) @ R
    Z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_adjT_apply(p, J):
    """Row-jacobian through the adjoint: J @ Adj(p) (lietorch's
    ``Gij.adjT(Jj)``, which gives Ji from Jj). J has shape (..., k, 6);
    returns (..., k, 6)."""
    return J @ se3_adjoint(p)
