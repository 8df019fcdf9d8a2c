"""Dense bundle adjustment on torch tensors (DROID's `droid_backends.ba`).

Gauss-Newton over keyframe poses + per-pixel inverse depths:
  * per-edge Jacobians from ops.projective (analytic),
  * block Hessian assembled with `index_add_` over the edge list,
  * per-pixel depth blocks marginalized by a Schur complement (C is
    diagonal over pixels), damped pose system solved with Cholesky,
  * left-multiplicative SE3 retraction + disparity update.

An edge whose `edge_valid` is False contributes nothing, so callers may pass
only their live edges or a padded list: the results are equal.

The routine also exposes the two half-steps an inertial fusion needs:
`ba_hessian` returns the depth-marginalized pose Hessian/rhs (camera frame),
and `ba_retract` applies an externally solved pose delta and solves depths.

The full-trajectory global BA of the terminate pass comes in two forms:
`ba_global` (dense (T*6)^2 pose system; for small T and the tests) and
`ba_global_banded` (block-band pose storage solved by `banded_pcg`; the
product path). Both Schur-eliminate each frame's depths over a capped
adjacency list instead of a dense (T, T, 6, HW) coupling.

Every product here must run in true f32: the callers keep TF32 matmuls off
(utils.device.f32_matmul).
"""

from __future__ import annotations

import torch

from . import lie
from . import projective as pops


def _scatter_rows(vals, idx, n):
    """vals (N, ...) summed into (n, ...) by idx (N,); idx == n discards."""
    out = vals.new_zeros((n + 1,) + vals.shape[1:])
    return out.index_add_(0, idx, vals)[:-1]


def build_system(target, weight, eta, poses, disps, intrinsics, ii, jj,
                 edge_valid, fixedp=1, m_frames=None):
    """Assemble the BA normal equations.

    target/weight (N, 2, H, W) [DROID layout], eta (M, H, W) damping,
    poses (P, 7) w2c, disps (P, H, W), ii/jj (N,) integer, edge_valid (N,).
    Depth blocks are indexed by source frame directly (M = P).
    """
    P, ht, wd = disps.shape
    ii = ii.long()
    jj = jj.long()
    N = ii.shape[0]
    D = 6
    HW = ht * wd
    if m_frames is None:
        m_frames = P

    coords, valid, (Ji, Jj, Jz) = pops.projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True)

    tgt = target.movedim(1, -1)                        # (N, H, W, 2)
    r = (tgt - coords) * valid
    wgt = 0.001 * weight.movedim(1, -1) * valid        # (N, H, W, 2)
    wgt = wgt * edge_valid[:, None, None, None].to(wgt.dtype)

    Jif = Ji.reshape(N, HW, 2, D)
    Jjf = Jj.reshape(N, HW, 2, D)
    Jzf = Jz.reshape(N, HW, 2, 1)
    rf = r.reshape(N, HW, 2, 1)
    wf = wgt.reshape(N, HW, 2, 1)

    wJi = wf * Jif
    wJj = wf * Jjf

    # pose-pose blocks (N, 6, 6): sum over pixels and the 2 coords
    def blk(A, B):
        return torch.einsum("npcd,npce->nde", A, B)

    Hii, Hij = blk(wJi, Jif), blk(wJi, Jjf)
    Hji, Hjj = blk(wJj, Jif), blk(wJj, Jjf)
    vi = torch.einsum("npcd,npcz->nd", wJi, rf)
    vj = torch.einsum("npcd,npcz->nd", wJj, rf)

    # pose-depth coupling (N, 6, HW) and depth diagonal/rhs (N, HW)
    Ei = torch.einsum("npcd,npcz->ndp", wJi, Jzf)
    Ej = torch.einsum("npcd,npcz->ndp", wJj, Jzf)
    Ck = torch.einsum("npcz,npcz->np", wf * Jzf, Jzf)
    wk = torch.einsum("npcz,npcz->np", wf * Jzf, rf)

    # scatter into window-sized blocks; fixed poses drop via index < 0
    Pa = P - fixedp
    iia = ii - fixedp
    jja = jj - fixedp

    def safe_mat(vals, a, b, na, nb):
        ok = (a >= 0) & (b >= 0)
        idx = torch.where(ok, a * nb + b, na * nb)
        return _scatter_rows(vals, idx, na * nb).reshape(
            na, nb, *vals.shape[1:])

    def safe_vec(vals, a, na):
        return _scatter_rows(vals, torch.where(a >= 0, a, na), na)

    H = (safe_mat(Hii, iia, iia, Pa, Pa) + safe_mat(Hij, iia, jja, Pa, Pa)
         + safe_mat(Hji, jja, iia, Pa, Pa) + safe_mat(Hjj, jja, jja, Pa, Pa))
    v = safe_vec(vi, iia, Pa) + safe_vec(vj, jja, Pa)

    # depth blocks keyed by source frame ii (not compacted)
    E = (safe_mat(Ei, iia, ii, Pa, m_frames)
         + safe_mat(Ej, jja, ii, Pa, m_frames))       # (Pa, M, 6, HW)
    C = safe_vec(Ck, ii, m_frames)                    # (M, HW)
    w = safe_vec(wk, ii, m_frames)

    C = C + eta.reshape(m_frames, HW) + 1e-7
    return H, v, E, C, w


def schur_reduce(H, v, E, C, w):
    """Marginalize depths: S = H - E Q E^T, v' = v - E Q w. Q = 1/C."""
    Pa, M, D, HW = E.shape
    Q = 1.0 / C                                        # (M, HW)
    EQ = E * Q[None, :, None, :]                       # (Pa, M, 6, HW)
    # S[p,q,d,e] = sum_{m,h} EQ[p,m,d,h] E[q,m,e,h], as one matmul
    A = EQ.permute(0, 2, 1, 3).reshape(Pa * D, M * HW)
    B = E.permute(0, 2, 1, 3).reshape(Pa * D, M * HW)
    S = (A @ B.T).reshape(Pa, D, Pa, D).permute(0, 2, 1, 3)
    S = H - S
    v2 = v - (A @ w.reshape(M * HW)).reshape(Pa, D)
    return S, v2, Q


def _cholesky_or_eye(A):
    """Lower Cholesky factor of A and whether it exists; the identity when A
    is not positive definite or not finite. No host sync."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    ok = (info == 0) & torch.isfinite(L).all()
    return torch.where(ok, L, eye), ok


def damped_solve(S, v, ep=0.1, lm=1e-4):
    """Dense damped solve of the (Pa*6, Pa*6) pose system via Cholesky; a
    system that has no factor gives dx = 0."""
    Pa = S.shape[0]
    A = S.permute(0, 2, 1, 3).reshape(Pa * 6, Pa * 6)
    eye = torch.eye(Pa * 6, dtype=A.dtype, device=A.device)
    A = A + (ep + lm * A) * eye
    b = v.reshape(Pa * 6)
    L, ok = _cholesky_or_eye(A)
    b = torch.where(ok, b, torch.zeros_like(b))
    dx = torch.cholesky_solve(b[:, None], L)[:, 0]
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    return dx.reshape(Pa, 6)


def depth_backsub(dx, E, Q, w):
    """dz = Q (w - E^T dx)."""
    Et_dx = torch.einsum("pmdh,pd->mh", E, dx)
    return Q * (w - Et_dx)


def retract(poses, disps, dx, dz, fixedp=1):
    dx_full = torch.cat([dx.new_zeros((fixedp, 6)), dx], dim=0)
    poses = lie.se3_retr(poses, dx_full)
    disps = disps + dz.reshape(disps.shape)
    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    disps = disps.clamp(min=0.0)
    return poses, disps


def ba(target, weight, eta, poses, disps, intrinsics, ii, jj, edge_valid,
       fixedp=1, iters=1, ep=0.1, lm=1e-4):
    """Full visual-only dense BA.

    Updates poses (P,7 w2c) and disps (P,H,W) in `iters` Gauss-Newton steps.
    """
    for _ in range(iters):
        H, v, E, C, w = build_system(target, weight, eta, poses, disps,
                                     intrinsics, ii, jj, edge_valid, fixedp)
        S, v2, Q = schur_reduce(H, v, E, C, w)
        dx = damped_solve(S, v2, ep, lm)
        dz = depth_backsub(dx, E, Q, w)
        poses, disps = retract(poses, disps, dx, dz, fixedp)
    return poses, disps


def _mask_fixed(S, v, free_mask):
    """Pin poses with free_mask=False: identity rows/cols in S, zero rhs.
    free_mask (Pa,) refers to the post-fixedp indexing."""
    m = free_mask.to(S.dtype)
    mm = m[:, None, None, None] * m[None, :, None, None]
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    diag = (1.0 - m)[:, None, None] * eye6[None]
    S = S * mm
    # add identity on fixed diagonal blocks to keep the system well-posed
    S = S + torch.einsum(
        "pq,pde->pqde",
        torch.eye(S.shape[0], dtype=S.dtype, device=S.device), diag)
    v = v * m[:, None]
    return S, v


def ba_window(target, weight, eta, poses, disps, intrinsics, ii, jj,
              edge_valid, t0, iters=1, ep=0.1, lm=1e-4):
    """Dense BA over a window with a first-free index t0 (frames < t0 keep
    their poses; all depths stay free): the shape the sliding-window
    frontend needs, where the pinned prefix changes frame to frame."""
    P = poses.shape[0]
    free = torch.arange(P, device=poses.device) >= t0
    for _ in range(iters):
        H, v, E, C, w = build_system(target, weight, eta, poses, disps,
                                     intrinsics, ii, jj, edge_valid,
                                     fixedp=0)
        S, v2, Q = schur_reduce(H, v, E, C, w)
        S, v2 = _mask_fixed(S, v2, free)
        dx = damped_solve(S, v2, ep, lm)
        dx = dx * free[:, None].to(dx.dtype)
        dz = depth_backsub(dx, E, Q, w)
        poses, disps = retract(poses, disps, dx, dz, fixedp=0)
    return poses, disps


def ba_hessian(target, weight, eta, poses, disps, intrinsics, ii, jj,
               edge_valid, fixedp=0):
    """Depth-marginalized pose Hessian/rhs in the camera frame. fixedp=0:
    all window poses are free there.
    Returns (S (Pa,Pa,6,6), v (Pa,6), aux for retraction)."""
    H, v, E, C, w = build_system(target, weight, eta, poses, disps,
                                 intrinsics, ii, jj, edge_valid, fixedp)
    S, v2, Q = schur_reduce(H, v, E, C, w)
    return S, v2, (E, Q, w)


def depth_covariance(S, E, Q, disps, free_mask=None, ep=0.1, lm=1e-4):
    """Per-pixel inverse-depth covariance after marginalizing poses:

      Sigma_z = Q + rowsum( (Q E^T L^-T)^2 ),   L = chol(S_damped)
      depth_cov = Sigma_z / disps^4

    S (P,P,6,6), E (P,M,6,HW), Q (M,HW) from schur_reduce/ba_hessian aux.
    Returns (M, H, W) metric-depth covariance.
    """
    P = S.shape[0]
    M, HW = Q.shape
    A = S.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    eye = torch.eye(P * 6, dtype=A.dtype, device=A.device)
    if free_mask is not None:
        mm = free_mask.to(A.dtype).repeat_interleave(6)
        A = A * mm[:, None] * mm[None, :] + torch.diag(1.0 - mm)
    A = A + (ep + lm * A) * eye
    L, ok = _cholesky_or_eye(A)
    # X = L^{-1} (Q E^T)^T; its column norms are the pose part of Sigma_z
    QE = (E * Q[None, :, None, :])              # (P, M, 6, HW)
    QE = QE.permute(0, 2, 1, 3).reshape(P * 6, M * HW)
    X = torch.linalg.solve_triangular(L, QE, upper=False)
    delta = torch.sum(X * X, dim=0).reshape(M, HW)
    z_cov = torch.where(ok, Q + delta, Q)
    d = disps.reshape(M, HW)
    cov = z_cov / (d ** 4 + 1e-6)
    return cov.reshape(disps.shape)


def ba_retract(poses, disps, dx, aux, fixedp=0):
    """Apply an externally solved pose delta; back-substitute depths."""
    E, Q, w = aux
    dz = depth_backsub(dx, E, Q, w)
    return retract(poses, disps, dx, dz, fixedp)


# ---------------------------------------------------------------------------
# global BA (terminate pass)
# ---------------------------------------------------------------------------

def _global_terms(target, weight, eta, poses, disps, intrinsics, ii, jj,
                  edge_valid, group_idx, group_valid):
    """Per-edge pose blocks and the per-depth-frame adjacency rows shared by
    both global solvers.

    Returns (blocks, v, R, pid, Q, wrhs): blocks = (Hii, Hij, Hji, Hjj) each
    (N, 6, 6); v (T, 6); R (T, d+1, 6, HW) with R[m, 0] the sum of Ei over
    edges whose source is m and R[m, 1+k] the Ej of adjacency slot k; pid
    (T, d+1) the pose each row of R couples to; Q = 1/C (T, HW); wrhs (T,
    HW) the depth rhs."""
    T, ht, wd = disps.shape
    HW = ht * wd
    N = ii.shape[0]
    coords, valid, (Ji, Jj, Jz) = pops.projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True)
    r = (target.movedim(1, -1) - coords) * valid
    wgt = 0.001 * weight.movedim(1, -1) * valid
    wgt = wgt * edge_valid[:, None, None, None].to(wgt.dtype)

    Jif = Ji.reshape(N, HW, 2, 6)
    Jjf = Jj.reshape(N, HW, 2, 6)
    Jzf = Jz.reshape(N, HW, 2, 1)
    rf = r.reshape(N, HW, 2, 1)
    wf = wgt.reshape(N, HW, 2, 1)
    wJi = wf * Jif
    wJj = wf * Jjf

    def blk(A, B):
        return torch.einsum("npcd,npce->nde", A, B)

    blocks = (blk(wJi, Jif), blk(wJi, Jjf), blk(wJj, Jif), blk(wJj, Jjf))
    v = _scatter_rows(torch.einsum("npcd,npcz->nd", wJi, rf), ii, T) + \
        _scatter_rows(torch.einsum("npcd,npcz->nd", wJj, rf), jj, T)

    Ei = torch.einsum("npcd,npcz->ndp", wJi, Jzf)        # (N, 6, HW)
    Ej = torch.einsum("npcd,npcz->ndp", wJj, Jzf)
    Ck = torch.einsum("npcz,npcz->np", wf * Jzf, Jzf)
    wk = torch.einsum("npcz,npcz->np", wf * Jzf, rf)
    C = _scatter_rows(Ck, ii, T) + eta.reshape(T, HW) + 1e-7
    wrhs = _scatter_rows(wk, ii, T)
    Q = 1.0 / C

    R0 = _scatter_rows(Ei, ii, T)                        # (T, 6, HW)
    gmask = group_valid[..., None, None].to(Ej.dtype)
    Rk = Ej[group_idx] * gmask                           # (T, d, 6, HW)
    R = torch.cat([R0[:, None], Rk], dim=1)              # (T, d+1, 6, HW)
    pid = torch.cat([torch.arange(T, device=ii.device)[:, None],
                     torch.where(group_valid, jj[group_idx],
                                 torch.zeros_like(group_idx))], dim=1)
    return blocks, v, R, pid, Q, wrhs


def _schur_blocks(R, Q, wrhs):
    """Per-depth-frame Schur terms: (T, d+1, d+1, 6, 6) blocks R Q R^T and
    (T, d+1, 6) rhs terms R Q w."""
    QR = R * Q[:, None, None, :]
    return (torch.einsum("madh,mbeh->mabde", QR, R),
            torch.einsum("madh,mh->mad", QR, wrhs))


def _depth_update(R, pid, Q, wrhs, dx):
    """dz = Q (w - R^T dx) over the adjacency rows."""
    return Q * (wrhs - torch.einsum("madh,mad->mh", R, dx[pid]))


def ba_global(target, weight, eta, poses, disps, intrinsics, ii, jj,
              edge_valid, group_idx, group_valid, free_mask, iters=2,
              ep=0.1, lm=1e-4):
    """Full-trajectory dense-depth BA with an edge-sparse Schur complement:
    the dense-solve form of the terminate pass.

    The window BA materializes the pose-depth coupling E as a dense
    (P, M, 6, HW) tensor; here S -= E Q E^T is accumulated per depth frame
    over a capped adjacency list instead:

      group_idx (T, d) integer — ids of edges whose source frame ii == m
      group_valid (T, d) bool — padding mask

    For depth frame m the poses coupled through its depth block are m
    itself (via every edge's Ei) and the d destination frames jj[e] (via
    Ej); stacking those d+1 rows gives R_m (d+1, 6, HW), whose (d+1)^2
    outer-product blocks scatter into the dense (T, T, 6, 6) pose system
    with `index_add_` over a flat (T*T, 6, 6) buffer.

    free_mask (T,) bool — poses to optimize (False = pinned, e.g. frame 0).
    Returns (poses, disps) after `iters` Gauss-Newton steps."""
    T = disps.shape[0]
    ii, jj, group_idx = ii.long(), jj.long(), group_idx.long()

    def mat(vals, a, b):
        return _scatter_rows(vals, a * T + b, T * T).reshape(T, T, 6, 6)

    for _ in range(iters):
        (Hii, Hij, Hji, Hjj), v, R, pid, Q, wrhs = _global_terms(
            target, weight, eta, poses, disps, intrinsics, ii, jj,
            edge_valid, group_idx, group_valid)
        H = mat(Hii, ii, ii) + mat(Hij, ii, jj) + mat(Hji, jj, ii) \
            + mat(Hjj, jj, jj)
        Sblk, vblk = _schur_blocks(R, Q, wrhs)
        sidx = (pid[:, :, None] * T + pid[:, None, :]).reshape(-1)
        Ssub = _scatter_rows(Sblk.reshape(-1, 6, 6), sidx,
                             T * T).reshape(T, T, 6, 6)
        vsub = _scatter_rows(vblk.reshape(-1, 6), pid.reshape(-1), T)
        S, v2 = _mask_fixed(H - Ssub, v - vsub, free_mask)
        dx = damped_solve(S, v2, ep, lm)
        dx = dx * free_mask[:, None].to(dx.dtype)
        dz = _depth_update(R, pid, Q, wrhs, dx)
        poses, disps = retract(poses, disps, dx, dz, fixedp=0)
    return poses, disps


def _band_neighbors(T, band, device=None):
    """Column c of band storage holds block (a, a + c - band)."""
    idx = torch.arange(T, device=device)[:, None] \
        + torch.arange(2 * band + 1, device=device)[None, :] - band
    ok = (idx >= 0) & (idx < T)
    return idx.clamp(0, T - 1), ok


def band_matvec(Sb, x, band):
    """y[a] = sum_c Sb[a, c] @ x[a + c - band]; Sb (T, 2b+1, 6, 6)."""
    idx, ok = _band_neighbors(x.shape[0], band, x.device)
    xg = x[idx] * ok[..., None].to(x.dtype)
    return torch.einsum("twde,twe->td", Sb, xg)


# iterations between the host's reads of `banded_pcg`'s done flag
CG_CHECK_EVERY = 32


def banded_pcg(Sb, b, band, iters=128, tol=1e-8):
    """Block-Jacobi-preconditioned conjugate gradients on the block-banded
    SPD pose system; O(T * band * 36) per iteration, no dense (T*6)^2
    matrix. Returns (x, n_iters) with n_iters a device scalar: the
    iterations that ran before the stop rule below held.

    Early stop: an iteration runs while rz > tol * rz0 and rz is finite.
    The test is a device-side `done` flag, not a host branch: once it is
    set, x, r, z, p and rz stay frozen, which gives the same x as a loop
    that exits there. To skip the frozen tail the host reads the flag once
    every CG_CHECK_EVERY iterations (one synchronizing call each)."""
    eye6 = torch.eye(6, dtype=Sb.dtype, device=Sb.device)
    D = Sb[:, band] + 1e-8 * eye6[None]
    Dinv = torch.linalg.inv_ex(D).inverse
    Dinv = torch.where(torch.isfinite(Dinv), Dinv, eye6[None])

    def precond(r):
        return torch.einsum("tde,te->td", Dinv, r)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    rz0 = rz
    n_iters = torch.zeros((), dtype=torch.int32, device=b.device)
    for i in range(iters):
        if i and i % CG_CHECK_EVERY == 0 and not bool(
                (rz > tol * rz0) & torch.isfinite(rz)):
            break
        run = (rz > tol * rz0) & torch.isfinite(rz)
        Ap = band_matvec(Sb, p, band)
        alpha = rz / (torch.sum(p * Ap) + 1e-20)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = precond(r_n)
        rz_n = torch.sum(r_n * z_n)
        p_n = z_n + rz_n / (rz + 1e-20) * p
        x, r, z, p, rz = (torch.where(run, new, old) for new, old in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p),
                           (rz_n, rz)))
        n_iters = n_iters + run.to(torch.int32)
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x)), n_iters


def ba_global_banded(target, weight, eta, poses, disps, intrinsics, ii, jj,
                     edge_valid, group_idx, group_valid, free_mask,
                     iters=2, ep=0.1, lm=1e-4, band=128, cg_iters=128,
                     stats=None):
    """`ba_global` with the pose system in block-band storage and a PCG
    solve: memory O(T * band * 36) instead of O(T^2 * 36).

    Requires |ii - jj| <= band/2 for every edge (the Schur complement fills
    in up to twice the edge band); out-of-band blocks are dropped, so
    callers pick `band` >= 2 * the longest edge. Equals `ba_global` when
    the band covers the whole system up to the PCG's stop rule
    (`banded_pcg`'s `tol`). `stats`, a dict, receives the list of CG
    iterations of each Gauss-Newton step as device scalars
    (`cg_iters_used`)."""
    T = disps.shape[0]
    Wd = 2 * band + 1
    ii, jj, group_idx = ii.long(), jj.long(), group_idx.long()
    eye6 = torch.eye(6, dtype=poses.dtype, device=poses.device)
    idx_nb, _ = _band_neighbors(T, band, poses.device)

    def band_index(a, b):
        c = b - a + band
        ok = (c >= 0) & (c < Wd)
        return torch.where(ok, a * Wd + c, torch.full_like(c, T * Wd))

    def matb(vals, a, b):
        return _scatter_rows(vals, band_index(a, b), T * Wd).reshape(
            T, Wd, 6, 6)

    for _ in range(iters):
        (Hii, Hij, Hji, Hjj), v, R, pid, Q, wrhs = _global_terms(
            target, weight, eta, poses, disps, intrinsics, ii, jj,
            edge_valid, group_idx, group_valid)
        Hb = matb(Hii, ii, ii) + matb(Hij, ii, jj) + matb(Hji, jj, ii) \
            + matb(Hjj, jj, jj)
        Sblk, vblk = _schur_blocks(R, Q, wrhs)
        d1 = R.shape[1]
        pa = pid[:, :, None].expand(T, d1, d1)
        pb = pid[:, None, :].expand(T, d1, d1)
        Ssub = _scatter_rows(Sblk.reshape(-1, 6, 6),
                             band_index(pa, pb).reshape(-1),
                             T * Wd).reshape(T, Wd, 6, 6)
        vsub = _scatter_rows(vblk.reshape(-1, 6), pid.reshape(-1), T)
        Sb = Hb - Ssub
        v2 = v - vsub

        # pin fixed poses (banded _mask_fixed): zero their rows/cols,
        # identity diagonal block, zero rhs
        m = free_mask.to(Sb.dtype)
        Sb = Sb * m[:, None, None, None] * m[idx_nb][..., None, None]
        dg = Sb[:, band] + (1.0 - m)[:, None, None] * eye6[None]
        # damping as damped_solve: diagonal elements scaled by (1 + lm),
        # plus ep
        dd = torch.diagonal(dg, dim1=-2, dim2=-1)
        Sb = Sb.clone()
        Sb[:, band] = dg + (ep + lm * dd)[:, :, None] * eye6[None]
        v2 = v2 * m[:, None]

        dx, used = banded_pcg(Sb, v2, band, iters=cg_iters)
        if stats is not None:
            stats.setdefault("cg_iters_used", []).append(used)
        dx = dx * free_mask[:, None].to(dx.dtype)
        dz = _depth_update(R, pid, Q, wrhs, dx)
        poses, disps = retract(poses, disps, dx, dz, fixedp=0)
    return poses, disps
