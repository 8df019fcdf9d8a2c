"""Adversarial inputs for the tile kernels: a pair block whose surfels sit
where the kernels' cull and coverage are most likely to go wrong.

Made from a numpy seed, projected by `project_surfels` and laid out as the
kernels read it, without the binning (which would drop most of these
surfels before a kernel saw them). Used by `chip_smoke.py` on the card and
by the CPU tests of `pair_pixel_bounds`.
"""

from __future__ import annotations

import numpy as np
import torch

from .projection import ALPHA_EPS, PK_OPAC, Camera, project_surfels
from .tile_kernel import TILE

CLASSES = ("plain", "edge_on", "behind", "across_camera_plane", "huge",
           "tiny", "threshold_opacity", "near_opaque")


def _quat_facing(normal):
    """wxyz quaternion turning the local z axis (the surfel's normal) onto
    `normal` (n, 3), unit vectors away from -z."""
    q = np.concatenate([1.0 + normal[:, 2:3], -normal[:, 1:2],
                        normal[:, 0:1], np.zeros_like(normal[:, :1])], -1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def adversarial_scene(seed, camera: Camera, per_class):
    """Surfel parameters in the frame of `camera` (whose w2c must be the
    identity), `per_class` of each of CLASSES in that order, and the
    opacity each packed row is given afterwards (NaN: keep the sigmoid's).
    Returns ([xyz, log_scale, quat, logit_opacity, rgb], opacity)."""
    rng = np.random.default_rng(seed)
    m, n = per_class, per_class * len(CLASSES)
    W, H = camera.width, camera.height
    z = rng.uniform(2.0, 6.0, n)
    # centers from a little outside the image to a little outside it
    px = rng.uniform(-0.1 * W, 1.1 * W, n)
    py = rng.uniform(-0.1 * H, 1.1 * H, n)
    scale = rng.uniform(0.05, 0.5, (n, 2))
    normal = rng.normal(size=(n, 3))
    normal[:, 2] = np.abs(normal[:, 2]) + 0.5
    opacity = np.full(n, np.nan)
    logit = rng.normal(size=n) * 1.5 + 1.0
    cls = {name: slice(i * m, (i + 1) * m) for i, name in enumerate(CLASSES)}

    s = cls["behind"]
    z[s] = np.where(np.arange(m) % 2 == 0, -1.0, rng.uniform(-4.0, -0.3, m))
    normal[s] = np.where((np.arange(m) % 4 < 2)[:, None], [0.0, 0.0, 1.0],
                         normal[s])          # fronto-parallel: z = -1 exactly
    s = cls["across_camera_plane"]
    z[s] = rng.uniform(0.05, 0.6, m)
    scale[s] = rng.uniform(1.0, 3.0, (m, 2))
    logit[s] = rng.normal(size=m) * 0.5 - 3.0  # faint: the tiles stay open
    s = cls["huge"]
    scale[s] = rng.uniform(20.0, 100.0, (m, 2))
    logit[s] = rng.normal(size=m) * 0.5 - 3.0
    s = cls["tiny"]
    scale[s] = 10.0 ** rng.uniform(-5.0, -2.0, (m, 2))
    s = cls["threshold_opacity"]
    eps = np.float32(ALPHA_EPS)
    opacity[s] = np.resize(np.array([
        0.0, eps * 0.5, np.nextafter(eps, np.float32(0)), eps,
        np.nextafter(eps, np.float32(1)), eps * 1.001, eps * 1.5], np.float64),
        m)
    s = cls["near_opaque"]
    opacity[s] = np.resize(np.array([0.998, 0.999, 0.9995, 1.0]), m)
    scale[s] = rng.uniform(0.02, 0.15, (m, 2))

    x = (px - camera.cx) / camera.fx * z
    y = (py - camera.cy) / camera.fy * z
    xyz = np.stack([x, y, z], -1)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    s = cls["edge_on"]
    # the normal perpendicular to the ray through the center, then tilted
    # by nothing, a little and a little more
    ray = xyz[s] / np.linalg.norm(xyz[s], axis=-1, keepdims=True)
    perp = np.cross(ray, rng.normal(size=(m, 3)))
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    tilt = np.resize(np.array([0.0, 1e-6, 1e-4, 1e-3, 1e-2, 5e-2]), m)
    tilted = perp + tilt[:, None] * ray
    normal[s] = tilted / np.linalg.norm(tilted, axis=-1, keepdims=True)

    arrs = [xyz, np.log(scale), _quat_facing(normal), logit[:, None],
            rng.uniform(0.0, 1.0, (n, 3))]
    return [a.astype(np.float32) for a in arrs], opacity.astype(np.float32)


def adversarial_pairs(seed, camera: Camera, chunk, chunks_per_tile=2,
                      per_class=64, device="cpu"):
    """(pair_data (PK_PAD, P) f32, tile_chunks (T+1,) int32) of an
    adversarial scene: every tile gets chunk * chunks_per_tile pairs, half
    of them the surfels whose centers are nearest to the tile, half drawn
    from the whole scene (centers far outside the tile), in random order."""
    arrs, opacity = adversarial_scene(seed, camera, per_class)
    with torch.no_grad():
        proj = project_surfels(*(torch.from_numpy(a) for a in arrs), camera)
    packed = proj.packed.numpy().copy()
    packed[:, PK_OPAC] = np.where(np.isnan(opacity), packed[:, PK_OPAC],
                                  opacity)
    packed = packed[np.isfinite(packed).all(axis=1)]
    center = packed[:, 10:12]
    rng = np.random.default_rng(seed + 1)
    nty, ntx = -(-camera.height // TILE), -(-camera.width // TILE)
    k = chunk * chunks_per_tile
    rows = []
    for t in range(nty * ntx):
        mid = np.array([(t % ntx + 0.5) * TILE, (t // ntx + 0.5) * TILE])
        near = np.argsort(np.linalg.norm(center - mid, axis=1))[:k // 2]
        far = rng.integers(0, packed.shape[0], k - near.shape[0])
        rows.append(rng.permutation(np.concatenate([near, far])))
    pair_data = torch.from_numpy(
        np.ascontiguousarray(packed[np.concatenate(rows)].T))
    tile_chunks = torch.arange(nty * ntx + 1, dtype=torch.int32) \
        * chunks_per_tile
    return pair_data.to(device), tile_chunks.to(device)
