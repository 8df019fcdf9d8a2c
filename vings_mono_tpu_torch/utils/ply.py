"""Standard-3DGS-compatible .ply export/import for the Gaussian map.

Field layout and SH-DC conversion mirror the reference's save_ply/load_ply
(vis_utils.py): positions, zero
normals, f_dc_* = (rgb - 0.5) / C0, opacity (logit), scale_{0,1[,2]} (log),
rot_{0..3} (wxyz). 2DGS mode writes 2 scale fields; 3DGS mode pads a third
tiny scale so generic viewers load it.
Pure numpy — no plyfile dependency (binary_little_endian writer/reader).
"""

from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814


def _header(n, scale_fields):
    props = ["x", "y", "z", "nx", "ny", "nz",
             "f_dc_0", "f_dc_1", "f_dc_2", "opacity"]
    props += [f"scale_{i}" for i in range(scale_fields)]
    props += [f"rot_{i}" for i in range(4)]
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {n}"]
    lines += [f"property float {p}" for p in props]
    lines.append("end_header")
    return "\n".join(lines) + "\n", props


def save_ply(path, xyz, rgb, log_scale, quat_wxyz, logit_opacity,
             mode="2dgs"):
    """Arrays are the *raw* (pre-activation) parameters, alive rows only."""
    n = xyz.shape[0]
    scale_fields = 2 if mode == "2dgs" else 3
    header, props = _header(n, scale_fields)
    f_dc = (np.asarray(rgb) - 0.5) / SH_C0
    cols = [np.asarray(xyz, np.float32),
            np.zeros((n, 3), np.float32),
            f_dc.astype(np.float32),
            np.asarray(logit_opacity, np.float32).reshape(n, 1)]
    ls = np.asarray(log_scale, np.float32)
    if mode == "2dgs":
        cols.append(ls[:, :2])
    else:
        third = np.full((n, 1), -10.0, np.float32)  # flat disc in 3DGS form
        cols.append(np.concatenate([ls[:, :2], third], axis=1))
    cols.append(np.asarray(quat_wxyz, np.float32))
    data = np.concatenate(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())


def load_ply(path):
    """Returns dict with xyz, rgb, log_scale, quat, logit_opacity (numpy)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n = int([ln for ln in lines if ln.startswith("element vertex")][0]
                .split()[-1])
        props = [ln.split()[-1] for ln in lines
                 if ln.startswith("property float")]
        data = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4")
    data = data.reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}

    def take(names):
        return data[:, [col[c] for c in names]]

    scale_names = [p for p in props if p.startswith("scale_")][:2]
    rgb = take(["f_dc_0", "f_dc_1", "f_dc_2"]) * SH_C0 + 0.5
    return {
        "xyz": take(["x", "y", "z"]),
        "rgb": rgb,
        "log_scale": take(scale_names),
        "quat": take(["rot_0", "rot_1", "rot_2", "rot_3"]),
        "logit_opacity": take(["opacity"]),
    }
