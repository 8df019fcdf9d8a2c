"""VI init when its alignment fails, in both packages: a recorded
divergence from a working VIO, shared by the JAX package and the port.

`InertialFusion.maybe_initialize` runs the visual-inertial alignment
(VINS-Mono style) and turns the IMU fusion on whatever the alignment
returned. Where the linear alignment solves a scale <= 0 (visual poses
too noisy over the 8-keyframe window, as the self-trained DroidNet gives
on the synthetic room at 176x312 and 232x416), `visual_imu_alignment`
returns False before it scales the states or rotates gravity onto -z,
and the fusion then integrates the IMU with gravity along -z in a frame
where it is not: the states fall at about g. Where it succeeds on such
poses, its scale is far from the truth. Either way profile_configs.py's
VIO families and chip_smoke.py's phase 8 run away after VI init.

Here both packages get the same keyframes of the room's trajectory at
profile_configs.py's F5 pace and the same IMU stream (chip_smoke.py's
`room_imu`): with the true poses at a monocular scale the alignment
succeeds in both (scale and gravity recovered), with the translations
mirrored it fails in both, and both still turn the fusion on with the
states unrotated. No JAX in the port; the test imports both."""

import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from vings_mono_tpu.ops import lie as j_lie
from vings_mono_tpu.tracker.vio import InertialFusion as JFusion
from vings_mono_tpu_torch.datasets.synthetic3d import trajectory_c2w
from vings_mono_tpu_torch.ops import lie as t_lie
from vings_mono_tpu_torch.tracker.vio import InertialFusion as TFusion

N, REVS, DT = 96, 1.25, 0.1          # profile_configs.py's F5 room
KEYFRAMES = list(range(0, 28, 2))    # every second frame, 14 keyframes
GAUGE = 0.5                          # the visual poses' monocular scale
# the true poses recover the scale to this share and gravity to this angle
SCALE_REL, GRAVITY_DEG = 0.02, 2.0


def keyframe_c2ws(mirror):
    c2w = np.stack([trajectory_c2w(k, N, revs=REVS) for k in KEYFRAMES])
    c2w[:, :3, 3] *= -GAUGE if mirror else GAUGE
    return c2w


class JaxBufs:
    def __init__(self, poses, disps):
        self.poses, self.disps = poses, disps

    def replace(self, poses, disps):
        return JaxBufs(poses, disps)


def fusion(lib, c2w):
    """One package's InertialFusion over a stand-in video holding the
    keyframes' poses, unit disparities and timestamps."""
    import jax.numpy as jnp
    w2c = np.linalg.inv(c2w)
    if lib == "jax":
        bufs = JaxBufs(j_lie.se3_from_matrix(jnp.asarray(w2c, jnp.float32)),
                       jnp.ones((len(w2c), 4, 4), jnp.float32))
    else:
        bufs = types.SimpleNamespace(
            poses=t_lie.se3_from_matrix(torch.as_tensor(w2c,
                                                        dtype=torch.float32)),
            disps=torch.ones(len(w2c), 4, 4))
    video = types.SimpleNamespace(
        counter=len(KEYFRAMES), bufs=bufs, imu_enabled=False,
        visual_only_init=False,
        tstamps_host=np.asarray(KEYFRAMES, np.float64) * DT)
    cls = JFusion if lib == "jax" else TFusion
    f = cls(video, {"frontend": {}, "mode": "vio"},
            cs.room_imu(N, REVS, DT), np.eye(4))
    f.init_states()
    return f


def initialize(lib, mirror):
    """maybe_initialize at the last keyframe. Returns what each alignment
    returned, the fusion, the gravity error of every window state (deg,
    the state's up against the room's) and the disparity scale applied."""
    f = fusion(lib, keyframe_c2ws(mirror))
    align, returned = f.visual_imu_alignment, []

    def spy(*a, **k):
        returned.append(align(*a, **k))
        return returned[-1]
    f.visual_imu_alignment = spy
    t1 = len(KEYFRAMES)
    f.maybe_initialize(t1)
    err = []
    for i in range(t1 - 8, t1):
        R_true = trajectory_c2w(KEYFRAMES[i], N, revs=REVS)[:3, :3]
        up_true = R_true.T @ np.array([0.0, -1.0, 0.0])  # room's y is down
        up = f.states[i].R.T @ np.array([0.0, 0.0, 1.0])
        err.append(np.degrees(np.arccos(np.clip(up_true @ up, -1.0, 1.0))))
    disp = float(np.asarray(f.video.bufs.disps[0, 0, 0]))
    return returned, f, np.asarray(err), disp


@pytest.fixture(scope="module", params=["true", "mirrored"])
def both(request):
    mirror = request.param == "mirrored"
    return mirror, {lib: initialize(lib, mirror) for lib in ("jax", "torch")}


def test_alignment_outcome_as_jax(both):
    mirror, runs = both
    for lib, (returned, f, err, disp) in runs.items():
        # the excitation gate passed: maybe_initialize went on to align
        assert f.vi_init_t1 == len(KEYFRAMES), lib
        if mirror:
            # no positive scale fits: the alignment gives up, nothing is
            # scaled or rotated
            assert returned == [False, False], (lib, returned)
            assert disp == 1.0, lib
        else:
            assert returned == [True, True], (lib, returned)
            assert abs(1.0 / disp - 1.0 / GAUGE) <= SCALE_REL / GAUGE, \
                (lib, 1.0 / disp)
            assert err.max() <= GRAVITY_DEG, (lib, err)
    # the states agree (measured: 3e-7 in R, 1e-6 in p and v); the
    # gravity angles near 0 deg are arccos's ill-conditioned end, not
    # compared
    (_, fj, _, dj), (_, ft, _, dt) = runs["jax"], runs["torch"]
    assert dt == pytest.approx(dj, rel=1e-5)
    for sj, st in zip(fj.states, ft.states):
        np.testing.assert_allclose(st.R, sj.R, atol=1e-5)
        np.testing.assert_allclose(st.p, sj.p, atol=1e-5)
        np.testing.assert_allclose(st.v, sj.v, atol=1e-4)


def test_fusion_turns_on_after_a_failed_alignment_in_both(both):
    """The divergence itself: after the failed alignment both packages
    enable the IMU fusion with the states' gravity far from -z."""
    mirror, runs = both
    for lib, (returned, f, err, _) in runs.items():
        assert f.imu_enabled and f.video.imu_enabled, lib
        if mirror:
            assert err.min() > 45.0, (lib, err)
