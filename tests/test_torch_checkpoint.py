"""Port parity for whole-session checkpoints (`utils/checkpoint.py`): the
two packages write the same file layout, so a session of either loads in
the other.

The configuration is tests/test_pipeline.py's (48x64, the `synthetic`
sequence, the naive JAX mapper) with the self-trained DroidNet in f32 and a
rollup at the 10th keyframe, so the session holds saved keyframes, live
and inactive edges. Edge slot 0 is kept out of both packages' free lists,
as in tests/test_torch_tracker.py (`both_trackers` says why).

Tolerances: a session's arrays load bit for bit, and the correlation
pyramids rebuilt from its feature maps equal JAX's to one bf16 rounding
step (relative 2^-7: the f32 products are summed in another order before
both round them to bf16); after a load both
packages track three more frames and their poses agree within 1e-2, the
tolerance tests/test_torch_tracker.py holds the two trackers to after a
sequence (the bf16 lookup volumes round differently in the two), and the
host bookkeeping (edge lists, slots, counters) is equal."""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pipeline import make_cfg as j_make_cfg
from test_torch_tracker import host_state
from vings_mono_tpu.datasets.base import get_dataset as j_get_dataset
from vings_mono_tpu.runners import run as j_run_mod
from vings_mono_tpu.utils import checkpoint as jckpt
from vings_mono_tpu_torch.runners import run as run_t
from vings_mono_tpu_torch.utils import checkpoint as tckpt
from vings_mono_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "vings_mono_tpu/weights/droid_selftrained.npz")
N_SAVE, N_END = 11, 14
FILES = ("video.npz", "save_buffers.npz", "graph.npz", "mapper.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(tmp):
    jcfg = j_make_cfg(tmp / "jax")
    jcfg["frontend"].update({"weight": WEIGHTS, "bf16_gru": False,
                             "rollup_at": 9, "rollup_n": 4})
    over = {k: jcfg[k] for k in ("mode", "dataset", "frontend",
                                 "training_args", "middleware")}
    over["mapper"] = {k: v for k, v in jcfg["mapper"].items()
                      if k != "impl"}
    over["output"] = {"save_dir": str(tmp / "torch")}
    return jcfg, load_config(overrides=over)


def no_slot_zero(build):
    def wrapped(*a, **k):
        out = build(*a, **k)
        out[1].graph.free_slots.remove(0)
        return out
    return wrapped


def port_build(tcfg):
    dataset, tracker, mapper, *_ = no_slot_zero(run_t.build)(tcfg,
                                                             device="cpu")
    return dataset, tracker, mapper


def jax_build(jcfg):
    _, tracker, mapper, *_ = no_slot_zero(j_run_mod.build)(jcfg)
    return tracker, mapper


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """JAX tracks and maps N_SAVE frames and saves its session; the port
    does the same from the same configuration and saves its own."""
    tmp = tmp_path_factory.mktemp("sessions")
    jcfg, tcfg = cfgs(tmp)
    jdir = str(tmp / "jax" / "run")
    os.makedirs(os.path.join(jdir, "ply"))
    mp = pytest.MonkeyPatch()
    mp.setattr(j_run_mod, "build", no_slot_zero(j_run_mod.build))
    try:
        jtr, jmap, _ = j_run_mod.run(jcfg, jdir, max_frames=N_SAVE)
    finally:
        mp.undo()
    jckpt.save_session(str(tmp / "jax_session"), jtr, jmap)
    mp.setattr(run_t, "build", no_slot_zero(run_t.build))
    try:
        ttr, tmap, _ = run_t.run(tcfg, str(tmp / "torch" / "run"),
                                 max_frames=N_SAVE, device="cpu")
    finally:
        mp.undo()
    tckpt.save_session(str(tmp / "torch_session"), ttr, tmap)
    # the tests track the live trackers on: their state at the save
    return dict(tmp=tmp, jcfg=jcfg, tcfg=tcfg, jtr=jtr, ttr=ttr,
                jmap=jmap, tmap=tmap, j_counter=jtr.video.counter,
                t_host=host_state(ttr),
                jax=str(tmp / "jax_session"),
                torch=str(tmp / "torch_session"))


def track_on(tracker, dataset):
    for idx in range(N_SAVE, N_END):
        tracker.track(dict(dataset[idx]))


def test_jax_session_tracks_on_in_the_port_as_in_jax(sessions):
    """JAX's session loads into a fresh port tracker bit for bit; then JAX
    (live) and the port (loaded) track frames 11-13 alike."""
    s = sessions
    dataset, ttr, tmap = port_build(s["tcfg"])
    tckpt.load_session(s["jax"], ttr, tmap)
    jtr = s["jtr"]
    assert jtr.video.count_save > 0 and len(jtr.graph.ii_inac) > 0
    assert host_state(ttr) == host_state(jtr)
    for f in ttr.video.bufs.fields():
        np.testing.assert_array_equal(
            getattr(ttr.video.bufs, f).numpy(),
            np.asarray(getattr(jtr.video.bufs, f)), err_msg=f)
    n = jtr.graph.slot
    for f in ("net", "inp", "target", "weight"):
        np.testing.assert_array_equal(
            getattr(ttr.graph.edges, f).numpy()[n],
            np.asarray(getattr(jtr.graph.edges, f))[n], err_msg=f)
    # the rebuilt pyramids are the ones JAX built when it added the edges,
    # to one bf16 rounding step: both store the f32 products as bf16, and
    # the products' sum orders differ
    for f in ("corr1", "corr4"):
        np.testing.assert_allclose(
            getattr(ttr.graph.edges, f).float().numpy()[n],
            np.asarray(jnp.asarray(getattr(jtr.graph.edges, f),
                                   jnp.float32))[n], rtol=2.0 ** -7,
            atol=1e-6, err_msg=f)
    jmap = s["jmap"]
    assert (tmap.time_idx, list(tmap.history), tmap.initialized) == \
        (jmap.time_idx, list(jmap.history), jmap.initialized)
    np.testing.assert_array_equal(tmap.state.xyz.numpy(),
                                  np.asarray(jmap.state.xyz))
    track_on(jtr, j_get_dataset(s["jcfg"]))
    track_on(ttr, dataset)
    assert host_state(ttr) == host_state(jtr)
    c = jtr.video.counter
    np.testing.assert_allclose(ttr.video.bufs.poses[:c + 1].numpy(),
                               np.asarray(jtr.video.bufs.poses)[:c + 1],
                               atol=1e-2)
    assert np.isfinite(ttr.video.bufs.poses.numpy()).all()


def test_port_round_trip_is_exact(sessions, tmp_path):
    """Port save -> load into a fresh port tracker and mapper -> save: the
    same arrays and the same host state."""
    s = sessions
    _, ttr, tmap = port_build(s["tcfg"])
    tckpt.load_session(s["torch"], ttr, tmap)
    again = str(tmp_path / "again")
    tckpt.save_session(again, ttr, tmap)
    for name in FILES:
        with np.load(os.path.join(s["torch"], name)) as a, \
                np.load(os.path.join(again, name)) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ha, hb = tckpt.load_host(s["torch"]), tckpt.load_host(again)
    assert pickle.dumps(ha) == pickle.dumps(hb)
    assert host_state(ttr) == s["t_host"]


def test_port_session_loads_in_jax(sessions):
    """The port's session loads into a fresh JAX tracker and mapper; then
    JAX (loaded) and the port (live) track frames 11-13 alike."""
    from vings_mono_tpu.utils.checkpoint import load_session as j_load
    s = sessions
    jtr, jmap = jax_build(s["jcfg"])
    j_load(s["torch"], jtr, jmap)
    ttr = s["ttr"]
    assert host_state(jtr) == host_state(ttr)
    np.testing.assert_array_equal(np.asarray(jtr.video.bufs.poses),
                                  ttr.video.bufs.poses.numpy())
    assert (jmap.time_idx, list(jmap.history)) == \
        (s["tmap"].time_idx, list(s["tmap"].history))
    track_on(jtr, j_get_dataset(s["jcfg"]))
    track_on(ttr, run_t.build(s["tcfg"], device="cpu")[0])
    assert host_state(jtr) == host_state(ttr)
    c = ttr.video.counter
    np.testing.assert_allclose(np.asarray(jtr.video.bufs.poses)[:c + 1],
                               ttr.video.bufs.poses[:c + 1].numpy(),
                               atol=1e-2)


def test_host_state_naming_jax_is_refused(tmp_path):
    """A host.pkl that names a `jax` global is refused before anything of it
    is built; a plain one loads."""
    (tmp_path / "host.pkl").write_bytes(pickle.dumps(
        {"counter": jnp.zeros(2)}))
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        tckpt.load_host(str(tmp_path))
    (tmp_path / "host.pkl").write_bytes(pickle.dumps({"counter": 3}))
    assert tckpt.load_host(str(tmp_path)) == {"counter": 3}


def test_loading_a_jax_session_imports_no_jax(sessions):
    """In a fresh interpreter, loading JAX's session into the port leaves
    neither jax nor the JAX package in sys.modules."""
    code = (
        "import sys, json\n"
        "from vings_mono_tpu_torch.runners.run import build\n"
        "from vings_mono_tpu_torch.utils.checkpoint import load_session\n"
        "from vings_mono_tpu_torch.utils.config import load_config\n"
        f"cfg = load_config(overrides=json.loads({repr(_json(sessions))}))\n"
        "_, tr, m, *_ = build(cfg, device='cpu')\n"
        f"load_session({sessions['jax']!r}, tr, m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'vings_mono_tpu')]\n"
        "print('counter', tr.video.counter, 'bad', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"counter {sessions['j_counter']} bad []" in out.stdout


def _json(sessions):
    import json
    c = sessions["tcfg"]
    over = {k: c[k] for k in ("mode", "dataset", "training_args",
                              "middleware", "mapper")}
    # build sets the dataset's camera-to-IMU extrinsic, an array
    over["frontend"] = {k: v for k, v in c["frontend"].items() if k != "c2i"}
    return json.dumps(over)
