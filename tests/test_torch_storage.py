"""Port parity for the storage manager (storage/manager.py): the port's
StorageManager and the JAX package's on the same fake mapper state and
camera path (mirroring tests/test_storage.py). Paging decisions and
counters equal at every step; rows paged out and back in equal the rows
before eviction bit for bit, in every field of FIELDS; every page-in drops
the mapper's binning cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.mapper.state import adam_init as j_adam_init
from vings_mono_tpu.mapper.state import empty_state as j_empty_state
from vings_mono_tpu.storage.manager import StorageManager as JStorage
from vings_mono_tpu_torch.mapper.state import adam_init, empty_state
from vings_mono_tpu_torch.storage.manager import FIELDS, StorageManager
from vings_mono_tpu_torch.utils.config import load_config

COUNTERS = ("n_host", "pages_out", "pages_in", "evict_events",
            "pagein_events")


class FakeMapper:
    def __init__(self, state, opt):
        self.state, self.opt = state, opt
        self.initialized = True
        self._binned = object()
        self.invalidations = 0

    def invalidate_binning(self):
        self._binned = None
        self.invalidations += 1


class FakeVideo:
    def __init__(self, poses_save, count_save):
        self.poses_save = poses_save
        self.count_save = count_save

    def c2w_matrices(self):
        return np.tile(np.eye(4), (0, 1, 1))


class FakeTracker:
    def __init__(self, poses_save, count_save):
        self.video = FakeVideo(poses_save, count_save)


def make_viz(cur_c2w, last_gid, tensors):
    poses = np.stack([cur_c2w]).astype(np.float32)
    gids = np.asarray([last_gid])
    if tensors:
        return {"poses": torch.from_numpy(poses),
                "global_kf_id": torch.from_numpy(gids).to(torch.int32),
                "global_kf_id_host": gids}
    return {"poses": poses, "global_kf_id": gids}


def seeded_rows(n_kf, per_kf, seed=0):
    rng = np.random.default_rng(seed)
    total = n_kf * per_kf
    rows = {
        "xyz": rng.normal(size=(total, 3)).astype(np.float32),
        "rgb": rng.uniform(size=(total, 3)).astype(np.float32),
        "log_scale": rng.normal(size=(total, 2)).astype(np.float32),
        "quat": rng.normal(size=(total, 4)).astype(np.float32),
        "logit_opacity": rng.normal(size=(total, 1)).astype(np.float32),
        "stable": rng.uniform(size=total) < 0.5,
        "local_scores": rng.uniform(size=(total, 2)).astype(np.float32),
        "global_scores": rng.uniform(size=(total, 2)).astype(np.float32),
        "globalkf_id": np.repeat(np.arange(n_kf, dtype=np.int32), per_kf),
        "globalkf_max_scores": rng.uniform(size=total).astype(np.float32),
    }
    rows["xyz"][:, 0] += rows["globalkf_id"].astype(np.float32)
    return rows


def both_mappers(rows, cap):
    n = len(rows["xyz"])
    js = j_empty_state(cap)
    js = js.replace(alive=js.alive.at[:n].set(True), **{
        f: getattr(js, f).at[:n].set(jnp.asarray(rows[f])) for f in FIELDS})
    ts = empty_state(cap, "cpu")
    ts.alive[:n] = True
    for f in FIELDS:
        getattr(ts, f)[:n] = torch.from_numpy(rows[f])
    return FakeMapper(js, j_adam_init(js)), FakeMapper(ts, adam_init(ts))


def resident_rows(state, gid):
    """The rows of keyframe gid on the device, sorted by xyz: numpy per
    field."""
    get = (lambda f: getattr(state, f).numpy()) if isinstance(
        state.xyz, torch.Tensor) else (lambda f: np.asarray(getattr(state,
                                                                    f)))
    m = get("alive") & (get("globalkf_id") == gid)
    order = np.lexsort(get("xyz")[m].T)
    return {f: get(f)[m][order] for f in FIELDS}


def test_storage_roundtrip():
    """tests/test_storage.py's two-keyframe round trip in the port."""
    cfg = load_config(overrides={
        "storage_manager": {"distance_threshold": 10.0}})
    mgr = StorageManager(cfg)
    n = 200
    rows = seeded_rows(2, 100)
    rows["xyz"][:] = 0.0
    rows["xyz"][100:, 0] = 50.0
    rows["stable"][:] = False
    rows["stable"][:50] = True
    _, mapper = both_mappers(rows, 512)
    poses_save = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (3, 1))
    poses_save[1, 0] = -50.0
    tracker = FakeTracker(poses_save, count_save=2)
    mgr.run(tracker, mapper, make_viz(np.eye(4), 2, tensors=True))
    assert mgr.n_host == 100 and mgr.pages_out == 100
    assert int(mapper.state.n_alive()) == 100
    assert mgr.place[1] == 0 and mgr.place[0] == 1
    assert mgr.bytes_out == 100 * (12 + 12 + 8 + 16 + 4 + 1 + 8 + 8 + 4 + 4)
    cur2 = np.eye(4)
    cur2[0, 3] = 50.0
    mgr.run(tracker, mapper, make_viz(cur2, 2, tensors=True))
    assert int(mapper.state.n_alive()) == 100
    assert mgr.place[1] == 1 and mgr.place[0] == 0
    st = mapper.state
    assert torch.all(st.globalkf_id[st.alive] == 1)
    assert mapper._binned is None and mapper.invalidations == 1
    assert mgr.n_host == 100 and mgr.pages_in == 100
    assert int(np.asarray(mgr.host["stable"]).sum()) == 50
    assert mgr.host["stable"].dtype == np.bool_
    assert mgr.host["globalkf_id"].dtype == np.int32
    assert int(mapper.state.n_alive()) + mgr.n_host == n


@pytest.mark.parametrize("cap_extra", [64, 0])
def test_paging_matches_jax_step_by_step(cap_extra):
    """20 keyframes x 24 Gaussians, keyframe k at x = k; the camera sweeps
    the line out and back twice with a 4-unit radius. Counters, placement
    and host-store sizes equal JAX's after every step; at the end each
    resident keyframe's rows are bit-identical to the seeded ones. With no
    spare capacity (cap_extra 0) some page-ins do not fit and stay on the
    host, in both packages alike."""
    n_kf, per_kf = 20, 24
    rows = seeded_rows(n_kf, per_kf)
    total = n_kf * per_kf
    jmap, tmap = both_mappers(rows, total + cap_extra)
    cfg = load_config(overrides={
        "storage_manager": {"distance_threshold": 4.0}})
    jm, tm = JStorage(cfg), StorageManager(cfg)
    poses_save = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                         (n_kf, 1))
    poses_save[:, 0] = -np.arange(n_kf, dtype=np.float32)
    tracker = FakeTracker(poses_save, count_save=n_kf)
    path = (list(range(0, n_kf, 3)) + list(range(n_kf - 1, -1, -3))) * 2
    for x in path:
        cur = np.eye(4)
        cur[0, 3] = float(x)
        jm.run(tracker, jmap, make_viz(cur, n_kf, tensors=False))
        tm.run(tracker, tmap, make_viz(cur, n_kf, tensors=True))
        for k in COUNTERS:
            assert getattr(tm, k) == getattr(jm, k), (x, k)
        np.testing.assert_array_equal(tm.place, jm.place)
        assert int(tmap.state.n_alive()) == int(jmap.state.n_alive())
        assert int(tmap.state.n_alive()) + tm.n_host == total
        assert (tmap._binned is None) == (jmap._binned is None)
        jmap._binned = tmap._binned = object()
    assert tm.pages_out > 0 and tm.pages_in > 0 and tm.pagein_events > 1
    for f in FIELDS:
        np.testing.assert_array_equal(np.sort(tm.host[f], axis=0),
                                      np.sort(np.asarray(jm.host[f]), axis=0))
    seeded = {f: rows[f] for f in FIELDS}
    resident = np.where(tm.place == 1)[0]
    assert len(resident) > 0
    for gid in resident:
        got = resident_rows(tmap.state, gid)
        want_m = seeded["globalkf_id"] == gid
        order = np.lexsort(seeded["xyz"][want_m].T)
        if len(got["xyz"]) < per_kf:      # an overflow left rows on host
            assert cap_extra == 0
            continue
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], seeded[f][want_m][order],
                                          err_msg=f)
        jgot = resident_rows(jmap.state, gid)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], jgot[f], err_msg=f)


def test_page_in_resets_adam_moments_and_revives_rows():
    """Paged-in rows land in dead slots with fresh Adam moments and are
    alive for the next render."""
    rows = seeded_rows(2, 8)
    _, mapper = both_mappers(rows, 32)
    for k in mapper.opt.m:
        mapper.opt.m[k].fill_(1.0)
        mapper.opt.v[k].fill_(1.0)
    cfg = load_config(overrides={
        "storage_manager": {"distance_threshold": 0.5}})
    mgr = StorageManager(cfg)
    poses_save = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (2, 1))
    poses_save[1, 0] = -1.0
    tracker = FakeTracker(poses_save, count_save=2)
    mgr.run(tracker, mapper, make_viz(np.eye(4), 2, tensors=True))
    assert mgr.pages_out == 8
    cur = np.eye(4)
    cur[0, 3] = 1.0
    mgr.run(tracker, mapper, make_viz(cur, 2, tensors=True))
    assert mgr.pages_in == 8 and mgr.pages_out == 16
    st = mapper.state
    back = st.alive & (st.globalkf_id == 1)
    assert int(back.sum()) == 8
    for k in mapper.opt.m:
        assert float(mapper.opt.m[k][back].abs().max()) == 0.0
        assert float(mapper.opt.v[k][back].abs().max()) == 0.0
