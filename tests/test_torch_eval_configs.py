"""The port's evaluation entry points (vings_mono_tpu_torch/runners/
eval_*.py) against the JAX package's scripts/eval_*.py, without tracking
anything: every configuration they build equal to the script's (captured
where the script hands it on, a sentinel stopping it there), the room
pairs of eval_superpoint bit for bit, GaussianMapper.freeze_buckets
choosing JAX's buckets, and the port's mains unpacking `run.build` by the
port's order (looper and storage told apart by stubs)."""

import argparse
import importlib
import pathlib
import sys
import types

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vings_mono_tpu_torch.runners import (eval_common, eval_droid,  # noqa
                                          eval_long_run, eval_loop_e2e,
                                          eval_superpoint, eval_track_long)


def script(name):
    return importlib.import_module(f"scripts.{name}")


class Captured(Exception):
    def __init__(self, cfg):
        super().__init__("captured")
        self.cfg = cfg


def raise_captured(cfg, *a, **kw):
    raise Captured(cfg)


def capture(fn, *args):
    with pytest.raises(Captured) as e:
        fn(*args)
    return e.value.cfg


def assert_same_cfg(tcfg, jcfg):
    """Equal but for the `device` block, which names each package's own
    device (tpu / cuda) in its defaults."""
    assert tcfg["device"] == {"tracker": "cuda", "mapper": "cuda"}
    strip = lambda c: {k: v for k, v in c.items() if k != "device"}  # noqa
    assert strip(tcfg) == strip(jcfg)


@pytest.fixture
def no_compile_cache(monkeypatch):
    import vings_mono_tpu.utils.profiling as prof
    monkeypatch.setattr(prof, "enable_compile_cache", lambda *a: None)


# ---- (a) the configurations -------------------------------------------

@pytest.mark.parametrize("overrides", [
    None,
    {"frontend": {"filter_thresh": 1.75, "weight": "w.npz"}},
    {"dataset": {"n_frames": 12}, "mode": "vo", "use_metric": True},
])
def test_default_cfg_is_the_scripts(overrides):
    import copy
    jcfg = script("report_parity").default_cfg(copy.deepcopy(overrides))
    assert_same_cfg(eval_common.default_cfg(copy.deepcopy(overrides)), jcfg)


class FakeVideo:
    counter, count_save = 7, 3


def fake_tracking(seen):
    def run(cfg, save_dir, max_frames=None, device=None):
        seen.append((cfg, max_frames))
        return types.SimpleNamespace(video=FakeVideo())
    return run


def fake_ate(seen):
    # a different ATE per lane, so that the verdicts are exercised
    return lambda run_dir, dataset: 0.5 / (1 + len(seen))


@pytest.mark.parametrize("argv", [[], ["--frames", "12",
                                        "--filter-thresh", "0.5",
                                        "--weights", "w.npz"]])
def test_eval_droid_lanes_are_the_scripts(argv, monkeypatch,
                                          no_compile_cache, capsys):
    """All three lanes' configurations, frame counts and the verdicts
    over the same (fake) ATEs and keyframe counts."""
    import vings_mono_tpu.runners.evaluate as jev
    import vings_mono_tpu.runners.run_tracking as jrt
    import vings_mono_tpu_torch.runners.evaluate as tev
    import vings_mono_tpu_torch.runners.run_tracking as trt
    jseen, tseen = [], []
    monkeypatch.setattr(jrt, "run", fake_tracking(jseen))
    monkeypatch.setattr(jev, "eval_trajectory", fake_ate(jseen))
    monkeypatch.setattr(trt, "run", fake_tracking(tseen))
    monkeypatch.setattr(tev, "eval_trajectory", fake_ate(tseen))
    jout = script("eval_droid").main(argv)
    tout = eval_droid.main(argv + ["--device", "cpu"])
    assert tout == jout
    assert len(tseen) == len(jseen) == 3
    for (tcfg, tn), (jcfg, jn) in zip(tseen, jseen):
        assert tn == jn
        assert_same_cfg(tcfg, jcfg)


@pytest.mark.parametrize("argv", [
    [], ["--grid", "3x2", "--cv", "0.25", "--revs", "1.1"],
    ["--metric-weights", "dpt.npz", "--frames", "24"]])
def test_eval_track_long_combos_are_the_scripts(argv, monkeypatch,
                                                no_compile_cache):
    import vings_mono_tpu.runners.evaluate as jev
    import vings_mono_tpu.runners.run_tracking as jrt
    import vings_mono_tpu_torch.runners.evaluate as tev
    import vings_mono_tpu_torch.runners.run_tracking as trt
    jseen, tseen = [], []
    monkeypatch.setattr(jrt, "run", fake_tracking(jseen))
    monkeypatch.setattr(jev, "eval_trajectory", fake_ate(jseen))
    monkeypatch.setattr(trt, "run", fake_tracking(tseen))
    monkeypatch.setattr(tev, "eval_trajectory", fake_ate(tseen))
    jout = script("eval_track_long").main(argv)
    tout = eval_track_long.main(argv + ["--device", "cpu"])
    assert tout == jout
    assert len(tseen) == len(jseen) >= 1
    for (tcfg, tn), (jcfg, jn) in zip(tseen, jseen):
        assert tn == jn
        assert_same_cfg(tcfg, jcfg)


@pytest.mark.parametrize("argv", [
    [],
    ["--frames", "42", "--revs", "1.0", "--min-history", "12", "--every",
     "2", "--points-per-frame", "2000", "--iters1", "3", "--iters2", "2",
     "--cv", "0.5", "--depth-writeback", "1", "--lightglue", "lg.npz"],
    ["--droid-weights", "", "--metric-weights", "dpt.npz",
     "--weights", "sp.npz"]])
def test_eval_loop_e2e_config_is_the_scripts(argv, monkeypatch,
                                             no_compile_cache):
    import vings_mono_tpu.runners.run as jrun
    import vings_mono_tpu_torch.runners.run as trun
    monkeypatch.setattr(jrun, "build", raise_captured)
    monkeypatch.setattr(trun, "build", raise_captured)
    jcfg = capture(script("eval_loop_e2e").main, argv)
    tcfg = capture(eval_loop_e2e.main, argv + ["--device", "cpu"])
    assert_same_cfg(tcfg, jcfg)
    assert_same_cfg(eval_loop_e2e.config(eval_loop_e2e.parse_args(argv)),
                    jcfg)


LONG_RUN_ARGS = argparse.Namespace(
    frames=320, revs=2.2, filter_thresh=1.75, page_dist=1.2,
    weights="sp.npz", lightglue=None, droid_weights="droid.npz")


@pytest.mark.parametrize("lane", [(True, True, True), (False, True, False),
                                  (False, False, False)])
def test_eval_long_run_lanes_are_the_scripts(lane):
    jcfg = script("eval_long_run")._cfg(LONG_RUN_ARGS, *lane)
    assert_same_cfg(eval_long_run._cfg(LONG_RUN_ARGS, *lane), jcfg)


@pytest.mark.parametrize("argv", [[], ["--frames", "300", "--revs", "1.5",
                                       "--page-dist", "0.8",
                                       "--filter-thresh", "2.4"]])
def test_eval_long_run_main_config_is_the_scripts(argv, monkeypatch,
                                                  no_compile_cache):
    import vings_mono_tpu.runners.run as jrun
    import vings_mono_tpu_torch.runners.run as trun
    monkeypatch.setattr(jrun, "build", raise_captured)
    monkeypatch.setattr(trun, "build", raise_captured)
    jcfg = capture(script("eval_long_run").main, argv)
    tcfg = capture(eval_long_run.main, argv + ["--device", "cpu"])
    assert_same_cfg(tcfg, jcfg)


def test_defaults_are_the_scripts(monkeypatch, no_compile_cache):
    """Every argument of every script, with its default, and --device."""
    parsers = []

    def stop(self, args=None, namespace=None):
        parsers.append(self)
        raise Captured(None)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    for name, mod in (("eval_superpoint", eval_superpoint),
                      ("eval_droid", eval_droid),
                      ("eval_track_long", eval_track_long),
                      ("eval_loop_e2e", eval_loop_e2e),
                      ("eval_long_run", eval_long_run)):
        acts = []
        for main in (script(name).main, mod.main):
            with pytest.raises(Captured):
                main([])
            acts.append({a.dest: (a.option_strings, a.default, a.type,
                                  a.nargs, a.const)
                         for a in parsers[-1]._actions if a.dest != "help"})
        jax_acts, port_acts = acts
        assert port_acts.pop("device") == (["--device"], None, None, None,
                                           None), name
        assert port_acts == jax_acts, name


# ---- (b) the room pairs --------------------------------------------------

def test_pair_is_the_scripts_bit_for_bit():
    jrng = np.random.default_rng(eval_superpoint.SEED)
    trng = np.random.default_rng(eval_superpoint.SEED)
    jpair = script("eval_superpoint")._pair
    for hw in ((48, 64), (60, 80), (96, 128)):      # three rng states
        j, t = jpair(jrng, *hw), eval_superpoint._pair(trng, *hw)
        assert len(j) == len(t) == 7
        for a, b in zip(j, t):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ---- (e) freeze_buckets --------------------------------------------------

FREEZE_CFG = {"mapper": {"capacity": 4096, "pair_capacity": 1 << 14,
                         "chunk": 128, "side": 3, "kf_capacity": 4,
                         "visible_capacity": 1 << 12,
                         "points_per_frame": 100,
                         "points_first_frame": 200}}
# (n_padded, overflow, coarse (n_padded, overflow) or None): an overflow
# jump to max, a descent by three votes, a rise by one step, and a last
# overflow that leaves both caches at max, above any demand seen
BEFORE = [(3000, True, (900, False)), (2000, False, (800, False)),
          (2100, False, (850, False)), (1900, False, None),
          (5000, False, (2600, False)), (3100, True, (2700, True))]
AFTER = [(16000, True, (8000, True)), (100, False, (50, False)),
         (100, False, (50, False)), (100, False, (50, False)),
         (100, False, (50, False))]


def mappers():
    from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
    from vings_mono_tpu.utils.config import load_config as jload
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper as TMapper
    from vings_mono_tpu_torch.utils.config import load_config as tload
    jm = JMapper(jload(overrides=FREEZE_CFG))
    tm = TMapper(tload(overrides=FREEZE_CFG), device="cpu")
    return jm, tm


def feed(jm, tm, seq):
    for n, ov, coarse in seq:
        jm._tune_pair_capacity(None, pulled=(n, ov))
        tm._tune_pair_capacity(n, ov)
        if coarse is not None:
            jm._tune_pair_capacity(None, sfx="_c", pulled=coarse)
            tm._tune_pair_capacity(*coarse, sfx="_c")
        assert tm.bin_kwargs == jm.bin_kwargs
        assert tm.bin_kwargs_c == jm.bin_kwargs_c


def test_freeze_buckets_chooses_jax_buckets():
    jm, tm = mappers()
    feed(jm, tm, BEFORE)
    settled = (dict(tm.bin_kwargs), dict(tm.bin_kwargs_c))
    jm.freeze_buckets()
    tm.freeze_buckets()
    frozen = (dict(tm.bin_kwargs), dict(tm.bin_kwargs_c))
    assert frozen == (jm.bin_kwargs, jm.bin_kwargs_c)
    # the hysteresis sat above the largest demand: the freeze moved down
    assert frozen[0]["p_cap"] < settled[0]["p_cap"]
    assert frozen[1]["p_cap"] < settled[1]["p_cap"]
    assert frozen[0]["p_cap"] >= max(n for n, _, _ in BEFORE)
    feed(jm, tm, AFTER)
    assert (tm.bin_kwargs, tm.bin_kwargs_c) == frozen


def test_freeze_buckets_drains_pending_stats():
    """Stats still pending (drained every `stats_every` keyframes) count
    toward the frozen bucket."""
    jm, tm = mappers()
    feed(jm, tm, BEFORE[:2])
    tm._pending_stats = [(6000, False, 20.0, (2600, False))]
    jm._tune_pair_capacity(None, pulled=(6000, False))
    jm._tune_pair_capacity(None, sfx="_c", pulled=(2600, False))
    jm.freeze_buckets()
    tm.freeze_buckets()
    assert tm._pending_stats == []
    assert (tm.bin_kwargs, tm.bin_kwargs_c) == (jm.bin_kwargs,
                                                jm.bin_kwargs_c)


# ---- (f) run.build's order -----------------------------------------------

class StubLooper:
    def __init__(self, log):
        self.log = log
        self.closed_at = []
        self.loop_traces = []
        self.detector = types.SimpleNamespace(traces=[], detect=None)

    def run(self, mapper, tracker, viz_out, idx):
        assert isinstance(mapper, StubMapper)
        assert isinstance(tracker, StubTracker)
        self.log.append(("loop", idx))
        self.closed_at.append(idx)
        self.loop_traces.append({"cur_gid": idx, "cand_gid": 0,
                                 "rejected": "stub"})


class StubStorage:
    pages_out = pages_in = evict_events = pagein_events = 0
    n_host = 5

    def __init__(self, log):
        self.log = log

    def run(self, tracker, mapper, viz_out):
        assert isinstance(tracker, StubTracker)
        assert isinstance(mapper, StubMapper)
        self.log.append(("page",))


class StubMapper:
    n_alive = 11

    def __init__(self, log):
        self.log = log

    def run(self, viz_out):
        self.log.append(("map",))

    def close(self):
        self.log.append(("close",))


class StubTracker:
    video = types.SimpleNamespace(_tstamp_save=np.zeros(0), count_save=0,
                                  tstamps_host=[])

    def __init__(self, log):
        self.log = log

    def track(self, pkt):
        self.log.append(("track",))


class StubDataset(list):
    tex = None


def stub_build(log):
    def build(cfg, device=None):
        assert str(device) == "cpu"
        return (StubDataset([{"rgb": None}] * int(cfg["dataset"]
                                                  ["n_frames"])),
                StubTracker(log), StubMapper(log),
                StubStorage(log) if cfg.get("use_storage_manager") else None,
                StubLooper(log) if cfg.get("use_loop") else None,
                None, None)
    return build


@pytest.fixture
def stubbed(monkeypatch):
    """run.build, the middleware's packaging, the ATE and the PSNR and the
    global BA replaced by stubs; returns the calls' log."""
    import vings_mono_tpu_torch.middleware as mw
    import vings_mono_tpu_torch.runners.evaluate as tev
    import vings_mono_tpu_torch.runners.run as trun
    import vings_mono_tpu_torch.tracker.backend as backend
    log = []
    monkeypatch.setattr(trun, "build", stub_build(log))
    monkeypatch.setattr(mw, "judge_and_package", lambda tr, cfg: {})
    monkeypatch.setattr(eval_common, "ate_now", lambda *a: 0.25)
    monkeypatch.setattr(eval_loop_e2e, "ate_now", lambda *a: 0.25)
    monkeypatch.setattr(eval_long_run, "ate_now", lambda *a: 0.25)
    monkeypatch.setattr(tev, "eval_psnr", lambda mapper, tracker: 20.0)

    class StubBA:
        def __init__(self, tracker, cfg, extra_edges=()):
            assert isinstance(tracker, StubTracker)
            log.append(("gba", list(extra_edges)))

        def run(self):
            return {"frames": 1, "edges": 2, "skipped": False}
    monkeypatch.setattr(backend, "GlobalBA", StubBA)
    return log


def test_eval_loop_e2e_unpacks_build_by_the_ports_order(stubbed):
    out = eval_loop_e2e.main(["--frames", "18", "--skip-baseline",
                              "--device", "cpu"])
    loops = [e for e in stubbed if e[0] == "loop"]
    # keyframes 15 and 18 (every 3 after 12)
    assert [e[1] for e in loops] == [14, 17]
    assert not any(e[0] == "page" for e in stubbed)
    assert out["loops_closed"] == 2 and out["keyframes"] == 18
    assert stubbed[-1] == ("close",)


def test_eval_long_run_unpacks_build_by_the_ports_order(stubbed):
    out = eval_long_run.main(["--frames", "20", "--device", "cpu"])
    full, base = out["full"], out["no_loop"]
    assert full["loops_closed"] == 2 and "loops_closed" not in base
    assert full["host_rows_end"] == 5 and full["peak_gaussians"] == 16
    assert [e for e in stubbed if e[0] == "page"] == [("page",)] * 4
    assert full["global_ba_loop_edges"] == 0 and full["psnr"] == 20.0
    assert ("gba", []) in stubbed
