"""The frontend monitor (`utils/monitor.py`), its wiring into the port's
frontend (`frontend.show_plot`), and the experiment logger
(`utils/logging.py`) against the JAX package's. The monitor's records are
host float64 math on the same poses: equal to 1e-12."""

import json

import numpy as np
import pytest
import torch

from test_torch_tracker import make_cfgs
from test_tracker import H, W, frames
from vings_mono_tpu.utils.logging import Logger as JLogger
from vings_mono_tpu.utils.monitor import FrontendMonitor as JMonitor
from vings_mono_tpu_torch.tracker.tracker import Tracker
from vings_mono_tpu_torch.utils.logging import Logger
from vings_mono_tpu_torch.utils.monitor import FrontendMonitor


class _Video:
    counter = 3
    tstamps_host = [0.0, 0.1, 0.2]

    def c2w_matrices(self):
        m = np.tile(np.eye(4)[None], (3, 1, 1))
        m[:, :3, 3] = [[0, 0, 0], [0.5, 0.2, 0.1], [1.0, 0.3, 0.2]]
        c, s = np.cos(0.3), np.sin(0.3)
        m[2, :2, :2] = [[c, -s], [s, c]]
        return m


class _Frontend:
    video = _Video()
    t1 = 3
    inertial = None


@pytest.mark.parametrize("with_gt", [False, True], ids=["plain", "gt"])
def test_frontend_monitor_writes_its_png(tmp_path, with_gt):
    """As JAX's tests/test_aux.py test_frontend_monitor, and the records
    (position, attitude minus the truth's, bias) equal JAX's."""
    gt = {"timestamps": np.asarray([0.0, 0.1, 0.2]),
          "c2ws": [np.eye(4)] * 3} if with_gt else None
    png = tmp_path / "mon.png"
    mon = FrontendMonitor({}, gt_dict=gt, save_path=str(png), live=False)
    jmon = JMonitor({}, gt_dict=gt, save_path=str(tmp_path / "j.png"),
                    live=False)
    mon.record(_Frontend())
    jmon.record(_Frontend())
    mon.render()
    assert png.exists() and png.stat().st_size > 0
    for k in ("t", "pos", "att", "bias"):
        np.testing.assert_allclose(np.asarray(getattr(mon, k)),
                                   np.asarray(getattr(jmon, k)), atol=1e-12)
    assert abs(mon.att[0][0] - np.degrees(0.3)) < 1e-9


def test_show_plot_draws_the_panel_at_rollup(tmp_path):
    """frontend.show_plot on the port's tracker: one record per keyframe
    decision after initialization, and the PNG written at the rollup."""
    _, cfg = make_cfgs(show_plot=True)
    cfg["output"] = {"save_dir": str(tmp_path)}
    tr = Tracker(cfg, H, W, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    mon = tr.frontend.monitor
    assert isinstance(mon, FrontendMonitor) and not mon.live
    first = None
    for k, pkt in enumerate(frames(16, np.random.default_rng(0))):
        tr.track(pkt)
        if first is None and (tmp_path / "monitor.png").exists():
            first = k
            assert tr.frontend.did_rollup
    assert first is not None and tr.video.count_save > 0
    assert (tmp_path / "monitor.png").stat().st_size > 0
    assert len(mon.t) == tr.frontend.count
    assert np.isfinite(np.asarray(mon.pos)).all()


def test_logger_writes_jsonl_as_jax(tmp_path, monkeypatch):
    """`use_wandb` without wandb installed: both loggers write the same
    JSONL lines (time stamps aside), and log_time pairs its calls."""
    import builtins
    real_import = builtins.__import__

    def no_wandb(name, *a, **k):
        if name == "wandb":
            raise ImportError("no wandb")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_wandb)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    cfg = {"use_wandb": True}
    logs = [Logger(cfg, save_dir=str(tmp_path / "t")),
            JLogger(cfg, save_dir=str(tmp_path / "j"))]
    for log in logs:
        assert log.wandb is None
        log.log_once("psnr", np.float32(21.5), step=3)
        log.log_time("map")
        log.log_time("map")
    logs[0].close()
    logs[1].jsonl.close()
    rows = [[json.loads(x) for x in (tmp_path / d / "metrics.jsonl")
             .read_text().splitlines()] for d in ("t", "j")]
    for got, want in zip(*rows):
        assert (got["name"], got["step"]) == (want["name"], want["step"])
    assert [r["name"] for r in rows[0]] == ["psnr", "time/map_ms"]
    assert rows[0][0]["value"] == 21.5 and rows[0][1]["value"] >= 0.0
