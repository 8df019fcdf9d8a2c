"""The port's websocket server against the JAX package's: the frame decode
(with the EXIF timestamp) and the imu.csv rows are equal byte for byte,
and one frame in and one render out go over a localhost websocket on a
free port, every wait bounded by asyncio.wait_for."""

import asyncio
import base64
import io
import json
import queue
import socket

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")
websockets = pytest.importorskip("websockets")

from vings_mono_tpu.server.server import WebsocketServer as JServer
from vings_mono_tpu_torch.server.server import WebsocketServer

WAIT_S = 20.0


def jpeg(ts=None, seed=0, hw=(24, 32)):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, hw + (3,), np.uint8))
    exif = Image.Exif()
    if ts is not None:
        exif[306] = ts
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90, exif=exif)
    return buf.getvalue()


def servers(tmp_path, port=8765):
    cfg = {"server": {"host": "127.0.0.1", "port": port, "send_hz": 50.0}}
    made = {}
    for name, cls in (("jax", JServer), ("torch", WebsocketServer)):
        made[name] = cls(cfg, queue.Queue(), queue.Queue(),
                         str(tmp_path / name))
    return made


@pytest.mark.parametrize("ts", ["1700000000.123456", "not a time"])
def test_decode_frame_as_jax(tmp_path, ts):
    made = servers(tmp_path)
    payload = jpeg(ts)
    (jt, jrgb), (tt, trgb) = (made[k]._decode_frame(payload)
                              for k in ("jax", "torch"))
    assert trgb.dtype == jrgb.dtype == np.float32
    assert np.array_equal(trgb, jrgb) and trgb.shape == (24, 32, 3)
    if ts[0].isdigit():
        assert tt == jt == float(ts)
    else:                          # the arrival time, read by each
        assert abs(tt - jt) < 60.0
    made["torch"].close()


class FakeSocket:
    """The messages a phone sends, as a websocket's async iterator."""

    def __init__(self, msgs):
        self.msgs = msgs

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        for m in self.msgs:
            yield m


def test_imu_csv_rows_as_jax(tmp_path):
    msgs = [json.dumps({"timestamp": 1.25, "gyro": [0.1, -0.2, 0.3],
                        "accel": [9.81, 0.0, -0.5]}),
            json.dumps({"timestamp": 1.26, "gyro": [1e-9, 2.0, 3.0]}),
            "not json",
            json.dumps({"timestamp": 1.27, "accel": [1, 2, 3]}),
            json.dumps({"other": 1}),
            jpeg("5.5")]
    made = servers(tmp_path)
    for srv in made.values():
        asyncio.run(asyncio.wait_for(srv.receive(FakeSocket(msgs)), WAIT_S))
        srv.imu_csv.close()
    rows = {k: (tmp_path / k / "imu.csv").read_bytes() for k in made}
    assert rows["torch"] == rows["jax"] and rows["torch"].count(b"\n") == 3
    for srv in made.values():
        pkt = srv.s2t.get_nowait()
        assert pkt["timestamp"] == 5.5


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_one_frame_and_one_render_over_a_websocket(tmp_path):
    port = free_port()
    srv = servers(tmp_path, port)["torch"]
    render = np.linspace(0, 1, 20 * 30 * 3, dtype=np.float32).reshape(
        20, 30, 3)

    async def session():
        done = asyncio.Event()
        serving = asyncio.create_task(srv.serve(until=done.wait()))
        try:
            for _ in range(100):           # until the server listens
                try:
                    ws = await websockets.connect(f"ws://127.0.0.1:{port}")
                    break
                except OSError:
                    await asyncio.sleep(0.05)
            async with ws:
                await ws.send(jpeg("7.25"))
                pkt = await asyncio.wait_for(asyncio.to_thread(
                    srv.s2t.get, timeout=WAIT_S), WAIT_S)
                srv.m2s.put(render)
                msg = json.loads(await asyncio.wait_for(ws.recv(), WAIT_S))
        finally:
            done.set()
            await asyncio.wait_for(serving, WAIT_S)
        return pkt, msg

    pkt, msg = asyncio.run(session())
    srv.close()
    assert pkt["timestamp"] == 7.25 and pkt["rgb"].shape == (24, 32, 3)
    assert msg["type"] == "render"
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(msg["jpeg"]))))
    assert img.shape == (20, 30, 3)
    assert np.abs(img / 255.0 - render).max() < 0.1     # JPEG at quality 80
