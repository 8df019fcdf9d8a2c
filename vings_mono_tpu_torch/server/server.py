"""Websocket server for the live mobile pipeline (reference
scripts/server/server.py): receives phone JPEG frames (timestamp in the
EXIF DateTime or UserComment tag) and gyro/accel JSON, appends the IMU
samples to imu.csv, feeds the tracker queue, and streams the newest
rendered map frame back as a base64 JPEG at `server.send_hz`.

Needs the `websockets` and `PIL` packages, imported where they are used.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import os
import time

import numpy as np


class WebsocketServer:
    def __init__(self, cfg, server2tracker_queue, mapper2server_queue,
                 save_dir="output/server"):
        self.cfg = cfg
        self.s2t = server2tracker_queue
        self.m2s = mapper2server_queue
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.imu_csv = open(os.path.join(save_dir, "imu.csv"), "a")
        scfg = cfg.get("server", {}) or {}
        self.host = scfg.get("host", "0.0.0.0")
        self.port = int(scfg.get("port", 8765))
        self.send_hz = float(scfg.get("send_hz", 10.0))

    def close(self):
        self.imu_csv.close()

    # ------------------------------------------------------------------
    def _decode_frame(self, payload):
        """JPEG bytes -> (timestamp, (H, W, 3) float32 RGB in [0, 1]). The
        timestamp is the first EXIF DateTime / DateTimeOriginal /
        UserComment that parses as a float, else the arrival time."""
        from PIL import Image
        img = Image.open(io.BytesIO(payload))
        ts = time.time()
        exif = img.getexif()
        if exif:
            for tag in (306, 36867, 37510):
                if tag in exif:
                    try:
                        ts = float(str(exif[tag]).strip("\x00"))
                        break
                    except ValueError:
                        pass
        rgb = np.asarray(img.convert("RGB"), np.float32) / 255.0
        return ts, rgb

    def _imu_row(self, d):
        """One imu.csv line [t, gyro xyz, accel xyz] of a sensor message."""
        row = [d.get("timestamp", time.time())]
        row += list(d.get("gyro", [0, 0, 0]))
        row += list(d.get("accel", [0, 0, 0]))
        return ",".join(f"{v:.9f}" for v in row) + "\n"

    async def receive(self, ws):
        loop = asyncio.get_running_loop()
        async for msg in ws:
            if isinstance(msg, (bytes, bytearray)):
                ts, rgb = self._decode_frame(bytes(msg))
                # the tracker's queue is bounded: wait for room off the
                # event loop, so the sender keeps running meanwhile
                await loop.run_in_executor(
                    None, self.s2t.put, {"timestamp": ts, "rgb": rgb})
                continue
            try:
                d = json.loads(msg)
            except json.JSONDecodeError:
                continue
            if "gyro" in d or "accel" in d:
                self.imu_csv.write(self._imu_row(d))
                self.imu_csv.flush()

    async def send(self, ws):
        from PIL import Image
        period = 1.0 / self.send_hz
        while True:
            await asyncio.sleep(period)
            frame = None
            while not self.m2s.empty():
                frame = self.m2s.get_nowait()    # latest rendered frame
            if frame is None:
                continue
            img = Image.fromarray(
                (np.clip(frame, 0, 1) * 255).astype("uint8"))
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=80)
            await ws.send(json.dumps(
                {"type": "render",
                 "jpeg": base64.b64encode(buf.getvalue()).decode()}))

    async def handler(self, ws):
        recv = asyncio.create_task(self.receive(ws))
        send = asyncio.create_task(self.send(ws))
        done, pending = await asyncio.wait(
            [recv, send], return_when=asyncio.FIRST_COMPLETED)
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        import websockets
        for t in done:
            # a client that goes away ends its connection, not the server
            exc = t.exception()
            if exc is not None and \
                    not isinstance(exc, websockets.ConnectionClosed):
                raise exc

    async def serve(self, until):
        """Serve until the coroutine `until` returns."""
        import websockets
        async with websockets.serve(self.handler, self.host, self.port):
            await until

    def run(self, until):
        try:
            asyncio.run(self.serve(until))
        finally:
            self.close()
