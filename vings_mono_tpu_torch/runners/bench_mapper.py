"""Stage timings of the mapper at bench scale, the counterpart of the JAX
package's `scripts/bench_mapper.py`.

Usage: python -m vings_mono_tpu_torch.runners.bench_mapper
           [--device cuda|cpu]

On `bench_common.synthetic_window` (2^18 surfels, 2^18 pair slots, chunk
128, 8 noise keyframes at 240x432, two densified with 30000 points):
host ms per call, the device synchronized before and after, of
`bin_stack` over the 8 cameras, `add_frame` (keyframe 2, 20000 points),
the train loop at 1, 10 and 50 iterations and `storage_control`; the
calls that update the map in place run on copies. The last line is one
JSON record. Inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import json

from .bench_common import (WINDOW_MAPPER, copy_state, device_name, load,
                           synthetic_window, timed_ms, window_train)
from .eval_all import card_line
from .eval_common import add_device_flag


def measure(device, extra=None, height=240, width=432,
            iters_list=(1, 10, 50)):
    from ..mapper.densify import add_frame
    from ..mapper.train import bin_stack, storage_control
    cfg = load({"training_args": {"iters": 50, "num_keyframe": 5},
                "mapper": dict(WINDOW_MAPPER)}, extra, device)
    m, batch, binned, intr4 = synthetic_window(cfg, device, height, width)
    print(f"alive {m.n_alive}", flush=True)
    out = {}

    def timeit(name, fn, n):
        out[name] = timed_ms(fn, device, n=n)
        print(f"{name}: {out[name]:.1f} ms", flush=True)

    timeit("bin_stack(8 kf)", lambda: bin_stack(
        m.state, batch, intr4, height, width, **m.bin_kwargs), 3)
    gumbel, quat = m._densify_draws(int(cfg["mapper"]["points_per_frame"]))

    def add():
        st, op = copy_state(m.state, m.opt)
        return add_frame(st, op, batch.w2cs[2], intr4, batch.images[2],
                         batch.depths[2], batch.global_kf_id[2],
                         height=height, width=width, gumbel=gumbel,
                         quat_noise=quat, n_points=quat.shape[0],
                         first=False, render_kwargs=m.render_kwargs)
    timeit("add_frame", add, 2)
    for iters in iters_list:
        run, _, _ = window_train(m, batch, binned, intr4, iters, height,
                                 width)
        timeit(f"train_loop iters={iters}", run, 2)

    def storage():
        st, _ = copy_state(m.state, m.opt)
        return storage_control(st, batch, binned, intr4, height=height,
                               width=width, render_kwargs=m.render_kwargs)
    timeit("storage_control", storage, 2)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    with reproducible():
        out = measure(device)
    print(json.dumps({"device": device_name(device), "card": card_line(),
                      "ms": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
