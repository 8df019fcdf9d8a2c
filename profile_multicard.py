"""The port's multi-card path over NCCL on four cards of one host: the
counterpart of the JAX package's `__graft_entry__.dryrun_multichip`.

    python3 profile_multicard.py [--commit SHA]

It needs four CUDA devices of one host; with fewer it exits 1 and says so
(no Gloo or CPU fallback). The one-card `chip_smoke.py` does not run it. A
copy without `.git` cannot name its commit: `--commit` does (default: `git
rev-parse HEAD` where there is a `.git`). It reuses chip_smoke.py's
phase-16 and phase-17 functions with NCCL placements, at their sizes and
tolerances. Each check prints one line `check <part>: ...` ending with the
cards' `nvidia-smi --query-gpu=name,power.limit` line and the commit; the
first failure exits 1. Parts, in order:
  a. both tile kernels on cuda:1, cuda:2 and cuda:3 with cuda:0 current,
     on phase 16a's scene (240x800, 37500 surfels, DP_P_CAP, chunk 128),
     against their plain twins (phase 3's tolerances) and bitwise against
     the same launches on cuda:0; the kernels' attributes on every card;
  b. `runners.run.run` (what `runners/run.py --device` calls) on
     smoke.yaml's first 20 frames with the device cuda:1, against the same
     run on cuda:0: trajectory and map digest bitwise equal;
  c. dp over NCCL at the default placement cuda:0..N-1: 16a's
     sharded_tile_grads at dp 2 and dp 4 against dp 1; 16b's replay at
     dp 2 and dp 4 beside dp 1 and dp 2 over Gloo on cuda:0; 16c's
     smoke.yaml run at dp 4 (trajectory against b's cuda:0 run, launches
     and peak memory per rank) and its rerun, bitwise equal;
  d. the (dp, sp) mesh over NCCL, one rank per card: 17a's tile step at
     (1, 2) on cuda:0 + cuda:1, at make_mesh's default on four cards (4,
     1) and at (2, 2), each against the whole-image step and beside 17a
     over Gloo on cuda:0; 17b's (2, 2) at 32x32, naive and tile;
  e. the collectives of c and d: rank 0's host ms per collective, per
     iteration or step, and the bytes, NCCL beside Gloo on one card;
  f. a follower that raises inside a dp call over NCCL (its poses
     malformed, so it fails after the call's first two collectives): the
     leader raises within the group's timeout, here 60 s, and no process
     is left.
About 10 minutes on four H100s.
"""

import argparse
import gc
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402

N_CARDS = 4
ITERS = 100              # chip_smoke.py's --iters default (phase 4's)
FAIL_TIMEOUT_S = 60.0    # part f's group timeout (DEFAULT_TIMEOUT_S: 600)


def gb(peak):
    return {r: round(b / 1e9, 3) for r, b in sorted(peak.items())}


def kernels_part(args, tk, say):
    """a. Both kernels on every other card while cuda:0 is current."""
    import torch
    st, _, batch, intr4 = cs.dp_scene("cuda:0")
    intr = {"fu": intr4[1], "fv": intr4[0], "cu": intr4[3], "cv": intr4[2],
            "H": cs.H, "W": cs.W}
    chunk = cs.DP_CHUNK
    pd, binned, meta = cs.pair_inputs(st, batch[3][0], {
        "p_cap": cs.DP_P_CAP, "chunk": chunk}, "cuda:0", intrinsic=intr)
    cs.check(not bool(binned.overflow), f"a: {int(binned.n_pairs)} pairs "
             f"overflow p_cap {cs.DP_P_CAP}")
    tc, n_pairs = binned.tile_chunks, int(binned.n_pairs)
    out0 = tk.rasterize_forward(pd, tc, meta, chunk)
    gen = torch.Generator(device="cuda:0").manual_seed(args.seed + 80)
    g0 = torch.randn(out0.shape, generator=gen, device="cuda:0")
    dtypes = (torch.float32, torch.bfloat16)
    bwd0 = [tk.rasterize_backward(pd, tc, meta, chunk, out0, g0,
                                  out_dtype=d).cpu() for d in dtypes]
    out0 = out0.cpu()
    for k in range(1, N_CARDS):
        dev = torch.device("cuda", k)
        cs.check(torch.cuda.current_device() == 0, "a: cuda:0 is not current")
        on = [x.to(dev) for x in (pd, tc, meta)]
        _, _, _, _, _, rel = cs.check_kernels(
            f"a {dev}, cuda:0 current", *on, chunk, args.seed + 80 + k,
            n_pairs)
        out = tk.rasterize_forward(*on, chunk)
        g = g0.to(dev)
        bwd = [tk.rasterize_backward(*on, chunk, out, g, out_dtype=d).cpu()
               for d in dtypes]
        cs.check(torch.equal(out.cpu(), out0), f"a: the forward on {dev} "
                 f"differs from cuda:0's")
        cs.check(all(torch.equal(a, b) for a, b in zip(bwd, bwd0)),
                 f"a: the backward on {dev} differs from cuda:0's")
        cs.check(torch.cuda.current_device() == 0,
                 f"a: a launch on {dev} changed the current device")
        say("a", f"both kernels on {dev} with cuda:0 current, {n_pairs} "
            f"pairs at {cs.H}x{cs.W}: forward {rel['fwd']:.3e} of each "
            f"channel group's largest (tol {cs.FWD_TOL}), backward bf16 "
            f"{rel['bf16']:.3e} and f32 {rel['f32']:.3e} of the row maximum "
            f"(tol {cs.BWD_TOL['bf16']} / {cs.BWD_TOL['f32']}) against the "
            f"plain twins; forward and both backwards bitwise equal to "
            f"cuda:0's launch")
    attrs = {k: tk.kernel_attributes(chunk, f"cuda:{k}")
             for k in range(N_CARDS)}
    cs.check(all(a == attrs[0] for a in attrs.values()),
             f"a: the kernels' attributes differ between cards: {attrs}")
    say("a", f"kernel attributes at chunk {chunk} on cuda:0-"
        f"{N_CARDS - 1}, equal on every card: {attrs[0]}")


def product_part(args, tk, say):
    """b. The product path on cuda:1 against cuda:0. Returns cuda:0's
    run's quality numbers (16c's dp 1 counterpart)."""
    import torch
    from vings_mono_tpu_torch.parallel.mesh import digest
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.utils.config import load_config
    runs = {}
    for dev in ("cuda:0", "cuda:1"):
        save = cs.OUT / f"multicard_smoke_{dev.replace(':', '')}"
        shutil.rmtree(save, ignore_errors=True)
        cfg = load_config(str(cs.SMOKE), overrides={
            "output": {"save_dir": str(save)},
            "dataset": {"n_frames": cs.DP_SMOKE_FRAMES}})
        tk.rasterize_forward.launches = 0
        tk.rasterize_backward.launches = 0
        t0 = time.perf_counter()
        tracker, mapper, _ = run_mod.run(cfg, str(save), device=dev)
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t0
        launches = (tk.rasterize_forward.launches,
                    tk.rasterize_backward.launches)
        cs.check(str(tracker.device) == dev and str(mapper.device) == dev,
                 f"b: tracker on {tracker.device}, mapper on "
                 f"{mapper.device}, asked {dev}")
        cs.check(min(launches) > 0, f"b {dev}: launches {launches}")
        cs.check(torch.cuda.current_device() == 0,
                 f"b {dev}: the run changed the current device")
        stats = cs.run_quality(f"b {dev}", cfg, save, tracker, mapper, run_s)
        runs[dev] = (stats, digest([getattr(mapper.state, f)
                                    for f in cs.MAP_FIELDS]), launches)
        del tracker, mapper
        gc.collect()
        torch.cuda.empty_cache()
    (a, map_a, la), (b, map_b, lb) = runs["cuda:0"], runs["cuda:1"]
    same = sorted(a["poses"]) == sorted(b["poses"]) and all(
        np.array_equal(a["poses"][t], b["poses"][t]) for t in a["poses"])
    cs.check(same and map_a == map_b, f"b: the run on cuda:1 parted from "
             f"cuda:0's (poses equal {same}, map {map_b} vs {map_a})")
    say("b", f"runners.run.run(device=cuda:1) on smoke.yaml's first "
        f"{cs.DP_SMOKE_FRAMES} frames: {len(b['poses'])} keyframe poses and "
        f"the map digest {map_b} bitwise equal to the run on cuda:0; "
        f"{b['fps']:.3f} frames/s (cuda:0 {a['fps']:.3f}), PSNR "
        f"{b['psnr']:.4f} dB, launches {lb} (cuda:0 {la})")
    return a


def dp_part(args, tk, say, smoke_stats):
    """c. dp over NCCL. Returns 16b's numbers by label."""
    import torch
    from vings_mono_tpu_torch.parallel import mesh
    from vings_mono_tpu_torch.runners import run_mapping
    from vings_mono_tpu_torch.utils.config import load_config
    for dp in (2, 4):
        group = mesh.make_dp_mesh(dp)
        group.verify = True
        try:
            r = cs.dp_grads_phase(args, tk, group, f"nccl dp {dp}")
        finally:
            group.close()
        cs.check_no_children(f"c 16a dp {dp}", group)
        say("c", f"16a sharded_tile_grads at dp {dp} over NCCL on cuda:0-"
            f"{dp - 1}: loss {r['loss']:.7f} (dp 1 {r['loss_dp1']:.7f}, "
            f"tol {cs.DP_LOSS_REL} relative), visibility equal, gradients "
            f"within {r['grad_worst']:.3e} of rtol {cs.DP_GRAD_RTOL} / atol "
            f"{cs.DP_GRAD_ATOL}, card vs CPU {r['cpu_worst']:.3e} of "
            f"{cs.DP_CPU_GRAD}; {r['ms']:.1f} ms (dp 1 {r['ms_dp1']:.1f})")

    win_dir = cs.OUT / "windows"
    cfg = load_config(str(cs.CONFIG), overrides={
        "dataset": {"root": str(win_dir)},
        "output": {"save_dir": str(cs.OUT / "run")},
        "training_args": {"iters": ITERS}, "seed": args.seed,
        "device": {"mapper": cs.DEVICE}})
    cs.write_windows(win_dir, 6, int(cfg["mapper"]["kf_capacity"]),
                     args.seed)
    _, records = run_mapping.run(cfg, str(cs.OUT / "run_dp1"),
                                 max_windows=cs.REPLAY_WINDOWS)
    kf1 = float(np.mean([r["ms"] for r in records]))
    psnr1 = records[-1]["psnr"]
    replays = {}
    for label, parallel in (("gloo_cuda0x2", cs.DP_GLOO),
                            ("nccl_dp2", {"dp": 2, "verify": True}),
                            ("nccl_dp4", {"dp": 4, "verify": True})):
        gc.collect()
        torch.cuda.empty_cache()
        r = replays[label] = cs.dp_replay_phase(args, tk, cfg, kf1, psnr1,
                                                parallel, label)
        say("c", f"16b replay [{label}]: {cs.REPLAY_WINDOWS} keyframes x "
            f"{ITERS} iters, keyframe mean {r['kf_ms']:.1f} ms (dp 1 on "
            f"cuda:0 {kf1:.1f}), train PSNR last {r['psnr']:.3f} (dp 1 "
            f"{psnr1:.3f}); collectives {r['comm_ms']:.2f} ms and "
            f"{r['comm_mb']:.3f} MB per iteration on rank 0; peak memory "
            f"per rank {gb(r['peak'])} GB; launches per rank {r['ranks']}")
    replays["dp1"] = {"kf_ms": kf1, "psnr": psnr1}

    runs = []
    for label in ("nccl_dp4", "nccl_dp4_rerun"):
        gc.collect()
        torch.cuda.empty_cache()
        runs.append(cs.dp_smoke_phase(args, tk, smoke_stats,
                                      {"dp": 4, "verify": True}, label))
    a, b = runs
    pa, pb = a["stats"]["poses"], b["stats"]["poses"]
    same = sorted(pa) == sorted(pb) and all(np.array_equal(pa[t], pb[t])
                                            for t in pa)
    cs.check(same and a["map"] == b["map"], f"c 16c: two runs at dp 4 over "
             f"NCCL parted (poses equal {same}, map {a['map']} vs "
             f"{b['map']}): NCCL's sums did not repeat")
    shared, dist, ang = a["gap"]
    say("c", f"16c smoke.yaml's first {cs.DP_SMOKE_FRAMES} frames through "
        f"runners.run.run at dp 4 over NCCL: {a['stats']['fps']:.3f} "
        f"frames/s (dp 1 {smoke_stats['fps']:.3f}), PSNR "
        f"{a['stats']['psnr']:.4f} dB (dp 1 {smoke_stats['psnr']:.4f}); "
        f"trajectory against dp 1 on {shared} shared keyframes: largest gap "
        f"{dist:.4e} units / {ang:.4f} deg; peak memory per rank "
        f"{gb(a['peak'])} GB; launches per rank {a['ranks']}; the rerun's "
        f"poses and map digest {b['map']} bitwise equal")
    return replays


def mesh_part(args, tk, say):
    """d. The (dp, sp) mesh over NCCL. Returns 17a's numbers by label."""
    import torch
    steps = {}
    for label, kw, shape in (
            ("gloo, cuda:0 x 2", None, None),
            ("nccl, cuda:0 + cuda:1", {"devices": ["cuda:0", "cuda:1"],
                                       "dp": 1}, {"dp": 1, "sp": 2}),
            ("nccl, make_mesh's default on 4 cards",
             {"n_devices": N_CARDS}, {"dp": 4, "sp": 1}),
            ("nccl, 4 cards", {"n_devices": N_CARDS, "dp": 2},
             {"dp": 2, "sp": 2})):
        gc.collect()
        torch.cuda.empty_cache()
        launches, _, r = cs.sp_full_phase(args, tk, kw, shape)
        steps[label] = r
        say("d", f"17a tile step at (dp, sp) = ({r['shape']['dp']}, "
            f"{r['shape']['sp']}) [{label}]: loss {r['loss']:.7f} (whole "
            f"{r['loss_whole']:.7f}, tol {cs.SP_LOSS_REL} relative), "
            f"gradients within {r['grad_worst']:.3e} of rtol "
            f"{cs.DP_GRAD_RTOL} / atol {cs.DP_GRAD_ATOL}; ms per step "
            f"{[round(x, 1) for x in r['ms']]} (whole image "
            f"{[round(x, 1) for x in r['ms_whole']]}); collectives "
            f"{r['comm_ms']:.1f} ms and {r['comm_mb']:.3f} MB per step on "
            f"rank 0; peak memory per rank {gb(r['peak'])} GB; launches "
            f"summed {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    cs.sp_grid_phase(tk, {"n_devices": N_CARDS, "dp": 2})
    say("d", "17b (dp, sp) = (2, 2) over NCCL on cuda:0-3 at 32x32, naive "
        "and tile: loss and gradients against the whole-image step within "
        f"{cs.SP_SMALL_LOSS_REL} / rtol {cs.DP_GRAD_RTOL} atol "
        f"{cs.DP_GRAD_ATOL}")
    return steps


def comm_part(replays, steps, say):
    """e. The collectives of parts c and d, NCCL beside Gloo."""
    for label, r in replays.items():
        if label == "dp1":
            continue
        iter_ms = r["kf_ms"] / ITERS
        say("e", f"16b [{label}]: {r['calls']:.2f} collectives per "
            f"iteration, {r['comm_ms'] / r['calls']:.3f} ms each on rank "
            f"0's host clock, {r['comm_ms']:.2f} ms and {r['comm_mb']:.3f} "
            f"MB per iteration: {r['comm_ms'] / iter_ms:.3f} of a "
            f"{iter_ms:.1f} ms iteration (a keyframe's mean over {ITERS}; "
            f"dp 1: {replays['dp1']['kf_ms'] / ITERS:.1f} ms)")
    for label, r in steps.items():
        step_ms = float(np.median(r["ms"]))
        say("e", f"17a [{label}]: {r['calls']:.0f} collectives per step, "
            f"{r['comm_ms'] / r['calls']:.3f} ms each on rank 0's host "
            f"clock, {r['comm_ms']:.1f} ms and {r['comm_mb']:.3f} MB per "
            f"step: {r['comm_ms'] / step_ms:.3f} of the median "
            f"{step_ms:.1f} ms step")


def failure_part(say, dp_kw):
    """f. A follower raises inside a call over `make_dp_mesh(**dp_kw)`:
    rank 1's poses arrive as (K/dp, 17), so its step raises after the
    broadcast and the scatter, while the other ranks wait in the next
    collective."""
    import torch
    from vings_mono_tpu_torch.parallel import mesh
    with cs.replaced(mesh, "DEFAULT_TIMEOUT_S", FAIL_TIMEOUT_S):
        group = mesh.make_dp_mesh(**dp_kw)
    real = mesh.shard_batch

    def malformed(g, tree):
        parts = real(g, tree)
        w2cs = parts[1][3]
        parts[1][3] = torch.cat([w2cs, w2cs[:, :1]], 1)
        return parts
    st, opt, batch, intr4 = cs.dp_scene(cs.DEVICE)
    err = None
    t0 = time.perf_counter()
    try:
        with cs.replaced(mesh, "shard_batch", malformed):
            try:
                mesh.sharded_tile_grads(group, st, opt, *batch, intr4,
                                        height=cs.H, width=cs.W,
                                        p_cap=cs.DP_P_CAP, chunk=cs.DP_CHUNK)
            except RuntimeError as e:
                err = e
        raised_s = time.perf_counter() - t0
    finally:
        t1 = time.perf_counter()
        group.close()
        close_s = time.perf_counter() - t1
    chain = f"{err} <- {err.__cause__}" if err is not None else ""
    cs.check(err is not None and "dp rank 1 failed" in chain,
             f"f: the leader did not raise rank 1's failure ({chain!r})")
    cs.check(raised_s < group.timeout_s, f"f: the leader raised after "
             f"{raised_s:.1f} s, past the group's {group.timeout_s} s")
    cs.check_no_children("f", group)
    first = chain.splitlines()[0]
    say("f", f"a follower that raises inside a dp call over "
        f"{group.backend} at dp {group.dp}: the leader raised in "
        f"{raised_s:.2f} s ({first!r}; group timeout {group.timeout_s} s), "
        f"close() took {close_s:.2f} s, no process left")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--commit", default=None,
                   help="the commit the checkout came from (default: git "
                   "rev-parse HEAD)")
    args = p.parse_args(argv)
    args.seed, args.iters = 0, ITERS   # chip_smoke.py's defaults
    t_start = time.perf_counter()
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < N_CARDS:
        cs.fail(f"profile_multicard.py needs {N_CARDS} CUDA devices, one "
                f"NCCL rank per card; this machine has {n}")
    from vings_mono_tpu_torch.utils.device import resolve_device
    resolve_device("cuda")
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    from vings_mono_tpu_torch.runners.eval_all import card_lines, commit_of
    from vings_mono_tpu_torch.utils import cuda_build
    lines = card_lines()
    smi = f"{len(lines)} x {lines[0]}" if len(set(lines)) == 1 \
        else " | ".join(lines)
    tag = f"[{smi}; commit {commit_of(args.commit)}]"

    def say(part, msg):
        print(f"check {part}: {msg} {tag}", flush=True)

    print(f"profile_multicard: torch {torch.__version__} cuda "
          f"{torch.version.cuda}, NCCL {torch.cuda.nccl.version()}, {n} "
          f"cards {tag}", flush=True)
    for defines in ((), tk.NO_CULL):
        cuda_build.build(defines=defines)
    times = {}
    t0 = time.perf_counter()
    kernels_part(args, tk, say)
    times["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    smoke_stats = product_part(args, tk, say)
    times["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    replays = dp_part(args, tk, say, smoke_stats)
    times["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = mesh_part(args, tk, say)
    times["d"] = time.perf_counter() - t0
    comm_part(replays, steps, say)
    t0 = time.perf_counter()
    failure_part(say, {"dp": N_CARDS})
    times["f"] = time.perf_counter() - t0
    print(f"profile_multicard: checks a-f passed in "
          f"{time.perf_counter() - t_start:.1f} s (seconds by part "
          f"{ {k: round(v, 1) for k, v in times.items()} }) {tag}",
          flush=True)


if __name__ == "__main__":
    main()
