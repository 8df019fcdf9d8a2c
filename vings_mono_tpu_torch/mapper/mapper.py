"""Host-side mapper orchestration — the `GaussianModel` of the reference.

Mirrors run_only_mapping: consume the tracker's `viz_out` dict, detect new
keyframes by timestamp, prune+densify, then run the training loop. The
class does the bookkeeping: fixed-capacity padding, the round-robin binning
caches (full resolution and the coarse phase's half resolution, each with
its own pair-capacity bucket ladder), the sky sphere (`use_sky`), pose
refinement (`use_refine`) and the coarse-to-fine phase
(`training_args.coarse_frac`).

`parallel: {dp: N}` shards the keyframe window over N ranks, one process
each (`parallel/mesh.py`): this process is rank 0 and starts the others;
binning and both train loops (and the loop-closure retrain) run on every
rank, each on its K/N slots, against the state the mapper holds here,
which every call replicates first. `close()` stops the other ranks. As in
the JAX package, only `parallel.dp` is read here: `parallel.sp` (image rows
sharded within a keyframe) belongs to `parallel.mesh.sharded_train_step`.

`mapper.impl` selects the render, as in the JAX package: "tile" (the
default, the binned tile kernels) or "naive" (every visible Gaussian at
every pixel, plain PyTorch; no scores flow on that path, as in JAX).
`mapper.interpret` runs JAX's Pallas kernels interpreted; the port does
not read it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import ply as ply_io
from ..utils.device import resolve_device
from ..utils.mfu import shape_sig
from .cameras import camera_from_intrinsic
from .densify import add_frame, draw_densify
from .refine import apply_pose_bias_to_gaussians, refine_poses
from .sky import SkyModel, sky_render_params
from .state import (STATE_FIELDS, adam_init, empty_state, state_from_numpy,
                    state_to_numpy)
from .train import (KeyframeBatch, bin_rows, bin_stack, draw_kf_schedule,
                    half_batch, half_intr4, permute_scatter_binned, pool2x2,
                    stablemask_control, storage_control, train_loop)
from ..parallel.mesh import (dp_bin_stack, dp_placement, dp_train_loop,
                             make_dp_mesh)
from ..ops.rasterizer import render


def _intr4(intr: dict):
    """Reference intrinsic dict -> (fx, fy, cx, cy) (fu/cu are row-major)."""
    return (float(intr["fv"]), float(intr["fu"]), float(intr["cv"]),
            float(intr["cu"]))


class GaussianMapper:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device or cfg["device"]["mapper"])
        m = cfg["mapper"]
        self.capacity = int(m["capacity"])
        self.kf_capacity = int(m["kf_capacity"])
        pcfg = cfg.get("parallel") or {}
        self.dp = int(pcfg.get("dp", 1))
        if self.dp < 1 or self.kf_capacity % self.dp:
            raise ValueError(f"mapper.kf_capacity {self.kf_capacity} must "
                             f"divide by parallel.dp {self.dp}")
        # pair_capacity is the UPPER bucket; the mapper walks down to the
        # smallest bucket that fits the observed pair count — the tile
        # kernels' cost grows with p_cap, so dead capacity is waste. A
        # bucket switch invalidates the binning cache.
        self._p_cap_max = int(m["pair_capacity"])
        self._p_cap_min = max(int(m.get("pair_capacity_min",
                                        self._p_cap_max // 4)),
                              int(m["chunk"]))
        self._shrink_votes = self._shrink_votes_c = 0
        # the largest padded demand each cache has seen, and whether
        # freeze_buckets has pinned both
        self._max_npairs = self._max_npairs_c = 0
        self._cap_frozen = False
        self.bin_kwargs = {"p_cap": self._p_cap_max,
                           "chunk": int(m["chunk"]),
                           "side": int(m["side"]),
                           "v_cap": int(m.get("visible_capacity", 0)),
                           # keep only the tile_depth_cap nearest pairs per
                           # tile: transmittance saturates long before.
                           # 0 = uncapped.
                           "tile_cap": int(m.get("tile_depth_cap", 512))}
        self.impl = m.get("impl", "tile")
        self.state = empty_state(self.capacity, self.device)
        self.opt = adam_init(self.state)
        self.use_sky = bool(cfg.get("use_sky"))
        self.sky = None
        if self.use_sky:
            self.sky = SkyModel(cfg, capacity=int(m.get("sky_capacity",
                                                        1 << 15)),
                                device=self.device)
        self.refined_poses = None
        self.history = []          # timestamps already mapped
        self.time_idx = 0
        self.initialized = False
        self.generator = torch.Generator().manual_seed(int(cfg.get("seed",
                                                                   0)))
        self.metrics = None
        self._pending_stats = []
        # drain the deferred end-of-run stats every N keyframes (each drain
        # waits for the device)
        self.stats_every = int(m.get("stats_every", 4))
        self._last_psnr_host = None
        self.H = self.W = None
        self._mfu_sig = None
        # round-robin binning cache: re-bin only `rebin_rows` cameras per
        # keyframe (the new one + the stalest); cached rows follow the
        # sliding window by global_kf_id. 0 = always full re-bin.
        self.rebin_rows = int(m.get("rebin_rows", 3))
        self._binned = None
        self._cached_gids = None
        self._bin_age = None
        # coarse-to-fine: fraction of each keyframe's train iterations run
        # at half resolution (0 = off), with its own binning cache and pair
        # bucket: pairs and tiles at half resolution are ~1/3 of full
        self.coarse_frac = float(
            cfg["training_args"].get("coarse_frac", 0.0))
        vc = int(m.get("visible_capacity", 0))
        self.bin_kwargs_c = dict(
            self.bin_kwargs,
            p_cap=max(self._p_cap_min, self._p_cap_max // 2),
            # a quarter of the pixels: the nearest half of the visible
            # Gaussians; the fine phase still trains the full visible set
            v_cap=int(m.get("visible_capacity_coarse",
                            vc // 2 if vc else 0)))
        self._binned_c = None
        self._cached_gids_c = None
        self._bin_age_c = None
        # the dp group last: its followers are processes that close() stops
        self.group = None
        if self.dp > 1:
            devices, backend = dp_placement(
                self.dp, pcfg.get("platform"), pcfg.get("devices"),
                pcfg.get("backend"))
            here = self.device if self.device.type != "cuda" else \
                torch.device("cuda", self.device.index or 0)
            if devices[0] != here:
                raise ValueError(f"parallel.devices[0] ({devices[0]}) is "
                                 f"rank 0, the mapper's own device "
                                 f"({self.device})")
            self.group = make_dp_mesh(self.dp, devices=devices,
                                      backend=backend)
            # compare the ranks' state digests after every call (checks)
            self.group.verify = bool(pcfg.get("verify", False))

    def close(self):
        """Stop the dp ranks (nothing to do at dp = 1); idempotent. Every
        runner calls it when it ends, however it ends."""
        if self.group is not None:
            self.group.close()

    def invalidate_binning(self):
        """Drop both binning caches — required after any Gaussian teleport
        or storage page-in: BinnedScene stores tile assignments by Gaussian
        index."""
        self._binned = None
        self._binned_c = None

    @property
    def render_kwargs(self):
        return tuple(self.bin_kwargs.items()) + (("impl", self.impl),)

    @property
    def render_kwargs_c(self):
        return tuple(self.bin_kwargs_c.items()) + (("impl", self.impl),)

    # ---- random draws (tests replace these to replay another stream) ----
    def _densify_draws(self, n_points):
        """(gumbel (H*W,), quaternion noise (n_points, 4)) for add_frame."""
        return draw_densify(self.generator, self.H, self.W, n_points,
                            self.device)

    def _kf_schedule(self, iters, n_valid):
        """Window slot of each training iteration; (iters, dp) with dp > 1,
        each rank's slot within its own K/dp."""
        return draw_kf_schedule(self.generator, iters, n_valid, self.dp,
                                self.kf_capacity // self.dp)

    # ---- the dp route ----------------------------------------------------
    def _bin_all(self, batch, intr4, height, width, bin_kwargs):
        """Bin every window camera; with dp > 1 each rank bins its own."""
        if self.group is None:
            return bin_stack(self.state, batch, intr4, height, width,
                             **bin_kwargs)
        return dp_bin_stack(self.group, self.state, batch, intr4, height,
                            width, **bin_kwargs)

    def _train(self, *targs, **tkw):
        """train_loop, or dp_train_loop over the group with dp > 1."""
        if self.group is None:
            return train_loop(*targs, **tkw)
        return dp_train_loop(self.group, *targs, **tkw)

    # ---- pair-capacity buckets -----------------------------------------
    def _drain_stats(self):
        """Materialize the accumulated end-of-run stats (pair-slot demand,
        overflow, PSNR) and feed the bucket tuner; the bucket reacts up to
        `stats_every` keyframes late."""
        pend, self._pending_stats = self._pending_stats, []
        for n_padded, overflow, psnr, coarse in pend:
            self._tune_pair_capacity(int(n_padded), bool(overflow))
            if coarse is not None:
                self._tune_pair_capacity(int(coarse[0]), bool(coarse[1]),
                                         sfx="_c")
            self._last_psnr_host = float(psnr)

    def freeze_buckets(self):
        """Pin both pair-capacity buckets, so that no bucket switch (and
        no cache drop) lands inside a measured section. Each cache freezes
        at the smallest ladder bucket covering the largest padded demand
        it has seen (the hysteresis may sit a bucket too high, e.g. after
        an early overflow's jump to max). Run a keyframe or two after
        freezing, outside the measured section; later overflow keyframes
        drop their farthest pairs."""
        self._drain_stats()
        for sfx in ("", "_c"):
            seen = getattr(self, "_max_npairs" + sfx)
            kw = getattr(self, "bin_kwargs" + sfx)
            if seen:
                fits = [b for b in self._bucket_ladder() if b >= seen]
                want = fits[0] if fits else self._p_cap_max
                if want != kw["p_cap"]:
                    setattr(self, "bin_kwargs" + sfx, dict(kw, p_cap=want))
                    setattr(self, "_binned" + sfx, None)
        self._cap_frozen = True

    def _bucket_ladder(self):
        """Allowed pair-capacity buckets: {min*2^k} plus 1.5x intermediate
        steps (when chunk-divisible), capped at pair_capacity."""
        ch = int(self.bin_kwargs["chunk"])
        out = set()
        m = self._p_cap_min
        while m <= self._p_cap_max:
            out.add(m)
            m15 = m * 3 // 2
            if (m * 3) % 2 == 0 and m15 <= self._p_cap_max \
                    and m15 % ch == 0:
                out.add(m15)
            m *= 2
        out.add(self._p_cap_max)
        return sorted(out)

    def _tune_pair_capacity(self, n, overflow, sfx=""):
        """Pick the next keyframes' pair-capacity bucket from an observed
        PADDED pair-slot demand n (pad_off[T], what a bucket must cover).
        GROW one step only when pairs threaten the cap (overflow: straight
        to max), SHRINK after 3 votes to the smallest bucket holding
        1.15*n — a switch drops the binning cache. sfx selects the cache:
        "" full resolution, "_c" the coarse phase's. After freeze_buckets
        it does nothing."""
        if self._cap_frozen:
            return
        setattr(self, "_max_npairs" + sfx,
                max(n, getattr(self, "_max_npairs" + sfx)))
        kw = getattr(self, "bin_kwargs" + sfx)
        votes = "_shrink_votes" + sfx
        cap = kw["p_cap"]
        buckets = self._bucket_ladder()
        if overflow:
            want = self._p_cap_max
        elif n * 50 > cap * 49:
            bigger = [b for b in buckets if b > cap]
            want = bigger[0] if bigger else cap
        else:
            fits = [b for b in buckets if n * 23 // 20 + 1 <= b]
            want = min(fits[0] if fits else self._p_cap_max, cap)
        if want > cap:
            setattr(self, votes, 0)
        elif want < cap:
            setattr(self, votes, getattr(self, votes) + 1)
            if getattr(self, votes) < 3:
                return
            setattr(self, votes, 0)
        else:
            setattr(self, votes, 0)
            return
        setattr(self, "bin_kwargs" + sfx, dict(kw, p_cap=want))
        setattr(self, "_binned" + sfx, None)   # cache rows are cap-shaped

    # ---- packing -----------------------------------------------------
    def _tensor(self, x, dtype=torch.float32):
        """x on the mapper's device as `dtype`; a tensor is moved and cast
        where it lies (no trip through the host), anything else goes
        through numpy."""
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _pack_batch(self, viz_out) -> KeyframeBatch:
        kc = self.kf_capacity
        if "n_valid" in viz_out:
            n_valid = int(viz_out["n_valid"])
        else:
            n_valid = min(len(viz_out["viz_out_idx_to_f_idx"]), kc)
        gids = np.asarray(viz_out.get("global_kf_id_host",
                                      viz_out.get("global_kf_id")), np.int64)
        pm = viz_out.get("pixel_mask")
        imgs = self._tensor(viz_out["images"]).movedim(-1, 1)  # (K,3,H,W)
        depths = self._tensor(viz_out["depths"]).movedim(-1, 1)
        covs = self._tensor(viz_out["depths_cov"]).movedim(-1, 1)
        # inv_ex: the same inverse without inv's error check, which waits
        # for the device
        w2cs = torch.linalg.inv_ex(self._tensor(viz_out["poses"])).inverse
        ids = self._tensor(viz_out["global_kf_id"], torch.int32)
        pm = None if pm is None else self._tensor(pm, torch.bool)
        if imgs.shape[0] > kc:
            imgs, depths, covs, w2cs, ids = (x[-kc:] for x in
                                             (imgs, depths, covs, w2cs, ids))
            pm = None if pm is None else pm[-kc:]
            gids = gids[-kc:]
            n_valid = min(n_valid, kc)

        def pad(x):
            if x.shape[0] == kc:
                return x
            return torch.cat([x, x[-1:].expand(kc - x.shape[0],
                                               *x.shape[1:])])

        if len(gids) < kc:
            gids = np.concatenate([gids, np.full(kc - len(gids), gids[-1])])
        self._gids_host = gids
        self._n_valid_host = n_valid
        return KeyframeBatch(images=pad(imgs), depths=pad(depths),
                             depths_cov=pad(covs), w2cs=pad(w2cs),
                             global_kf_id=pad(ids), n_valid=n_valid,
                             pixel_mask=None if pm is None else pad(pm))

    # ---- round-robin binning cache -------------------------------------
    def _refresh_binned(self, batch, intr4, height=None, width=None,
                        sfx=""):
        """Re-bin only the new keyframe + the stalest cached rows; cached
        rows follow the sliding window by global keyframe id. Stale rows
        are safe: the exact-ellipse binning carries 2.5 px of margin and
        pruned Gaussians render at zero opacity. Newly-densified Gaussians
        reach every row within ceil(K/rebin_rows) keyframes.

        sfx selects the cache and its pair bucket: "" = full resolution,
        "_c" = the coarse phase's half resolution (same policy)."""
        height = self.H if height is None else height
        width = self.W if width is None else width
        bkw = getattr(self, "bin_kwargs" + sfx)
        kc, R = self.kf_capacity, self.rebin_rows
        gids = self._gids_host
        cached = getattr(self, "_binned" + sfx)
        cached_gids = getattr(self, "_cached_gids" + sfx)
        # dp: a full re-bin every keyframe, K/dp cameras per rank, no cache
        full_rebin = (R <= 0 or R >= kc or cached is None
                      or self.group is not None)
        if not full_rebin:
            perm = np.zeros(kc, np.int64)
            have = np.zeros(kc, bool)
            for pos, g in enumerate(gids):
                w = np.where(cached_gids == g)[0]
                if len(w):
                    perm[pos] = w[0]
                    have[pos] = True
            if int((~have).sum()) > R:
                full_rebin = True
        if full_rebin:
            binned = self._bin_all(batch, intr4, height, width, bkw)
            age = np.zeros(kc, np.int64)
        else:
            age = np.where(have, getattr(self, "_bin_age" + sfx)[perm] + 1,
                           1 << 30)
            rows = np.argsort(-age)[:R]                # stalest first
            rows_t = torch.as_tensor(rows, device=self.device)
            part = bin_rows(self.state, batch.w2cs[rows_t], intr4, height,
                            width, **bkw)
            binned = permute_scatter_binned(
                cached, torch.as_tensor(perm, device=self.device), part,
                rows_t)
            age[rows] = 0
        setattr(self, "_binned" + sfx, binned)
        setattr(self, "_bin_age" + sfx, age)
        setattr(self, "_cached_gids" + sfx, gids.copy())
        return binned

    # ---- new-keyframe detection (judge_new_frame, host logic) ---------
    def _judge_new_frame(self, viz_out):
        ts = np.asarray(viz_out["viz_out_idx_to_f_idx"]).tolist()
        for i, t in enumerate(ts):
            if t not in self.history:
                self.history.append(t)
                return i
        return None

    def _add_frame(self, batch, i, intr4, first):
        mcfg = self.cfg["mapper"]
        n_points = int(mcfg["points_first_frame" if first
                            else "points_per_frame"])
        gumbel, quat = self._densify_draws(n_points)
        extra = {} if first else {
            "accum_thresh": float(self.cfg["adc_args"]["accum_thresh"])}
        add_frame(self.state, self.opt, batch.w2cs[i], intr4,
                  batch.images[i], batch.depths[i], batch.global_kf_id[i],
                  height=self.H, width=self.W, gumbel=gumbel,
                  quat_noise=quat, n_points=n_points, first=first,
                  render_kwargs=self.render_kwargs, **extra)

    # ---- main entry (mirrors gaussian_base.run) ------------------------
    def run(self, viz_out):
        """Map one packaged window. Its programs (add_frame, bin_stack,
        train_loop, storage_control) run inside `torch.profiler` ranges
        named as the JAX package's programs, so that a trace gives device
        time per program; a range adds no device work and no
        synchronization."""
        if viz_out is None:
            return
        intr = viz_out["intrinsic"]
        self.H, self.W = int(intr["H"]), int(intr["W"])
        intr4 = _intr4(intr)
        batch = self._pack_batch(viz_out)
        ta = self.cfg["training_args"]

        if not self.initialized:
            self.history = np.asarray(
                viz_out["viz_out_idx_to_f_idx"]).tolist()
            for i in range(self._n_valid_host):
                with torch.profiler.record_function("add_frame"):
                    self._add_frame(batch, i, intr4, first=True)
                self._sky_add_frame(batch, i, intr4)
            self.initialized = True
        else:
            new_id = self._judge_new_frame(viz_out)
            if new_id is None:
                return
            # if the window was cropped to kf_capacity, re-locate the index
            new_id = min(new_id, self._n_valid_host - 1)
            with torch.profiler.record_function("add_frame"):
                self._add_frame(batch, new_id, intr4, first=False)
            self._sky_add_frame(batch, new_id, intr4)

        with torch.profiler.record_function("bin_stack"):
            binned = self._refresh_binned(batch, intr4)

        self.refined_poses = None
        if self.cfg.get("use_refine"):
            new_c2ws, _ = refine_poses(
                self.state, batch, binned, intr4, iters=20, height=self.H,
                width=self.W, render_kwargs=self.render_kwargs)
            old_c2ws = torch.linalg.inv_ex(batch.w2cs).inverse
            apply_pose_bias_to_gaussians(self.state, batch.global_kf_id,
                                         old_c2ws, new_c2ws)
            batch = batch._replace(
                w2cs=torch.linalg.inv_ex(new_c2ws).inverse)
            self.refined_poses = new_c2ws

        iters = int(ta["iters"])
        if len(self._pending_stats) >= self.stats_every:
            self._drain_stats()
        adaptive = self.cfg["mapper"].get("adaptive_iters")
        if adaptive and self._last_psnr_host is not None \
                and self._last_psnr_host > float(adaptive):
            # converged windows need fewer refinement iterations
            iters = max(iters // 2, 10)

        lrs = self._lrs(ta)
        sky_images = None
        if self.use_sky:
            sky_images = viz_out.get("sky_images")
            sky_images = batch.images if sky_images is None else \
                self._tensor(sky_images).movedim(-1, 1)

        # coarse-to-fine: the first coarse_frac of the budget at half
        # resolution (tiles and pairs shrink ~4x)
        iters_c = 0
        if (self.coarse_frac > 0 and iters > 1
                and self.H % 2 == 0 and self.W % 2 == 0):
            iters_c = min(int(round(iters * self.coarse_frac)), iters - 1)
        binned_c = None
        if iters_c:
            batch_c = half_batch(batch)
            intr4_c = half_intr4(intr4)
            hc, wc = self.H // 2, self.W // 2
            with torch.profiler.record_function("bin_stack"):
                binned_c = self._refresh_binned(batch_c, intr4_c, height=hc,
                                                width=wc, sfx="_c")
            sky_c = self._sky_args(batch_c, intr4_c, hc, wc,
                                   self.bin_kwargs_c,
                                   None if sky_images is None
                                   else pool2x2(sky_images))
            with torch.profiler.record_function("train_loop"):
                self._train(
                    self.state, self.opt, batch_c, binned_c, intr4_c,
                    iters=iters_c, height=hc, width=wc,
                    kf_schedule=self._kf_schedule(iters_c, batch.n_valid),
                    weights=ta["loss_weights"], lrs=lrs,
                    render_kwargs=self.render_kwargs_c, sky=sky_c)

        targs = (self.state, self.opt, batch, binned, intr4)
        tkw = dict(height=self.H, width=self.W, weights=ta["loss_weights"],
                   lrs=lrs, render_kwargs=self.render_kwargs,
                   sky=self._sky_args(batch, intr4, self.H, self.W,
                                      self.bin_kwargs, sky_images))
        # shape-only signature for MFU accounting (utils/mfu.py)
        self._mfu_sig = (shape_sig(targs), shape_sig(tkw), iters - iters_c)
        with torch.profiler.record_function("train_loop"):
            _, _, metrics = self._train(
                *targs, iters=iters - iters_c,
                kf_schedule=self._kf_schedule(iters - iters_c,
                                              batch.n_valid), **tkw)
        self.metrics = metrics

        self.time_idx += 1
        if self.time_idx % int(ta["num_keyframe"]) == 0:
            stablemask_control(self.state)
        if self.time_idx % 4 == 0:
            with torch.profiler.record_function("storage_control"):
                storage_control(self.state, batch, binned, intr4,
                                height=self.H, width=self.W,
                                render_kwargs=self.render_kwargs)
        # deferred end-of-run stats: pulled at the next drain, so the host
        # does not wait for the device after every keyframe
        self._pending_stats.append((
            torch.max(binned.n_padded), torch.any(binned.overflow),
            metrics["psnr"], None if binned_c is None else
            (torch.max(binned_c.n_padded), torch.any(binned_c.overflow))))

    def _sky_add_frame(self, batch, i, intr4):
        """Seed the sky sphere from keyframe i's sky pixels."""
        if not self.use_sky:
            return
        # 1000 samples per frame, capped at the sphere's capacity
        gumbel, quat = self._densify_draws(min(1000,
                                               self.sky.state.capacity))
        self.sky.add_frame(batch.w2cs[i], intr4, batch.images[i], self.H,
                           self.W, gumbel, quat)

    def _sky_args(self, batch, intr4, height, width, bin_kwargs, images):
        """train_loop's `sky` argument: the sphere binned afresh for every
        window camera (no cache); not binned with impl naive."""
        if not self.use_sky:
            return None
        st = self.sky.state
        binned = None
        if self.impl == "tile":
            xyz, log_scale = sky_render_params(st)
            binned = bin_stack(dataclasses.replace(st, xyz=xyz,
                                                   log_scale=log_scale),
                               batch, intr4, height, width, **bin_kwargs)
        return (st, self.sky.opt, images, binned)

    # ---- direct window training (loop-closure retrain) -----------------
    def train_on_window(self, viz_out, iters, weights=None):
        """Train on an explicit keyframe window without the add-frame /
        densify bookkeeping — the loop-closure retrain path. Bins every
        window camera afresh and drops the caches after (their rows are
        the live window's)."""
        intr4 = _intr4(viz_out["intrinsic"])
        if self.H is None:
            self.H = int(viz_out["intrinsic"]["H"])
            self.W = int(viz_out["intrinsic"]["W"])
        batch = self._pack_batch(viz_out)
        binned = self._bin_all(batch, intr4, self.H, self.W,
                               self.bin_kwargs)
        ta = self.cfg["training_args"]
        _, _, self.metrics = self._train(
            self.state, self.opt, batch, binned, intr4, iters=int(iters),
            height=self.H, width=self.W,
            kf_schedule=self._kf_schedule(int(iters), batch.n_valid),
            weights={**ta["loss_weights"], **(weights or {})},
            lrs=self._lrs(ta), render_kwargs=self.render_kwargs)
        self.invalidate_binning()

    @staticmethod
    def _lrs(ta):
        lr = ta["lr"]
        return {"xyz": lr["_xyz_lr"], "rgb": lr["_rgb_lr"],
                "log_scale": lr["_scaling_lr"], "quat": lr["_rotation_lr"],
                "logit_opacity": lr["_opacity_lr"]}

    # ---- rendering for vis / eval --------------------------------------
    @torch.no_grad()
    def render_at(self, w2c, intr: dict, max_dist=None):
        """Render the map at w2c. max_dist (meters) culls Gaussians farther
        than that from the camera center (the reference's
        `render_indistance`)."""
        w2c = self._tensor(w2c)
        cam = camera_from_intrinsic(w2c, intr)
        s = self.state
        alive = s.alive
        if max_dist is not None:
            c2w = torch.linalg.inv(w2c)
            d2 = torch.sum((s.xyz - c2w[:3, 3]) ** 2, dim=-1)
            alive = alive & (d2 < float(max_dist) ** 2)
        return render(s.xyz, s.log_scale, s.quat, s.logit_opacity, s.rgb,
                      cam, alive=alive, **dict(self.render_kwargs))

    @property
    def last_metrics(self):
        """Latest train-loop metrics as host floats."""
        if self.metrics is None:
            return {}
        return {k: float(v) for k, v in self.metrics.items()
                if v.ndim == 0}

    @property
    def n_alive(self):
        return int(self.state.n_alive())

    # ---- checkpointing --------------------------------------------------
    def save_ply(self, path, mode="2dgs"):
        s = state_to_numpy(self.state)
        m = s["alive"]
        ply_io.save_ply(path, s["xyz"][m], s["rgb"][m], s["log_scale"][m],
                        s["quat"][m], s["logit_opacity"][m], mode=mode)

    def save_ckpt(self, path):
        """npz in the JAX package's checkpoint format."""
        np.savez_compressed(path, history=np.asarray(self.history),
                            time_idx=self.time_idx,
                            **state_to_numpy(self.state))

    def load_ckpt(self, path):
        """Load a checkpoint of either package; fresh Adam state."""
        with np.load(path) as z:
            self.state = state_from_numpy({f: z[f] for f in STATE_FIELDS},
                                          self.device)
            self.history = z["history"].tolist()
            self.time_idx = int(z["time_idx"])
        self.opt = adam_init(self.state)
        self.initialized = True
        self.invalidate_binning()
