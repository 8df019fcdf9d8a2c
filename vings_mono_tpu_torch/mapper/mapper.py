"""Host-side mapper orchestration — the `GaussianModel` of the reference.

Mirrors run_only_mapping: consume the tracker's `viz_out` dict, detect new
keyframes by timestamp, prune+densify, then run the training loop. The
class does the bookkeeping: fixed-capacity padding, the round-robin binning
cache and the pair-capacity bucket ladder.

Not ported yet: the multi-device `dp` mesh, the sky model, pose refinement
and the coarse-to-fine phase; a config that asks for one raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import ply as ply_io
from ..utils.device import resolve_device
from .cameras import camera_from_intrinsic
from .densify import add_frame, draw_densify
from .state import (STATE_FIELDS, adam_init, empty_state, state_from_numpy,
                    state_to_numpy)
from .train import (KeyframeBatch, bin_rows, bin_stack, draw_kf_schedule,
                    permute_scatter_binned, stablemask_control,
                    storage_control, train_loop)
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
        unported = [name for name, on in (
            ("use_sky", cfg.get("use_sky")),
            ("use_refine", cfg.get("use_refine")),
            ("parallel.dp", int((cfg.get("parallel") or {}).get("dp", 1)) > 1),
            ("training_args.coarse_frac",
             float(cfg["training_args"].get("coarse_frac", 0.0)) > 0))
            if on]
        if unported:
            raise NotImplementedError(
                f"not ported to the torch mapper yet: {', '.join(unported)}")
        self.capacity = int(m["capacity"])
        self.kf_capacity = int(m["kf_capacity"])
        # pair_capacity is the UPPER bucket; the mapper walks down to the
        # smallest bucket that fits the observed pair count — the tile
        # kernels' cost grows with p_cap, so dead capacity is waste. A
        # bucket switch invalidates the binning cache.
        self._p_cap_max = int(m["pair_capacity"])
        self._p_cap_min = max(int(m.get("pair_capacity_min",
                                        self._p_cap_max // 4)),
                              int(m["chunk"]))
        self._shrink_votes = 0
        self.bin_kwargs = {"p_cap": self._p_cap_max,
                           "chunk": int(m["chunk"]),
                           "side": int(m["side"]),
                           "v_cap": int(m.get("visible_capacity", 0)),
                           # keep only the tile_depth_cap nearest pairs per
                           # tile: transmittance saturates long before.
                           # 0 = uncapped.
                           "tile_cap": int(m.get("tile_depth_cap", 512))}
        self.state = empty_state(self.capacity, self.device)
        self.opt = adam_init(self.state)
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
        # round-robin binning cache: re-bin only `rebin_rows` cameras per
        # keyframe (the new one + the stalest); cached rows follow the
        # sliding window by global_kf_id. 0 = always full re-bin.
        self.rebin_rows = int(m.get("rebin_rows", 3))
        self._binned = None
        self._cached_gids = None
        self._bin_age = None

    def invalidate_binning(self):
        """Drop the binning cache — required after any Gaussian teleport:
        BinnedScene stores tile assignments by Gaussian index."""
        self._binned = None

    @property
    def render_kwargs(self):
        return tuple(self.bin_kwargs.items())

    # ---- random draws (tests replace these to replay another stream) ----
    def _densify_draws(self, n_points):
        """(gumbel (H*W,), quaternion noise (n_points, 4)) for add_frame."""
        return draw_densify(self.generator, self.H, self.W, n_points,
                            self.device)

    def _kf_schedule(self, iters, n_valid):
        """Window slot of each training iteration."""
        return draw_kf_schedule(self.generator, iters, n_valid)

    # ---- pair-capacity buckets -----------------------------------------
    def _drain_stats(self):
        """Materialize the accumulated end-of-run stats (pair-slot demand,
        overflow, PSNR) and feed the bucket tuner; the bucket reacts up to
        `stats_every` keyframes late."""
        pend, self._pending_stats = self._pending_stats, []
        for n_padded, overflow, psnr in pend:
            self._tune_pair_capacity(int(n_padded), bool(overflow))
            self._last_psnr_host = float(psnr)

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

    def _tune_pair_capacity(self, n, overflow):
        """Pick the next keyframes' pair-capacity bucket from an observed
        PADDED pair-slot demand n (pad_off[T], what a bucket must cover).
        GROW one step only when pairs threaten the cap (overflow: straight
        to max), SHRINK after 3 votes to the smallest bucket holding
        1.15*n — a switch drops the binning cache."""
        cap = self.bin_kwargs["p_cap"]
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
            self._shrink_votes = 0
        elif want < cap:
            self._shrink_votes += 1
            if self._shrink_votes < 3:
                return
            self._shrink_votes = 0
        else:
            self._shrink_votes = 0
            return
        self.bin_kwargs = dict(self.bin_kwargs, p_cap=want)
        self._binned = None   # cache rows are cap-shaped

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
    def _refresh_binned(self, batch, intr4):
        """Re-bin only the new keyframe + the stalest cached rows; cached
        rows follow the sliding window by global keyframe id. Stale rows
        are safe: the exact-ellipse binning carries 2.5 px of margin and
        pruned Gaussians render at zero opacity. Newly-densified Gaussians
        reach every row within ceil(K/rebin_rows) keyframes."""
        kc, R = self.kf_capacity, self.rebin_rows
        gids = self._gids_host
        cached, cached_gids = self._binned, self._cached_gids
        full_rebin = (R <= 0 or R >= kc or cached is None)
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
            self._binned = bin_stack(self.state, batch, intr4, self.H,
                                     self.W, **self.bin_kwargs)
            self._cached_gids = gids.copy()
            self._bin_age = np.zeros(kc, np.int64)
            return self._binned
        age = np.where(have, self._bin_age[perm] + 1, 1 << 30)
        rows = np.argsort(-age)[:R]                # stalest first
        rows_t = torch.as_tensor(rows, device=self.device)
        part = bin_rows(self.state, batch.w2cs[rows_t], intr4, self.H,
                        self.W, **self.bin_kwargs)
        self._binned = permute_scatter_binned(
            cached, torch.as_tensor(perm, device=self.device), part, rows_t)
        age[rows] = 0
        self._bin_age = age
        self._cached_gids = gids.copy()
        return self._binned

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
                self._add_frame(batch, i, intr4, first=True)
            self.initialized = True
        else:
            new_id = self._judge_new_frame(viz_out)
            if new_id is None:
                return
            # if the window was cropped to kf_capacity, re-locate the index
            self._add_frame(batch, min(new_id, self._n_valid_host - 1),
                            intr4, first=False)

        binned = self._refresh_binned(batch, intr4)

        iters = int(ta["iters"])
        if len(self._pending_stats) >= self.stats_every:
            self._drain_stats()
        adaptive = self.cfg["mapper"].get("adaptive_iters")
        if adaptive and self._last_psnr_host is not None \
                and self._last_psnr_host > float(adaptive):
            # converged windows need fewer refinement iterations
            iters = max(iters // 2, 10)

        _, _, metrics = train_loop(
            self.state, self.opt, batch, binned, intr4, iters=iters,
            height=self.H, width=self.W,
            kf_schedule=self._kf_schedule(iters, batch.n_valid),
            weights=ta["loss_weights"], lrs=self._lrs(ta),
            render_kwargs=self.render_kwargs)
        self.metrics = metrics

        self.time_idx += 1
        if self.time_idx % int(ta["num_keyframe"]) == 0:
            stablemask_control(self.state)
        if self.time_idx % 4 == 0:
            storage_control(self.state, batch, binned, intr4, height=self.H,
                            width=self.W, render_kwargs=self.render_kwargs)
        # deferred end-of-run stats: pulled at the next drain, so the host
        # does not wait for the device after every keyframe
        self._pending_stats.append((torch.max(binned.n_padded),
                                    torch.any(binned.overflow),
                                    metrics["psnr"]))

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
