"""Capacity-capped Gaussian map state + masked sparse-Adam.

Instead of reallocating parameters on every densify/prune, all tensors have
a fixed capacity with an `alive` mask: insert/delete are row writes, and
the optimizer's "sparse step" is a per-row mask (only Gaussians visible in
the current render step their moments, matching the reference's
`optimizer.step(radii>0, N)`).

The JAX package returns new arrays from every update and donates the old
buffers; here `sparse_adam_step`, `write_rows` and `kill_rows` update the
state's tensors in place and return the same objects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

PARAM_FIELDS = ("xyz", "rgb", "log_scale", "quat", "logit_opacity")
STATE_FIELDS = PARAM_FIELDS + ("alive", "stable", "local_scores",
                               "global_scores", "globalkf_id",
                               "globalkf_max_scores")


@dataclasses.dataclass
class GaussianState:
    # optimizable parameters (raw / pre-activation)
    xyz: torch.Tensor            # (CAP, 3)
    rgb: torch.Tensor            # (CAP, 3)
    log_scale: torch.Tensor      # (CAP, 2) — 2D surfel scales
    quat: torch.Tensor           # (CAP, 4) wxyz, unnormalized
    logit_opacity: torch.Tensor  # (CAP, 1)
    # lifecycle state
    alive: torch.Tensor          # (CAP,) bool
    stable: torch.Tensor         # (CAP,) bool
    local_scores: torch.Tensor   # (CAP, 2) importance / error this round
    global_scores: torch.Tensor  # (CAP, 2)
    globalkf_id: torch.Tensor    # (CAP,) int32 owning keyframe
    globalkf_max_scores: torch.Tensor  # (CAP,)

    @property
    def capacity(self):
        return self.xyz.shape[0]

    def params(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in PARAM_FIELDS}

    def n_alive(self):
        return torch.sum(self.alive.to(torch.int32))


def empty_state(cap: int, device) -> GaussianState:
    f32 = dict(dtype=torch.float32, device=device)
    return GaussianState(
        xyz=torch.zeros((cap, 3), **f32),
        rgb=torch.zeros((cap, 3), **f32),
        log_scale=torch.full((cap, 2), -10.0, **f32),
        quat=torch.tensor([1.0, 0, 0, 0], **f32).repeat(cap, 1),
        logit_opacity=torch.full((cap, 1), -10.0, **f32),
        alive=torch.zeros((cap,), dtype=torch.bool, device=device),
        stable=torch.zeros((cap,), dtype=torch.bool, device=device),
        local_scores=torch.zeros((cap, 2), **f32),
        global_scores=torch.zeros((cap, 2), **f32),
        globalkf_id=torch.zeros((cap,), dtype=torch.int32, device=device),
        globalkf_max_scores=torch.zeros((cap,), **f32),
    )


def state_from_numpy(arrays, device) -> GaussianState:
    """State from a dict of numpy arrays keyed by field name — the npz that
    `GaussianMapper.save_ckpt` of either package writes."""
    dtypes = {"alive": torch.bool, "stable": torch.bool,
              "globalkf_id": torch.int32}
    return GaussianState(**{
        f: torch.as_tensor(np.asarray(arrays[f]),
                           dtype=dtypes.get(f, torch.float32),
                           device=device).clone()
        for f in STATE_FIELDS})


def state_to_numpy(state: GaussianState):
    return {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}


@dataclasses.dataclass
class SparseAdamState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: int


def adam_init(state: GaussianState) -> SparseAdamState:
    return SparseAdamState(
        m={k: torch.zeros_like(p) for k, p in state.params().items()},
        v={k: torch.zeros_like(p) for k, p in state.params().items()},
        step=0)


# default per-param lrs mirror configs' training_args.lr
DEFAULT_LRS = {"xyz": 1e-4, "rgb": 2.5e-3, "log_scale": 5e-3,
               "quat": 1e-3, "logit_opacity": 5e-2}


@torch.no_grad()
def sparse_adam_step(state: GaussianState, grads: Dict[str, torch.Tensor],
                     opt: SparseAdamState, step_mask, lrs=None,
                     b1=0.9, b2=0.999, eps=1e-15):
    """Masked Adam, in place: rows outside step_mask keep params AND moments
    frozen (SparseGaussianAdam semantics). eps matches the reference
    (1e-15)."""
    lrs = {**DEFAULT_LRS, **(lrs or {})}
    opt.step += 1
    # bias corrections in f32, as the JAX package computes them
    t = np.float32(opt.step)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)
    mask = step_mask[:, None]
    mask_col = mask.to(torch.float32)
    for k, p in state.params().items():
        # zero non-finite gradients instead of poisoning the moments (the
        # reference's GradientClip does the same in its backward hook)
        g = grads[k]
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = torch.where(mask, b1 * opt.m[k] + (1 - b1) * g, opt.m[k])
        v = torch.where(mask, b2 * opt.v[k] + (1 - b2) * g * g, opt.v[k])
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        p.sub_(lrs[k] * upd * mask_col)
        opt.m[k].copy_(m)
        opt.v[k].copy_(v)
    return state, opt


@torch.no_grad()
def write_rows(state: GaussianState, opt: SparseAdamState, slots,
               valid_new, new_params: Dict[str, torch.Tensor],
               globalkf_id):
    """Insert new Gaussians at `slots` (where valid_new), in place; resets
    lifecycle state and Adam moments for those rows. globalkf_id is one
    keyframe id for every new row (densify) or one per row (storage
    page-in, written like the parameters)."""
    idx = slots[valid_new].to(torch.int64)
    mark = torch.zeros((state.capacity,), dtype=torch.bool,
                       device=state.xyz.device)
    mark[idx] = True
    for k in PARAM_FIELDS:
        getattr(state, k)[idx] = new_params[k][valid_new].to(torch.float32)
    state.alive |= mark
    state.stable &= ~mark
    state.local_scores[mark] = 0.0
    state.global_scores[mark] = 0.0
    gkf = torch.as_tensor(globalkf_id, dtype=torch.int32,
                          device=state.xyz.device)
    if gkf.ndim == 0:
        state.globalkf_id[mark] = gkf
    else:
        state.globalkf_id[idx] = gkf[valid_new]
    state.globalkf_max_scores[mark] = 0.0
    for k in PARAM_FIELDS:
        opt.m[k][mark] = 0.0
        opt.v[k][mark] = 0.0
    return state, opt


@torch.no_grad()
def kill_rows(state: GaussianState, kill_mask) -> GaussianState:
    """Prune = flip alive off, in place. Slots get recycled by the next
    densify."""
    state.alive &= ~kill_mask
    return state
