"""FastSAM-class segment-everything network: the public YOLOv8-seg graph.

  backbone: CSPDarknet — stem conv, 4 stages of (downsample conv + C2f),
            SPPF at the end;
  neck:     PAN-FPN — top-down upsample/concat/C2f then bottom-up;
  heads:    per-scale box (DFL) + objectness/cls(1) + mask-coefficient
            branches, and a prototype head at stride 4.

NCHW inside; `FastSAM.forward` takes and returns the channels-last layout
of the JAX package. `segment_everything` decodes boxes (DFL expectation
over bins, anchor-free distance-to-edges), NMS-filters them and composes
per-instance masks as sigmoid(proto @ coeffs) cropped to the box; the NMS
and the mask composition are host numpy, as in the JAX package. Module
names follow the flax tree, so the JAX package's self-trained `.npz`
loads by name (`load_fastsam`); flax's defaults are kept (FrozenBN epsilon
1e-3, nearest 2x upsampling as an exact repeat, SPPF's SAME max-pool with
a -inf border).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import true_f32
from .flax_weights import (lecun_init_, load_pickled_params,
                           state_dict_from_flax)

REG_MAX = 16          # DFL bins per box side


class FrozenBN(nn.Module):
    """Batch norm without running statistics, eps 1e-3 (ultralytics'). All
    four statistics are parameters, as in the JAX package's flax tree:
    its trainer (`runners/train_fastsam.py`) moves and decays `mean` and
    `var` with the rest."""

    def __init__(self, ch):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.mean = nn.Parameter(torch.zeros(ch))
        self.var = nn.Parameter(torch.ones(ch))

    def forward(self, x):
        s = self.scale * torch.rsqrt(self.var + 1e-3)
        return (x - self.mean[:, None, None]) * s[:, None, None] \
            + self.bias[:, None, None]


class ConvBNAct(nn.Module):
    def __init__(self, cin, ch, k=1, s=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, ch, k, stride=s, padding=k // 2,
                              bias=False)
        self.bn = FrozenBN(ch)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin, ch, shortcut=True):
        super().__init__()
        self.cv1 = ConvBNAct(cin, ch, 3)
        self.cv2 = ConvBNAct(ch, ch, 3)
        self.add = shortcut and cin == ch

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (YOLOv8)."""

    def __init__(self, cin, ch, n=1, shortcut=True):
        super().__init__()
        h = ch // 2
        self.n = n
        self.cv1 = ConvBNAct(cin, ch, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(h, h, shortcut))
        self.cv2 = ConvBNAct((2 + n) * h, ch, 1)

    def forward(self, x):
        outs = list(self.cv1(x).chunk(2, dim=1))
        y = outs[1]
        for i in range(self.n):
            y = getattr(self, f"m{i}")(y)
            outs.append(y)
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin, ch):
        super().__init__()
        self.cv1 = ConvBNAct(cin, ch // 2, 1)
        self.cv2 = ConvBNAct(4 * (ch // 2), ch, 1)

    def forward(self, x):
        y = self.cv1(x)
        ps = [y]
        for _ in range(3):
            ps.append(F.max_pool2d(ps[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(ps, dim=1))


def _upsample2(x):
    """Nearest 2x upsampling, an exact repeat; as an expand, whose
    backward is a plain sum (repeat_interleave's is a scatter)."""
    B, C, h, w = x.shape
    return x[:, :, :, None, :, None].expand(B, C, h, 2, w, 2).reshape(
        B, C, 2 * h, 2 * w)


class FastSAM(nn.Module):
    """YOLOv8-seg graph; width/depth default to the 'n' scale (FastSAM-x is
    the same graph at width 1.25, depth 1.0). Runs in true f32 (no TF32)
    wherever it is called."""

    def __init__(self, width=0.25, depth=0.34, n_mask=32, generator=None):
        super().__init__()
        self.n_mask = n_mask

        def c(base):
            return max(16, int(round(base * width / 16)) * 16)

        def d(base):
            return max(1, int(round(base * depth)))

        c64, c128, c256, c512, c1024 = (c(b) for b in (64, 128, 256, 512,
                                                         1024))
        self.stem = ConvBNAct(3, c64, 3, 2)                      # 1/2
        self.down1 = ConvBNAct(c64, c128, 3, 2)                  # 1/4
        self.c2f1 = C2f(c128, c128, d(3))
        self.down2 = ConvBNAct(c128, c256, 3, 2)                 # 1/8
        self.c2f2 = C2f(c256, c256, d(6))
        self.down3 = ConvBNAct(c256, c512, 3, 2)                 # 1/16
        self.c2f3 = C2f(c512, c512, d(6))
        self.down4 = ConvBNAct(c512, c1024, 3, 2)                # 1/32
        self.c2f4 = C2f(c1024, c1024, d(3))
        self.sppf = SPPF(c1024, c1024)
        # PAN-FPN
        self.neck_td4 = C2f(c1024 + c512, c512, d(3), shortcut=False)
        self.neck_td3 = C2f(c512 + c256, c256, d(3), shortcut=False)
        self.neck_dn3 = ConvBNAct(c256, c256, 3, 2)
        self.neck_bu4 = C2f(c256 + c512, c512, d(3), shortcut=False)
        self.neck_dn4 = ConvBNAct(c512, c512, 3, 2)
        self.neck_bu5 = C2f(c512 + c1024, c1024, d(3), shortcut=False)
        # heads
        self.proto_cv1 = ConvBNAct(c256, c256, 3)
        self.proto_cv2 = ConvBNAct(c256, c256, 3)
        self.proto_out = nn.Conv2d(c256, n_mask, 1)
        for i, cin in enumerate((c256, c512, c1024)):
            for br, cout in (("box", 4 * REG_MAX), ("cls", 1)):
                setattr(self, f"head{i}_{br}1", ConvBNAct(cin, c256, 3))
                setattr(self, f"head{i}_{br}2", ConvBNAct(c256, c256, 3))
                setattr(self, f"head{i}_{br}", nn.Conv2d(c256, cout, 1))
            setattr(self, f"head{i}_mc1", ConvBNAct(cin, c256, 3))
            setattr(self, f"head{i}_mc", nn.Conv2d(c256, n_mask, 1))
        if generator is not None:
            lecun_init_(self, generator)

    @true_f32()
    def forward(self, image):
        """image (B, H, W, 3) in [0,1], H/W multiples of 32.

        Returns (preds, proto): preds is a list over strides (8, 16, 32) of
        (B, h, w, 4*REG_MAX + 1 + n_mask) raw maps; proto (B, H/4, W/4,
        n_mask)."""
        x = self.c2f1(self.down1(self.stem(image.permute(0, 3, 1, 2))))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))

        n4 = self.neck_td4(torch.cat([_upsample2(p5), p4], dim=1))
        n3 = self.neck_td3(torch.cat([_upsample2(n4), p3], dim=1))
        n4b = self.neck_bu4(torch.cat([self.neck_dn3(n3), n4], dim=1))
        n5b = self.neck_bu5(torch.cat([self.neck_dn4(n4b), p5], dim=1))

        proto = self.proto_out(self.proto_cv2(_upsample2(
            self.proto_cv1(n3))))
        preds = []
        for i, f in enumerate((n3, n4b, n5b)):
            def head(br, f=f, i=i):
                y = getattr(self, f"head{i}_{br}1")(f)
                if br != "mc":
                    y = getattr(self, f"head{i}_{br}2")(y)
                return getattr(self, f"head{i}_{br}")(y)
            preds.append(torch.cat([head("box"), head("cls"), head("mc")],
                                   dim=1).permute(0, 2, 3, 1))
        return preds, proto.permute(0, 2, 3, 1)


def decode_boxes(pred, stride):
    """(B, h, w, 4*REG_MAX + 1 + n_mask) -> boxes (B, h*w, 4) xyxy in
    pixels, scores (B, h*w), coeffs (B, h*w, n_mask). DFL: expectation of
    softmax over REG_MAX bins per side distance."""
    B, h, w, _ = pred.shape
    box = pred[..., :4 * REG_MAX].reshape(B, h, w, 4, REG_MAX)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=pred.device)
    dist = torch.sum(torch.softmax(box, dim=-1) * bins, dim=-1)
    cy, cx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=pred.device) + 0.5,
        torch.arange(w, dtype=torch.float32, device=pred.device) + 0.5,
        indexing="ij")
    boxes = torch.stack([(cx - dist[..., 0]) * stride,
                         (cy - dist[..., 1]) * stride,
                         (cx + dist[..., 2]) * stride,
                         (cy + dist[..., 3]) * stride], dim=-1)
    scores = torch.sigmoid(pred[..., 4 * REG_MAX]).reshape(B, h * w)
    coeffs = pred[..., 4 * REG_MAX + 1:].reshape(B, h * w, -1)
    return boxes.reshape(B, h * w, 4), scores, coeffs


def _nms(boxes, scores, iou_thresh=0.6, max_out=64):
    """Greedy NMS on the host (numpy) — rare-event post-processing."""
    boxes = np.asarray(boxes)
    scores = np.asarray(scores)
    order = np.argsort(-scores)
    keep = []
    while len(order) and len(keep) < max_out:
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * \
            (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.clip(a_i + a_r - inter, 1e-9, None)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, np.int64)


@torch.no_grad()
def raw_maps(model, rgb):
    """The device stage of `segment_everything`: rgb (H, W, 3) in [0,1]
    zero-padded to multiples of 32 -> (boxes, scores, coeffs) over all
    three strides and proto (ph, pw, n_mask), all on the model's device."""
    dev = next(model.parameters()).device
    H, W = rgb.shape[:2]
    img = torch.zeros((1, (H + 31) // 32 * 32, (W + 31) // 32 * 32, 3),
                      dtype=torch.float32, device=dev)
    img[0, :H, :W] = torch.as_tensor(np.asarray(rgb), dtype=torch.float32,
                                     device=dev)
    preds, proto = model(img)
    dec = [decode_boxes(p, s) for p, s in zip(preds, (8, 16, 32))]
    boxes, scores, coeffs = (torch.cat([d[k][0] for d in dec])
                             for k in range(3))
    return boxes, scores, coeffs, proto[0]


def segment_everything(model, rgb, conf=0.4, iou=0.6, max_out=64):
    """`FastSAMPrompt.everything_prompt()` equivalent: run the net, decode
    + NMS boxes, compose per-instance masks = sigmoid(proto @ coeff)
    cropped to the box. rgb (H, W, 3) in [0,1]; returns a list of (H, W)
    bool masks."""
    H, W = rgb.shape[:2]
    Hp = (H + 31) // 32 * 32
    Wp = (W + 31) // 32 * 32
    # one trip to the host for the decoded maps
    boxes, scores, coeffs, proto = (t.cpu().numpy()
                                    for t in raw_maps(model, rgb))
    sel = scores > conf
    if not sel.any():
        return []
    boxes, scores, coeffs = boxes[sel], scores[sel], coeffs[sel]
    keep = _nms(boxes, scores, iou, max_out)
    ph, pw = proto.shape[:2]
    masks = []
    sy, sx = Hp / ph, Wp / pw
    for i in keep:
        m = 1.0 / (1.0 + np.exp(-(proto @ coeffs[i])))   # (ph, pw)
        x1, y1, x2, y2 = boxes[i]
        yy, xx = np.meshgrid(np.arange(ph) * sy, np.arange(pw) * sx,
                             indexing="ij")
        inbox = (xx >= x1) & (xx <= x2) & (yy >= y1) & (yy <= y2)
        m = (m > 0.5) & inbox
        if not m.any():
            continue
        full = np.kron(m, np.ones((int(round(sy)), int(round(sx))),
                                  bool))[:H, :W]
        if full.shape != (H, W):
            pad = np.zeros((H, W), bool)
            pad[:full.shape[0], :full.shape[1]] = full[:H, :W]
            full = pad
        masks.append(full)
    return masks


def convert_fastsam_checkpoint(sd, depth=1.0):
    """An ultralytics YOLOv8-seg/FastSAM state_dict (torch names -> arrays)
    -> a FastSAM state_dict (the tensors carry their widths; `depth` sets
    the bottleneck counts). Layer indices follow the ultralytics
    yolov8-seg.yaml graph (model.0 stem ... model.22 head)."""
    out = {}

    def t(name):
        return torch.as_tensor(np.asarray(sd[name])).float()

    def conv(dst, src):
        out[f"{dst}.conv.weight"] = t(src + ".conv.weight")
        for a, b in (("scale", "weight"), ("bias", "bias"),
                     ("mean", "running_mean"), ("var", "running_var")):
            out[f"{dst}.bn.{a}"] = t(f"{src}.bn.{b}")

    def plain(dst, src):
        out[f"{dst}.weight"] = t(src + ".weight")
        out[f"{dst}.bias"] = t(src + ".bias")

    def c2f(dst, src, n):
        conv(dst + ".cv1", src + ".cv1")
        conv(dst + ".cv2", src + ".cv2")
        for i in range(n):
            conv(f"{dst}.m{i}.cv1", f"{src}.m.{i}.cv1")
            conv(f"{dst}.m{i}.cv2", f"{src}.m.{i}.cv2")

    def d(base):
        return max(1, int(round(base * depth)))

    for dst, src in (("stem", "model.0"), ("down1", "model.1"),
                     ("down2", "model.3"), ("down3", "model.5"),
                     ("down4", "model.7"), ("neck_dn3", "model.16"),
                     ("neck_dn4", "model.19"), ("sppf.cv1", "model.9.cv1"),
                     ("sppf.cv2", "model.9.cv2"),
                     ("proto_cv1", "model.22.proto.cv1"),
                     ("proto_cv2", "model.22.proto.cv2")):
        conv(dst, src)
    for dst, src, n in (("c2f1", "model.2", d(3)), ("c2f2", "model.4", d(6)),
                        ("c2f3", "model.6", d(6)), ("c2f4", "model.8", d(3)),
                        ("neck_td4", "model.12", d(3)),
                        ("neck_td3", "model.15", d(3)),
                        ("neck_bu4", "model.18", d(3)),
                        ("neck_bu5", "model.21", d(3))):
        c2f(dst, src, n)
    plain("proto_out", "model.22.proto.cv3")
    for i in range(3):
        conv(f"head{i}_box1", f"model.22.cv2.{i}.0")
        conv(f"head{i}_box2", f"model.22.cv2.{i}.1")
        plain(f"head{i}_box", f"model.22.cv2.{i}.2")
        conv(f"head{i}_cls1", f"model.22.cv3.{i}.0")
        conv(f"head{i}_cls2", f"model.22.cv3.{i}.1")
        plain(f"head{i}_cls", f"model.22.cv3.{i}.2")
        conv(f"head{i}_mc1", f"model.22.cv4.{i}.0")
        plain(f"head{i}_mc", f"model.22.cv4.{i}.1")
    return out


def load_fastsam(path=None, width=0.25, depth=0.34, device="cpu",
                 generator=None):
    """FastSAM in eval mode on `device`: from the JAX package's `.npz`
    (pickled `params` tree), or random from `generator` (seed 0 when None)
    without a path."""
    if path is None:
        model = FastSAM(width, depth, generator=generator if generator
                        is not None else torch.Generator().manual_seed(0))
    else:
        params, _ = load_pickled_params(path)
        model = FastSAM(width, depth)
        model.load_state_dict(state_dict_from_flax(params))
    return model.to(device).eval().requires_grad_(False)
