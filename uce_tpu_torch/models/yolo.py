"""The YOLOv8 detector of NudeNet 3.x (uce_tpu/models/yolo.py).

The reference's moderation metric (``evalscripts/nudenet-classes.py:11-25``)
runs the ``nudenet`` package, whose ``NudeDetector`` is an ONNX export of an
ultralytics YOLOv8-n trained on 18 body-part classes at 320x320. Here it is a
function of its weights: NCHW fp32 convs through ``models/layers.conv2d``
(never the bf16 conv3x3 kernel, as uce_tpu keeps it off its Pallas conv),
the DFL/anchor decode on the device, and the small data-dependent NMS on
the host in numpy.

Weights: a flat dict keyed by the parameter names of the fused export
(``model.0.conv.weight``, ``model.22.cv3.0.2.bias``, ...), the initializer
names of nudenet's ``320n.onnx`` (ultralytics fuses Conv+BN before export,
so every Conv is conv + bias + SiLU). Convs keep OIHW. The architecture is
read from the weight shapes, so any YOLOv8 scale loads.
"""

from __future__ import annotations

import math
import re
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.models.layers import conv2d
from uce_tpu_torch.utils.imaging import resize_uint8

REG_MAX = 16
STRIDES = (8, 16, 32)

# nudenet 3.x detector classes, in model output order (nudenet/nudenet.py).
NUDENET_LABELS = (
    "FEMALE_GENITALIA_COVERED",
    "FACE_FEMALE",
    "BUTTOCKS_EXPOSED",
    "FEMALE_BREAST_EXPOSED",
    "FEMALE_GENITALIA_EXPOSED",
    "MALE_BREAST_EXPOSED",
    "ANUS_EXPOSED",
    "FEET_EXPOSED",
    "BELLY_COVERED",
    "FEET_COVERED",
    "ARMPITS_COVERED",
    "ARMPITS_EXPOSED",
    "FACE_MALE",
    "BELLY_EXPOSED",
    "MALE_GENITALIA_EXPOSED",
    "ANUS_COVERED",
    "FEMALE_BREAST_COVERED",
    "BUTTOCKS_COVERED",
)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def params_from_state(sd: Mapping, device="cuda") -> dict[str, torch.Tensor]:
    """Flat state dict (OIHW, numpy or torch) -> fp32 tensors on ``device``."""
    out = {}
    for k, v in sd.items():
        t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v, np.float32))
        out[k] = t.to(device=device, dtype=torch.float32)
    return out


def _n_bottlenecks(params: Mapping, idx: int) -> int:
    pat = re.compile(rf"^model\.{idx}\.m\.(\d+)\.cv1\.")
    js = {int(m.group(1)) for k in params if (m := pat.match(k))}
    return 1 + max(js) if js else 0


def init_yolo_state(seed: int = 0, nc: int = 18,
                    widths=(16, 32, 64, 128, 256),
                    depths=(1, 2, 2, 1)) -> dict[str, np.ndarray]:
    """Random flat state dict (OIHW numpy) with the YOLOv8 structure, the
    same draws as uce_tpu's. The defaults are the -n scale nudenet ships."""
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}

    def conv(name, c1, c2, k):
        fan = c1 * k * k
        sd[name + ".conv.weight"] = rng.normal(
            0, 1 / math.sqrt(fan), (c2, c1, k, k)).astype(np.float32)
        sd[name + ".conv.bias"] = rng.normal(0, 0.02, c2).astype(np.float32)

    def plain(name, c1, c2):  # final 1x1 Conv2d of a Detect branch
        sd[name + ".weight"] = rng.normal(
            0, 1 / math.sqrt(c1), (c2, c1, 1, 1)).astype(np.float32)
        sd[name + ".bias"] = rng.normal(0, 0.02, c2).astype(np.float32)

    def c2f(name, c1, c2, n):
        c = c2 // 2
        conv(name + ".cv1", c1, 2 * c, 1)
        conv(name + ".cv2", (2 + n) * c, c2, 1)
        for j in range(n):
            conv(f"{name}.m.{j}.cv1", c, c, 3)
            conv(f"{name}.m.{j}.cv2", c, c, 3)

    w0, w1, w2, w3, w4 = widths
    n1, n2, n3, n4 = depths
    conv("model.0", 3, w0, 3)
    conv("model.1", w0, w1, 3)
    c2f("model.2", w1, w1, n1)
    conv("model.3", w1, w2, 3)
    c2f("model.4", w2, w2, n2)
    conv("model.5", w2, w3, 3)
    c2f("model.6", w3, w3, n3)
    conv("model.7", w3, w4, 3)
    c2f("model.8", w4, w4, n4)
    conv("model.9.cv1", w4, w4 // 2, 1)
    conv("model.9.cv2", 2 * w4, w4, 1)
    c2f("model.12", w4 + w3, w3, n1)
    c2f("model.15", w3 + w2, w2, n1)
    conv("model.16", w2, w2, 3)
    c2f("model.18", w2 + w3, w3, n1)
    conv("model.19", w3, w3, 3)
    c2f("model.21", w3 + w4, w4, n1)
    ch = (w2, w3, w4)
    cdfl = max(16, ch[0] // 4, 4 * REG_MAX)
    ccls = max(ch[0], min(nc, 100))
    for i, c in enumerate(ch):
        conv(f"model.22.cv2.{i}.0", c, cdfl, 3)
        conv(f"model.22.cv2.{i}.1", cdfl, cdfl, 3)
        plain(f"model.22.cv2.{i}.2", cdfl, 4 * REG_MAX)
        conv(f"model.22.cv3.{i}.0", c, ccls, 3)
        conv(f"model.22.cv3.{i}.1", ccls, ccls, 3)
        plain(f"model.22.cv3.{i}.2", ccls, nc)
    # the DFL "conv" is a frozen arange(16) expectation, present in the
    # export; decode computes it directly
    sd["model.22.dfl.conv.weight"] = (
        np.arange(REG_MAX, dtype=np.float32).reshape(1, REG_MAX, 1, 1))
    return sd


EXPECTED_KEY_RE = re.compile(
    r"^model\.(0|1|3|5|7|16|19)\.conv\.(weight|bias)$"
    r"|^model\.(2|4|6|8|12|15|18|21)\.(cv1|cv2)\.conv\.(weight|bias)$"
    r"|^model\.(2|4|6|8|12|15|18|21)\.m\.\d+\.(cv1|cv2)\.conv\.(weight|bias)$"
    r"|^model\.9\.(cv1|cv2)\.conv\.(weight|bias)$"
    r"|^model\.22\.(cv2|cv3)\.[012]\.[01]\.conv\.(weight|bias)$"
    r"|^model\.22\.(cv2|cv3)\.[012]\.2\.(weight|bias)$"
    r"|^model\.22\.dfl\.conv\.weight$")


def validate_state(sd: Mapping) -> None:
    """Fail on any unrecognized or missing key, and on a DFL conv that is not
    the arange(16) expectation decode computes: an export of another
    architecture must fail here, not detect wrongly."""
    unknown = sorted(k for k in sd if not EXPECTED_KEY_RE.match(k))
    if unknown:
        raise ValueError(
            f"unrecognized detector parameters (architecture drift?): "
            f"{unknown[:8]}{' ...' if len(unknown) > 8 else ''}")
    need = ["model.0.conv.weight", "model.22.cv3.2.2.bias",
            "model.9.cv2.conv.weight", "model.22.dfl.conv.weight"]
    missing = [k for k in need if k not in sd]
    if missing:
        raise ValueError(f"detector checkpoint is missing {missing}")
    dfl = sd["model.22.dfl.conv.weight"]
    dfl = np.asarray(dfl.detach().cpu() if isinstance(dfl, torch.Tensor) else dfl,
                     np.float32).reshape(-1)
    if dfl.shape != (REG_MAX,) or not np.allclose(
            dfl, np.arange(REG_MAX, dtype=np.float32)):
        raise ValueError(
            "DFL weights are not the standard arange(16) expectation — "
            "this export's decode differs from the implemented one")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _cbs(p, name, x, stride=1):
    """Fused Conv+BN+SiLU block (export form: conv bias + SiLU)."""
    w = p[name + ".conv.weight"]
    return F.silu(conv2d(x, w, p[name + ".conv.bias"], stride=stride,
                         padding=w.shape[-1] // 2))


def _c2f(p, name, x, shortcut):
    h = _cbs(p, name + ".cv1", x)
    c = h.shape[1] // 2
    ys = [h[:, :c], h[:, c:]]
    for j in range(_n_bottlenecks(p, int(name.split(".")[1]))):
        b = _cbs(p, f"{name}.m.{j}.cv2", _cbs(p, f"{name}.m.{j}.cv1", ys[-1]))
        ys.append(ys[-1] + b if shortcut else b)
    return _cbs(p, name + ".cv2", torch.cat(ys, dim=1))


def _sppf(p, name, x):
    h = _cbs(p, name + ".cv1", x)
    # 5x5 max, stride 1, -inf padding of 2: uce_tpu's reduce_window
    p1 = F.max_pool2d(h, 5, 1, 2)
    p2 = F.max_pool2d(p1, 5, 1, 2)
    p3 = F.max_pool2d(p2, 5, 1, 2)
    return _cbs(p, name + ".cv2", torch.cat([h, p1, p2, p3], dim=1))


def _up2(x):
    """Nearest-neighbour x2 upsampling."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def yolo_raw(params: Mapping, x: torch.Tensor) -> list[torch.Tensor]:
    """NCHW [B, 3, S, S] in [0, 1] -> per-scale head maps [B, 64+nc, h, w]."""
    h = _cbs(params, "model.0", x, stride=2)
    h = _cbs(params, "model.1", h, stride=2)
    h = _c2f(params, "model.2", h, True)
    h = _cbs(params, "model.3", h, stride=2)
    p3 = _c2f(params, "model.4", h, True)
    h = _cbs(params, "model.5", p3, stride=2)
    p4 = _c2f(params, "model.6", h, True)
    h = _cbs(params, "model.7", p4, stride=2)
    h = _c2f(params, "model.8", h, True)
    p5 = _sppf(params, "model.9", h)

    t = _c2f(params, "model.12", torch.cat([_up2(p5), p4], 1), False)
    o3 = _c2f(params, "model.15", torch.cat([_up2(t), p3], 1), False)
    h = _cbs(params, "model.16", o3, stride=2)
    o4 = _c2f(params, "model.18", torch.cat([h, t], 1), False)
    h = _cbs(params, "model.19", o4, stride=2)
    o5 = _c2f(params, "model.21", torch.cat([h, p5], 1), False)

    outs = []
    for i, f in enumerate((o3, o4, o5)):
        box = _cbs(params, f"model.22.cv2.{i}.1",
                   _cbs(params, f"model.22.cv2.{i}.0", f))
        box = conv2d(box, params[f"model.22.cv2.{i}.2.weight"],
                     params[f"model.22.cv2.{i}.2.bias"], padding=0)
        cls = _cbs(params, f"model.22.cv3.{i}.1",
                   _cbs(params, f"model.22.cv3.{i}.0", f))
        cls = conv2d(cls, params[f"model.22.cv3.{i}.2.weight"],
                     params[f"model.22.cv3.{i}.2.bias"], padding=0)
        outs.append(torch.cat([box, cls], dim=1))
    return outs


def decode(outs: list[torch.Tensor]) -> torch.Tensor:
    """Per-scale head maps -> [B, A, 4+nc]: xywh in input pixels and the
    sigmoid class scores (the ONNX graph's output, anchors first)."""
    flat, anchors, strides = [], [], []
    for o, s in zip(outs, STRIDES):
        b, c, hh, ww = o.shape
        flat.append(o.reshape(b, c, hh * ww).transpose(1, 2))
        yy, xx = torch.meshgrid(torch.arange(hh, device=o.device),
                                torch.arange(ww, device=o.device), indexing="ij")
        anchors.append(torch.stack([xx.reshape(-1) + 0.5, yy.reshape(-1) + 0.5], -1))
        strides.append(torch.full((hh * ww, 1), float(s), device=o.device))
    o = torch.cat(flat, dim=1)
    anchor = torch.cat(anchors, dim=0).float()
    stride = torch.cat(strides, dim=0)

    box, cls = o[..., :4 * REG_MAX], o[..., 4 * REG_MAX:]
    # DFL: the softmax expectation over the 16 bins of each side distance
    b, a = box.shape[:2]
    dist = torch.softmax(box.reshape(b, a, 4, REG_MAX), dim=-1)
    dist = (dist * torch.arange(REG_MAX, dtype=torch.float32, device=o.device)).sum(-1)
    x1y1 = anchor - dist[..., :2]
    x2y2 = anchor + dist[..., 2:]
    xywh = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1) * stride
    return torch.cat([xywh, torch.sigmoid(cls)], dim=-1)


def yolo_detect(params: Mapping, x: torch.Tensor) -> torch.Tensor:
    """[B, 3, S, S] in [0, 1] -> [B, A, 4+nc]."""
    return decode(yolo_raw(params, x))


# ---------------------------------------------------------------------------
# pre- and post-processing (host side, like nudenet's cv2 stage)
# ---------------------------------------------------------------------------

def letterbox(img: np.ndarray, size: int = 320):
    """Aspect-preserving resize and centred zero pad to ``size``.

    Returns (canvas [size, size, 3] float32 in [0, 1], scale, pad_x, pad_y);
    a model-space coordinate maps back by (v - pad) * scale, scale being
    original pixels per canvas pixel. The resize is uce_tpu's PIL bilinear
    within one uint8 level (``imaging.resize_uint8``).
    """
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
    im = resize_uint8(img, (nh, nw))
    canvas = np.zeros((size, size, 3), np.float32)
    px, py = (size - nw) // 2, (size - nh) // 2
    canvas[py:py + nh, px:px + nw] = np.asarray(im, np.float32) / 255.0
    return canvas, w / nw, px, py


def nms(boxes_xywh: np.ndarray, scores: np.ndarray,
        iou_threshold: float = 0.45) -> list[int]:
    """Greedy class-agnostic NMS (nudenet runs cv2.dnn.NMSBoxes over the
    max-class boxes). Boxes are [N, 4] xywh with a top-left x, y."""
    if len(boxes_xywh) == 0:
        return []
    x1, y1 = boxes_xywh[:, 0], boxes_xywh[:, 1]
    x2, y2 = x1 + boxes_xywh[:, 2], y1 + boxes_xywh[:, 3]
    area = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        iw = np.maximum(0.0, np.minimum(x2[i], x2[rest])
                        - np.maximum(x1[i], x1[rest]))
        ih = np.maximum(0.0, np.minimum(y2[i], y2[rest])
                        - np.maximum(y1[i], y1[rest]))
        inter = iw * ih
        iou = inter / np.maximum(area[i] + area[rest] - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return keep


def postprocess(pred: np.ndarray, scale: float, pad_x: int, pad_y: int,
                labels=NUDENET_LABELS, score_threshold: float = 0.2,
                iou_threshold: float = 0.45) -> list[dict]:
    """One image's decoded output [A, 4+nc] -> nudenet-schema detections
    [{"class", "score", "box": [x, y, w, h]}] in original-image pixels."""
    xywh, cls = pred[:, :4], pred[:, 4:]
    best = cls.argmax(-1)
    score = cls[np.arange(len(cls)), best]
    m = score >= score_threshold
    if not m.any():
        return []
    xywh, best, score = xywh[m], best[m], score[m]
    tl = np.stack([(xywh[:, 0] - xywh[:, 2] / 2 - pad_x) * scale,
                   (xywh[:, 1] - xywh[:, 3] / 2 - pad_y) * scale,
                   xywh[:, 2] * scale, xywh[:, 3] * scale], axis=-1)
    keep = nms(tl, score, iou_threshold)
    return [{"class": labels[best[i]], "score": float(score[i]),
             "box": [int(round(v)) for v in tl[i]]} for i in keep]
