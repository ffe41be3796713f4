"""MTCNN face detector (P-Net / R-Net / O-Net cascade), port of
hfa_gp_tpu/preprocess/mtcnn.py.

Replaces the reference's external TensorFlow `mtcnn` package
(eg3d-pose-detection/batch_mtcnn.py:4,9): three small convnets over an
image pyramid with NMS between stages, giving a box and 5-point landmarks
per face. The nets are `nn.Module`s in NCHW on the caller's device; the
cascade between them (pyramid resampling, box arithmetic, NMS, crops) is
host numpy and PIL, written as the JAX package writes it.

P-Net runs on each pyramid level alone, and R-/O-Net on exactly the
candidates there are. Every max pool is ceil mode with no padding (the
torch MTCNN convention the JAX `_maxpool` reproduces); the FC layers take
the NCHW flatten, (c, h, w) order (`convert.mtcnn_from_jax` permutes the
JAX package's (h, w, c) columns).

The per-frame entry point (`detect_faces`) reproduces batch_mtcnn.py:32-79:
confidence gate 0.9 and most-central-face selection.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

THRESHOLDS = (0.6, 0.7, 0.7)
NMS_THRESHOLDS = (0.7, 0.7, 0.7)
SCALE_FACTOR = 0.709
MIN_FACE_SIZE = 20
MAX_CANDIDATES = 256


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


class ConvPReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k)
        self.prelu = nn.PReLU(cout, 0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.conv(x))


def _pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(x, k, 2, ceil_mode=True)


class PNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = ConvPReLU(3, 10, 3)
        self.c2 = ConvPReLU(10, 16, 3)
        self.c3 = ConvPReLU(16, 32, 3)
        self.prob = nn.Conv2d(32, 2, 1)
        self.reg = nn.Conv2d(32, 4, 1)

    def forward(self, x: torch.Tensor):
        """x (B, 3, H, W) → (prob (B, 2, h, w) softmaxed, reg (B, 4, h, w));
        h = ceil((H − 4) / 2) − 3, one row more than the windows seen
        whole when H is odd."""
        h = self.c3(self.c2(_pool(self.c1(x), 2)))
        return torch.softmax(self.prob(h), dim=1), self.reg(h)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, prelu: bool = False):
        super().__init__()
        self.fc = nn.Linear(cin, cout)
        self.prelu = nn.PReLU(cout, 0.25) if prelu else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x)
        return y if self.prelu is None else self.prelu(y)


class RNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = ConvPReLU(3, 28, 3)
        self.c2 = ConvPReLU(28, 48, 3)
        self.c3 = ConvPReLU(48, 64, 2)
        self.fc = Dense(64 * 3 * 3, 128, prelu=True)
        self.prob = Dense(128, 2)
        self.reg = Dense(128, 4)

    def forward(self, x: torch.Tensor):
        """x (N, 3, 24, 24) → (prob (N, 2), reg (N, 4))."""
        h = self.c3(_pool(self.c2(_pool(self.c1(x), 3)), 3))
        h = self.fc(h.flatten(1))
        return torch.softmax(self.prob(h), dim=-1), self.reg(h)


class ONet(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = ConvPReLU(3, 32, 3)
        self.c2 = ConvPReLU(32, 64, 3)
        self.c3 = ConvPReLU(64, 64, 3)
        self.c4 = ConvPReLU(64, 128, 2)
        self.fc = Dense(128 * 3 * 3, 256, prelu=True)
        self.prob = Dense(256, 2)
        self.reg = Dense(256, 4)
        self.lmk = Dense(256, 10)

    def forward(self, x: torch.Tensor):
        """x (N, 3, 48, 48) → (prob (N, 2), reg (N, 4), landmarks (N, 10))."""
        h = _pool(self.c2(_pool(self.c1(x), 3)), 3)
        h = self.c4(_pool(self.c3(h), 2))
        h = self.fc(h.flatten(1))
        return (torch.softmax(self.prob(h), dim=-1), self.reg(h),
                self.lmk(h))


class MTCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.pnet, self.rnet, self.onet = PNet(), RNet(), ONet()

    @property
    def device(self) -> torch.device:
        return self.pnet.prob.weight.device


def init_mtcnn(generator: torch.Generator,
               device: torch.device | str = "cpu") -> MTCNN:
    """The JAX init's distributions: convs and FCs U(±1/√fan_in) with their
    biases, P-Net's 1×1 heads N(0, 0.1²) with zero bias, PReLU 0.25."""
    net = MTCNN()

    def uniform(t, bound):
        t.copy_(torch.rand(t.shape, generator=generator) * 2 * bound - bound)

    with torch.no_grad():
        for head in (net.pnet.prob, net.pnet.reg):
            head.weight.copy_(torch.randn(head.weight.shape,
                                          generator=generator) * 0.1)
            head.bias.zero_()
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)) \
                    and m not in (net.pnet.prob, net.pnet.reg):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                uniform(m.weight, bound)
                uniform(m.bias, bound)
    return net.eval().requires_grad_(False).to(device)


# ---------------------------------------------------------------------------
# Host cascade
# ---------------------------------------------------------------------------


def _apply_regression_np(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    w = (boxes[:, 2] - boxes[:, 0] + 1)[:, None]
    h = (boxes[:, 3] - boxes[:, 1] + 1)[:, None]
    return boxes + reg * np.concatenate([w, h, w, h], axis=1)


def _square_boxes_np(boxes: np.ndarray) -> np.ndarray:
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    x1 = boxes[:, 0] + w * 0.5 - side * 0.5
    y1 = boxes[:, 1] + h * 0.5 - side * 0.5
    return np.stack([x1, y1, x1 + side, y1 + side], axis=1)


def _normalize(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) - 127.5) * (1.0 / 128.0)


def _crop_resize(img: np.ndarray, boxes: np.ndarray, size: int
                 ) -> np.ndarray:
    """Crop (zero-padded) + bilinear resize of candidate boxes, host-side;
    corners truncate toward zero."""
    from PIL import Image
    h, w = img.shape[:2]
    out = np.zeros((len(boxes), size, size, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes.astype(np.int64)):
        bw, bh = x2 - x1 + 1, y2 - y1 + 1
        if bw < 2 or bh < 2:
            continue
        patch = np.zeros((bh, bw, 3), np.uint8)
        sx1, sy1 = max(x1, 0), max(y1, 0)
        sx2, sy2 = min(x2 + 1, w), min(y2 + 1, h)
        if sx2 <= sx1 or sy2 <= sy1:
            continue
        patch[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = \
            img[sy1:sy2, sx1:sx2]
        out[i] = np.asarray(Image.fromarray(patch).resize(
            (size, size), Image.BILINEAR), np.float32)
    return _normalize(out)


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """(N, H, W, 3) host array → (N, 3, H, W) on the device."""
    return torch.from_numpy(x).to(device).permute(0, 3, 1, 2)


def pyramid_scales(h: int, w: int, min_face_size: int = MIN_FACE_SIZE
                   ) -> list[float]:
    m = 12.0 / min_face_size
    min_side = min(h, w) * m
    scales = []
    s = m
    while min_side >= 12:
        scales.append(s)
        s *= SCALE_FACTOR
        min_side *= SCALE_FACTOR
    return scales


def stage_pnet(net: MTCNN, img: np.ndarray, min_face_size: int,
               threshold: float) -> np.ndarray:
    """P-Net over the pyramid, one call a level: (K, 9) candidates
    [x1, y1, x2, y2, score, reg×4] after per-scale and global NMS."""
    from PIL import Image
    h, w = img.shape[:2]
    all_boxes = []
    for scale in pyramid_scales(h, w, min_face_size):
        hs, ws = int(np.ceil(h * scale)), int(np.ceil(w * scale))
        level = np.asarray(Image.fromarray(img).resize(
            (ws, hs), Image.BILINEAR), np.float32)
        with torch.inference_mode():
            prob, reg = net.pnet(_to_device(_normalize(level[None]),
                                            net.device))
        # keep the windows P-Net saw whole: ceil-mode pooling adds a row
        # (column) for an odd level that the JAX package's stack drops
        vh, vw = (hs - 12) // 2 + 1, (ws - 12) // 2 + 1
        prob = prob[0, 1, :vh, :vw].cpu().numpy()
        reg = reg[0, :, :vh, :vw].permute(1, 2, 0).cpu().numpy()
        ys, xs = np.where(prob > threshold)
        if len(ys) == 0:
            continue
        stride, cell = 2.0, 12.0
        x1 = np.round(stride * xs / scale)
        y1 = np.round(stride * ys / scale)
        x2 = np.round((stride * xs + cell) / scale)
        y2 = np.round((stride * ys + cell) / scale)
        boxes = np.stack([x1, y1, x2, y2], axis=1)
        scores = prob[ys, xs]
        keep = _nms_np(boxes, scores, 0.5)             # per-scale NMS
        all_boxes.append(np.concatenate(
            [boxes[keep], scores[keep, None], reg[ys, xs][keep]], axis=1))
    if not all_boxes:
        return np.zeros((0, 9))
    cand = np.concatenate(all_boxes)
    return cand[_nms_np(cand[:, :4], cand[:, 4], NMS_THRESHOLDS[0])]


def stage_rnet(net: MTCNN, img: np.ndarray, boxes: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """R-Net on the 24² crops of `boxes` → (prob (N,), reg (N, 4))."""
    with torch.inference_mode():
        prob, reg = net.rnet(_to_device(_crop_resize(img, boxes, 24),
                                        net.device))
    return prob[:, 1].cpu().numpy(), reg.cpu().numpy()


def stage_onet(net: MTCNN, img: np.ndarray, boxes: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """O-Net on the 48² crops → (prob (N,), reg (N, 4), landmarks (N, 10))."""
    with torch.inference_mode():
        prob, reg, lmk = net.onet(_to_device(_crop_resize(img, boxes, 48),
                                             net.device))
    return prob[:, 1].cpu().numpy(), reg.cpu().numpy(), lmk.cpu().numpy()


def detect_faces(net: MTCNN, img: np.ndarray,
                 min_face_size: int = MIN_FACE_SIZE,
                 thresholds=THRESHOLDS,
                 max_candidates: int = MAX_CANDIDATES) -> list[dict]:
    """img: (H, W, 3) uint8 RGB → list of {box, confidence, keypoints}.

    Mirrors the pip package's detect_faces output consumed at
    batch_mtcnn.py:53-67."""
    cand = stage_pnet(net, img, min_face_size, thresholds[0])
    if len(cand) == 0:
        return []
    cand = cand[:max_candidates]
    boxes = _square_boxes_np(_apply_regression_np(cand[:, :4], cand[:, 5:9]))

    prob, reg = stage_rnet(net, img, boxes)
    keep = prob > thresholds[1]
    boxes, prob, reg = boxes[keep], prob[keep], reg[keep]
    if len(boxes) == 0:
        return []
    keep = _nms_np(boxes, prob, NMS_THRESHOLDS[1])
    boxes = _square_boxes_np(_apply_regression_np(boxes[keep], reg[keep]))

    prob, reg, lmk = stage_onet(net, img, boxes)
    keep = prob > thresholds[2]
    boxes, prob, reg, lmk = boxes[keep], prob[keep], reg[keep], lmk[keep]
    if len(boxes) == 0:
        return []
    bw = boxes[:, 2] - boxes[:, 0] + 1
    bh = boxes[:, 3] - boxes[:, 1] + 1
    pts_x = boxes[:, 0:1] + lmk[:, 0:5] * bw[:, None]
    pts_y = boxes[:, 1:2] + lmk[:, 5:10] * bh[:, None]
    boxes = _apply_regression_np(boxes, reg)
    keep = _nms_np(boxes, prob, NMS_THRESHOLDS[2], mode="min")
    names = ["left_eye", "right_eye", "nose", "mouth_left", "mouth_right"]
    result = []
    for i in keep:
        x1, y1, x2, y2 = boxes[i]
        result.append({
            "box": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            "confidence": float(prob[i]),
            "keypoints": {n: (float(pts_x[i, j]), float(pts_y[i, j]))
                          for j, n in enumerate(names)},
        })
    return result


def _nms_np(boxes: np.ndarray, scores: np.ndarray, threshold: float,
            mode: str = "union") -> np.ndarray:
    """Host-side greedy NMS returning kept indices (sorted by score)."""
    if len(boxes) == 0:
        return np.array([], np.int64)
    order = np.argsort(-scores)
    keep = []
    alive = np.ones(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0] + 1) \
        * (boxes[:, 3] - boxes[:, 1] + 1)
    for idx in order:
        if not alive[idx]:
            continue
        keep.append(idx)
        x1 = np.maximum(boxes[idx, 0], boxes[:, 0])
        y1 = np.maximum(boxes[idx, 1], boxes[:, 1])
        x2 = np.minimum(boxes[idx, 2], boxes[:, 2])
        y2 = np.minimum(boxes[idx, 3], boxes[:, 3])
        inter = np.maximum(x2 - x1 + 1, 0) * np.maximum(y2 - y1 + 1, 0)
        if mode == "union":
            ov = inter / (areas[idx] + areas - inter)
        else:
            ov = inter / np.minimum(areas[idx], areas)
        alive &= ov <= threshold
    return np.asarray(keep, np.int64)


def select_face(results: list[dict],
                image_size: tuple[int, int] = (1500, 1500),
                confidence: float = 0.9) -> dict | None:
    """Most-central face above the confidence gate
    (batch_mtcnn.py:32-55)."""
    if not results:
        return None
    if len(results) == 1:
        best = results[0]
    else:
        center = np.array([image_size[0] / 2, image_size[1] / 2])
        best, lowest = None, float("inf")
        for r in results:
            pos = np.array(r["box"][:2]) + np.array(r["box"][2:]) / 2
            d = np.linalg.norm(pos - center)
            if d < lowest:
                lowest, best = d, r
    return best if best["confidence"] > confidence else None


def write_detection(result: dict, path: str) -> None:
    """5-point landmark txt (batch_mtcnn.py:73-79)."""
    kp = result["keypoints"]
    with open(path, "w") as f:
        for name in ("left_eye", "right_eye", "nose", "mouth_left",
                     "mouth_right"):
            x, y = kp[name]
            f.write(f"{float(x)} {float(y)}\n")
