"""Keep-aspect multiple-of-14 preprocessing + raw `infer_image` helper.

Port of the JAX package's `pipeline/raw_infer.py`: the reference transform
utils (`depth_anything_v2/util/transform.py:5-157`: `Resize` with
keep_aspect_ratio / ensure_multiple_of / lower_bound|upper_bound|minimal)
and the raw model's arbitrary-aspect inference path
(`depth_anything_v2_raw/dpt.py:186-222`: cv2 INTER_CUBIC keep-aspect
resize to >= 518 multiple-of-14, forward, bilinear align_corners=True
upsample back to the input size).

The size arithmetic and the image resize run on the host; the model
forward and the align_corners=True upsample run on the model's device.
The raw model normalises ImageNet-style inside its forward, so the host
side stops at [0,1] RGB.

cv2 is not installed on the card's machine, so `resize_cubic` is OpenCV's
INTER_CUBIC on a float64 image written out in numpy (cv2 5.0,
`imgproc/src/resize.cpp`: `resizeGeneric_` with `HResizeCubic<double,
double, float>` and `VResizeCubic<double, double, float>`; IPP takes no
64-bit images): source coordinate (x + 0.5) * scale - 0.5 computed in
double and rounded to float, its fraction in float, the A = -0.75 weights
in float arithmetic, replicated borders, the horizontal pass first, each
output a left-to-right sum of double products. tests/test_torch_raw_infer.py
holds it to `cv2.resize` bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.resize import resize2d

__all__ = ["constrain_to_multiple_of", "keep_aspect_size", "resize_cubic",
           "image2tensor_np", "infer_image"]


def constrain_to_multiple_of(x: float, multiple_of: int, *, min_val: int = 0,
                             max_val: int | None = None) -> int:
    """Reference `Resize.constrain_to_multiple_of` (transform.py:51-60):
    round to the nearest multiple; floor if that overshoots max_val;
    ceil if below min_val."""
    y = int(round(x / multiple_of) * multiple_of)
    if max_val is not None and y > max_val:
        y = int(math.floor(x / multiple_of) * multiple_of)
    if y < min_val:
        y = int(math.ceil(x / multiple_of) * multiple_of)
    return y


def keep_aspect_size(height: int, width: int, *, target_height: int,
                     target_width: int, multiple_of: int = 1,
                     keep_aspect_ratio: bool = True,
                     method: str = "lower_bound") -> tuple[int, int]:
    """Output (new_height, new_width) of the reference `Resize.get_size`
    (transform.py:62-108)."""
    scale_height = target_height / height
    scale_width = target_width / width

    if keep_aspect_ratio:
        if method == "lower_bound":
            # scale such that output size is a lower bound
            if scale_width > scale_height:
                scale_height = scale_width
            else:
                scale_width = scale_height
        elif method == "upper_bound":
            if scale_width < scale_height:
                scale_height = scale_width
            else:
                scale_width = scale_height
        elif method == "minimal":
            if abs(1 - scale_width) < abs(1 - scale_height):
                scale_height = scale_width
            else:
                scale_width = scale_height
        else:
            raise ValueError(f"resize_method {method} not implemented")

    if method == "lower_bound":
        bounds = dict(min_val=target_height), dict(min_val=target_width)
    elif method == "upper_bound":
        bounds = dict(max_val=target_height), dict(max_val=target_width)
    elif method == "minimal":
        bounds = {}, {}
    else:
        raise ValueError(f"resize_method {method} not implemented")
    new_height = constrain_to_multiple_of(scale_height * height, multiple_of,
                                          **bounds[0])
    new_width = constrain_to_multiple_of(scale_width * width, multiple_of,
                                         **bounds[1])
    return new_height, new_width


def _cubic_taps(in_size: int, out_size: int):
    """OpenCV's per-output first tap (sx - 1) and float32 weights [out, 4]
    for one axis of an INTER_CUBIC resize."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    sx = np.floor(f)
    x = (f - sx).astype(np.float32)
    a = np.float32(-0.75)
    one = np.float32(1)
    x1 = x + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    y = one - x
    c2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    idx = sx.astype(np.int64)[:, None] - 1 + np.arange(4)
    return (np.clip(idx, 0, in_size - 1),
            np.stack([c0, c1, c2, c3], axis=1).astype(np.float64))


def resize_cubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)` of a float64
    [H, W] or [H, W, C] image, bit for bit; `size` is (h, w)."""
    img = np.asarray(img, np.float64)
    out_h, out_w = int(size[0]), int(size[1])
    if img.shape[:2] == (out_h, out_w):
        return img.copy()
    cols, wx = _cubic_taps(img.shape[1], out_w)
    rows, wy = _cubic_taps(img.shape[0], out_h)
    wx = wx.reshape(wx.shape + (1,) * (img.ndim - 2))
    wy = wy.reshape(wy.shape + (1,) * (img.ndim - 1))
    horiz = img[:, cols[:, 0]] * wx[:, 0]
    for j in range(1, 4):
        horiz = horiz + img[:, cols[:, j]] * wx[:, j]
    out = horiz[rows[:, 0]] * wy[:, 0]
    for j in range(1, 4):
        out = out + horiz[rows[:, j]] * wy[:, j]
    return out


def image2tensor_np(raw_image_bgr: np.ndarray, input_size: int = 518):
    """Reference `image2tensor` (raw dpt.py:196-221) up to (not
    including) the ImageNet normalisation the model applies itself:
    BGR -> RGB, /255, keep-aspect lower-bound multiple-of-14 resize with
    OpenCV's INTER_CUBIC. Returns ([1, H', W', 3] float32 in [0,1], (h, w))."""
    h, w = raw_image_bgr.shape[:2]
    image = raw_image_bgr[..., ::-1] / 255.0
    nh, nw = keep_aspect_size(h, w, target_height=input_size,
                              target_width=input_size, multiple_of=14,
                              method="lower_bound")
    image = resize_cubic(image, (nh, nw))
    return np.ascontiguousarray(image, np.float32)[None], (h, w)


@torch.no_grad()
def infer_image(model, raw_image_bgr: np.ndarray, input_size: int = 518, *,
                attn_impl: str | None = None,
                dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Arbitrary-aspect raw depth inference (raw dpt.py:186-194) with a
    `RawDAV2` module: keep-aspect preprocess on the host, the forward and
    a bilinear align_corners=True upsample back to the input's (h, w) on
    the model's device. Returns [h, w] float32."""
    x, (h, w) = image2tensor_np(raw_image_bgr, input_size)
    device = next(model.parameters()).device
    depth = model(torch.from_numpy(x).to(device, dtype), attn_impl=attn_impl)
    depth = resize2d(depth[..., None].float(), size=(h, w),
                     method="bilinear", align_corners=True)
    return depth[0, :, :, 0].cpu().numpy()
