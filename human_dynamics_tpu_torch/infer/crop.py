"""Frame crop and normalisation for demo inference, without cv2.

Counterpart of ``human_dynamics_tpu/infer/crop.py`` (the reference's
process_image, src/evaluation/run_video.py:56-107, and resize_img,
src/util/common.py:7-14). Steps: [0, 255] -> [-1, 1]; resize by the bbox
scale; edge-pad by IMG_SIZE; crop IMG_SIZE x IMG_SIZE around the scaled
centre. The returned metadata (center, scale, start_pt, im_shape) is what
the renderer needs to undo the crop.

The image arithmetic runs in torch on the frame's device (``device=``: on
the card the raw uint8 frame goes up once and the crop never comes back
through the host), in float64 as the JAX package's numpy does it, and the
crop is cast to float32 at the end. cv2.resize's bilinear interpolation is
``F.interpolate(mode="bilinear", align_corners=False)``: on float64 images
the two agree to a few float64 ulps (float32 would be ~1e-4 off), and
np.pad's "edge" mode is ``F.pad(mode="replicate")``. The centre, start
point and rounding stay numpy on the host (``np.round`` rounds half to
even), exactly as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMG_SIZE = 224


def resize_img(img, scale_factor: float) -> Tuple[object, list]:
    """Bilinear resize of an (H, W, C) float image by ``scale_factor``
    (cv2.resize's INTER_LINEAR), computed in float64.

    A tensor comes back as a float64 tensor on its device; a numpy array
    as a float64 numpy array. Returns the image and the actual [fy, fx]
    factors of the floored size.
    """
    new_size = (np.floor(np.array(img.shape[0:2]) * scale_factor)).astype(int)
    x = torch.as_tensor(img).to(torch.float64)
    out = F.interpolate(
        x.permute(2, 0, 1)[None], size=(int(new_size[0]), int(new_size[1])),
        mode="bilinear", align_corners=False,
    )[0].permute(1, 2, 0)
    actual_factor = [
        new_size[0] / float(img.shape[0]),
        new_size[1] / float(img.shape[1]),
    ]
    if isinstance(img, np.ndarray):
        out = out.numpy()
    return out, actual_factor


def process_image(
    image, bbox_param: np.ndarray, img_size: int = IMG_SIZE, device=None,
) -> Dict:
    """Crop an (H, W, 3) frame to an (img_size, img_size, 3) [-1, 1] crop.

    Args:
        image: raw frame, uint8 [0, 255] or floats in [0, 255]; a numpy
            array or a tensor.
        bbox_param: [cx, cy, scale].
        device: where the image arithmetic runs; None keeps the frame's
            own device (the CPU for a numpy array).

    Returns:
        dict(image, im_shape, center, scale, start_pt), as the JAX
        package's: ``image`` is a float32 tensor on ``device``, the rest
        is host data.
    """
    center = bbox_param[:2]
    scale = bbox_param[2]

    image = torch.as_tensor(image, device=device)
    image = ((image.to(torch.float64) / 255.0) - 0.5) * 2
    image_scaled, scale_factors = resize_img(image, scale)
    # [fy, fx] reversed to pair with [cx, cy] (isotropic, so the same).
    center_scaled = np.round(center * scale_factors[::-1]).astype(int)

    image_padded = F.pad(
        image_scaled.permute(2, 0, 1)[None],
        (img_size, img_size, img_size, img_size), mode="replicate",
    )[0].permute(1, 2, 0)
    height, width = image_padded.shape[:2]
    center_scaled = center_scaled + img_size

    margin = img_size // 2
    start_pt = (center_scaled - margin).astype(int)
    end_pt = (center_scaled + margin).astype(int)
    end_pt[0] = min(end_pt[0], width)
    end_pt[1] = min(end_pt[1], height)
    crop = image_padded[start_pt[1]:end_pt[1], start_pt[0]:end_pt[0], :]
    center_scaled = center_scaled - start_pt
    height, width = crop.shape[:2]

    return {
        "image": crop.to(torch.float32),
        "im_shape": [height, width],
        "center": center_scaled,
        "scale": scale,
        "start_pt": start_pt,
    }
