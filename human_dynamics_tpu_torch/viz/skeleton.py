"""2-D skeleton and text drawing.

Counterpart of ``human_dynamics_tpu/viz/skeleton.py`` (the reference's
draw_skeleton / draw_text, src/util/render/render_utils.py:9-234): the same
joint orders (19 cocoplus / 25 universal / 14 lsp), parent trees and colour
tables. cv2 draws, and is imported only inside the functions that draw.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

SKELETON_COLORS = {
    "pink": [197, 27, 125],
    "light_pink": [233, 163, 201],
    "light_green": [161, 215, 106],
    "green": [77, 146, 33],
    "red": [215, 48, 39],
    "light_red": [252, 146, 114],
    "light_orange": [252, 141, 89],
    "orange": [200, 90, 39],
    "purple": [118, 42, 131],
    "light_purple": [175, 141, 195],
    "light_blue": [145, 191, 219],
    "blue": [69, 117, 180],
    "gray": [130, 130, 130],
    "white": [255, 255, 255],
}

JOINT_COLORS = [
    "light_pink", "light_pink", "light_pink", "pink", "pink", "pink",
    "light_blue", "light_blue", "light_blue", "blue", "blue", "blue",
    "purple", "purple", "red", "green", "green", "white", "white",
    "orange", "light_orange", "orange", "light_orange", "pink",
    "light_pink",
]

PARENTS_19 = np.array(
    [1, 2, 8, 9, 3, 4, 7, 8, 12, 12, 9, 10, 14, -1, 13, -1, -1, 15, 16]
)
ECOLORS_19 = {
    0: "light_pink", 1: "light_pink", 2: "light_pink", 3: "pink",
    4: "pink", 5: "pink", 6: "light_blue", 7: "light_blue",
    8: "light_blue", 9: "blue", 10: "blue", 11: "blue", 12: "purple",
    17: "light_green", 18: "light_green", 14: "purple",
}

PARENTS_25 = np.array(
    [24, 2, 8, 9, 3, 23, 7, 8, 12, 12, 9, 10, 14, -1, 13, -1, -1, 15,
     16, 23, 24, 19, 20, 4, 1]
)
ECOLORS_25 = dict(ECOLORS_19)
ECOLORS_25.update({
    19: "orange", 20: "light_orange", 21: "orange", 22: "light_orange",
    23: "green", 24: "gray",
})

PARENTS_14 = np.array([1, 2, 8, 9, 3, 4, 7, 8, -1, -1, 9, 10, 13, -1])
ECOLORS_14 = {
    0: "light_pink", 1: "light_pink", 2: "light_pink", 3: "pink",
    4: "pink", 5: "pink", 6: "light_blue", 7: "light_blue",
    10: "light_blue", 11: "blue", 12: "purple",
}


def draw_skeleton(
    input_image: np.ndarray,
    joints: np.ndarray,
    draw_edges: bool = True,
    vis: Optional[np.ndarray] = None,
    radius: Optional[int] = None,
) -> np.ndarray:
    """Overlay a skeleton; joints (2, K) or (K, 2) in image coords."""
    import cv2

    if radius is None:
        radius = max(4, int(np.mean(input_image.shape[:2]) * 0.01))

    image = input_image.copy()
    if np.issubdtype(image.dtype, np.floating):
        image = (
            (image * 255) if image.max() <= 2.0 else image
        ).astype(np.uint8)

    joints = np.asarray(joints)
    if joints.shape[0] != 2:
        joints = joints.T
    joints = np.round(joints).astype(int)

    k = joints.shape[1]
    if k == 19:
        parents, ecolors = PARENTS_19, ECOLORS_19
    elif k == 25:
        parents, ecolors = PARENTS_25, ECOLORS_25
    elif k == 14:
        parents, ecolors = PARENTS_14, ECOLORS_14
    else:
        raise ValueError(f"Unknown skeleton with {k} joints")

    for child in range(k):
        if vis is not None and vis[child] == 0:
            continue
        point = joints[:, child]
        pcolor = SKELETON_COLORS[JOINT_COLORS[child % len(JOINT_COLORS)]]
        cv2.circle(image, tuple(point), radius - 1, pcolor, -1)
        cv2.circle(image, tuple(point), radius - 1, [0, 0, 0], 1)

        pa_id = parents[child]
        if draw_edges and pa_id >= 0:
            if vis is not None and vis[pa_id] == 0:
                continue
            point_pa = joints[:, pa_id]
            cv2.circle(image, tuple(point_pa), radius - 1,
                       SKELETON_COLORS[JOINT_COLORS[pa_id % len(JOINT_COLORS)]],
                       -1)
            ecolor = SKELETON_COLORS[ecolors.get(child, "gray")]
            cv2.line(image, tuple(point), tuple(point_pa), ecolor, radius - 2)

    return image


def draw_text(input_image: np.ndarray, content: Dict) -> np.ndarray:
    """Write key: value lines in the top-left corner
    (render_utils.py:9-35)."""
    import cv2

    image = input_image.copy()
    input_is_float = False
    if np.issubdtype(image.dtype, np.floating):
        input_is_float = True
        image = (image * 255).astype(np.uint8)

    black = (0, 0, 0)
    margin = 45
    start_x = 15
    start_y = margin
    for key in sorted(content.keys()):
        text = f"{key}: {content[key]}"
        cv2.putText(image, text, (start_x, start_y),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, black)
        start_y += margin

    if input_is_float:
        image = image.astype(np.float32) / 255.0
    return image


def normalized_kp_to_image(kps: np.ndarray, img_size: int) -> np.ndarray:
    """[-1, 1] normalized kps -> pixel coords ((kp + 1) * size / 2)."""
    return (np.asarray(kps) + 1.0) * 0.5 * img_size
