"""Sliding-window scheduling for long-sequence inference.

A verbatim numpy copy of ``human_dynamics_tpu/infer/window.py``, kept in
the port because importing the JAX package's ``infer`` subpackage imports
JAX. It is the stitch math of the reference HMMR Tester.predict_all_images
(src/evaluation/tester.py:260-312):

    margin   = (fov - 1) // 2           # low-quality edge frames
    g        = T - 2 * margin           # good frames per window
    count    = ceil(N / (g * B))        # window groups of B windows
    num_fill = count * B * g + T - N    # zero frames appended at the back
    window i covers padded frames [i*g, i*g + T), i in [0, count*B)
    keep frames [margin, margin + g) of each window; concat; trim to N.

The schedule itself is tiny host math; the per-window compute is in
predictor.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WindowSchedule:
    num_frames: int      # N: real frames
    batch_size: int      # B: windows per group
    seq_length: int      # T: window length
    fov: int             # temporal receptive field

    @property
    def margin(self) -> int:
        return (self.fov - 1) // 2

    @property
    def good_frames(self) -> int:
        """g = T - 2*margin."""
        return self.seq_length - 2 * self.margin

    @property
    def count(self) -> int:
        """Number of window groups."""
        g = self.good_frames
        return int(np.ceil(self.num_frames / (g * self.batch_size)))

    @property
    def num_windows(self) -> int:
        return self.count * self.batch_size

    @property
    def num_fill(self) -> int:
        """Zero frames appended at the back (tester.py:284)."""
        return (
            self.count * self.batch_size * self.good_frames
            + self.seq_length
            - self.num_frames
        )

    @property
    def padded_length(self) -> int:
        """margin (front) + N + num_fill (back)."""
        return self.margin + self.num_frames + self.num_fill

    def window_starts(self) -> np.ndarray:
        """(num_windows,) start index of each window in the padded array."""
        return np.arange(self.num_windows) * self.good_frames

    def pad(self, frames: np.ndarray) -> np.ndarray:
        """Zero-pad (N, ...) frame data to (padded_length, ...)."""
        if len(frames) != self.num_frames:
            raise ValueError(
                f"Expected {self.num_frames} frames, got {len(frames)}"
            )
        pad_front = np.zeros((self.margin,) + frames.shape[1:], frames.dtype)
        pad_back = np.zeros(
            (self.num_fill,) + frames.shape[1:], frames.dtype
        )
        return np.concatenate([pad_front, frames, pad_back], axis=0)

    def stitch(self, windowed: np.ndarray) -> np.ndarray:
        """(count, B, g, ...) kept-center outputs -> (N, ...)."""
        flat = windowed.reshape((-1,) + windowed.shape[3:])
        return flat[: self.num_frames]
