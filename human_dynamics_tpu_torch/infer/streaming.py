"""Online (live-video) streaming inference.

Counterpart of ``human_dynamics_tpu/infer/streaming.py``. The offline
predictor needs the whole clip; StreamingPredictor emits the SAME
per-frame outputs incrementally, with a fixed input lookahead of
``latency_frames`` frames:

- The temporal encoder has a finite receptive field (fov = 13), so frame
  k's output depends only on phi[k-6 : k+7): once 6 frames of lookahead
  exist, its outputs are final. Emissions equal predict_all_images on the
  full clip (the same window-group code on the same phi values; the flush
  pads with zero phi exactly like the offline schedule).
- State between steps is the last 2*margin per-frame features (a
  (12, 2048) tensor on the device), not images: the steady-state cost is
  one encoder pass per frame plus one window group per quantum.
- Emission quantum = batch_size * g frames (g = T - 2*margin = 8): build
  the wrapped HmmrPredictor with batch_size=1 for the lowest latency (an
  emission every 8 frames) or larger for bigger batches on the device.
- In image mode each emission encodes its frames and runs its window
  group back to back on the device's current stream.

Usage:
    pred = HmmrPredictor(model, None, smpl, batch_size=1)
    sp = StreamingPredictor(pred)
    for frames in camera:              # any-size frame batches
        for out in sp.feed(frames):    # dicts of (quantum, ...) tensors
            consume(out)
    for out in sp.flush():             # remaining frames
        consume(out)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from human_dynamics_tpu_torch.infer.predictor import HmmrPredictor


# Copies of the JAX predictor's compile-count buckets (its predictor.py),
# kept for one numeric use only: the JAX streaming flush encodes its last
# frames zero-padded to _bucket(r) frames, and dynamic int8 scales see that
# padding.
def _next_pow2(x: int) -> int:
    """Smallest power of two >= x."""
    return 1 << max(0, (x - 1)).bit_length()


def _bucket(x: int) -> int:
    """Smallest of {2^k, 3*2^k} >= x."""
    p = _next_pow2(x)
    if p >= 4 and 3 * (p // 4) >= x:
        return 3 * (p // 4)
    return p


class StreamingPredictor:
    """Incremental windowed prediction with offline-identical outputs.

    Args:
        predictor: a configured HmmrPredictor (its batch_size sets the
            emission quantum; all its precision options hold).
        as_numpy: fetch emissions to host numpy arrays (by default they
            stay tensors on the predictor's device, as with
            predict_all_images(as_numpy=False)).
    """

    def __init__(self, predictor: HmmrPredictor, as_numpy: bool = False):
        self._p = predictor
        self.as_numpy = as_numpy
        self.margin = (predictor.model.fov - 1) // 2
        self.good = predictor.seq_length - 2 * self.margin
        self.quantum = predictor.batch_size * self.good
        self._image_mode = getattr(predictor.model, "include_resnet", False)
        self._ids = torch.zeros(1, dtype=torch.long, device=predictor.device)
        self.reset()

    def reset(self) -> None:
        """Forget all stream state (start a new clip)."""
        self._pending: List[torch.Tensor] = []  # un-encoded real frames
        self._pending_n = 0
        # (2*margin, C) phi of the last frames; None before the first step.
        self._tail: Optional[torch.Tensor] = None
        self._uint8: Optional[bool] = None
        self._finished = False

    @property
    def latency_frames(self) -> int:
        """Input frames needed beyond a frame before its output emits
        (worst case: quantum-1 frames of queue wait + margin lookahead)."""
        return self.quantum + self.margin

    # ------------------------------------------------------------------

    def _encode(self, frames: torch.Tensor,
                pad_to: Optional[int] = None) -> torch.Tensor:
        """Real frames -> (M, C) f32 phi, in one encoder call."""
        if not self._image_mode:
            return frames.to(torch.float32)
        return self._p._encode_chunk(frames, pad_to=pad_to)

    def _take(self, n: int) -> torch.Tensor:
        """Pop the first n pending frames."""
        parts, got = [], 0
        while got < n:
            head = self._pending[0]
            need = n - got
            if len(head) <= need:
                parts.append(head)
                got += len(head)
                self._pending.pop(0)
            else:
                parts.append(head[:need])
                self._pending[0] = head[need:]
                got = n
        self._pending_n -= n
        return torch.cat(parts)

    def _run_step(self, phi_new: torch.Tensor) -> Dict:
        """Advance one window group; phi_new has quantum entries (+margin
        on step 0, where the front pad is zeros)."""
        if self._tail is None:
            front = phi_new.new_zeros((self.margin, phi_new.shape[-1]))
        else:
            front = self._tail
        buf = torch.cat([front, phi_new])          # ((B-1)*g + T, C)
        out = self._p._run_groups(buf, self._ids, self.margin, self.good)
        self._tail = buf[-2 * self.margin:]
        out = {k: v.flatten(0, 1) for k, v in out.items()}
        if self.as_numpy:
            out = {k: v.cpu().numpy() for k, v in out.items()}
        return out

    def _need(self) -> int:
        """Real frames required before the next step can run."""
        return self.quantum + (self.margin if self._tail is None else 0)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def feed(self, frames) -> List[Dict]:
        """Append frames ((N, H, W, 3) images, uint8 or [-1, 1] floats, or
        (N, C) phi; numpy arrays or tensors); returns the emissions they
        complete (possibly none)."""
        if self._finished:
            raise RuntimeError("stream finished; call reset() first")
        frames = torch.as_tensor(frames)
        if len(frames) == 0:
            return []
        is_uint8 = frames.dtype == torch.uint8
        if self._uint8 is None:
            self._uint8 = is_uint8
        elif self._uint8 != is_uint8:
            raise ValueError("mixed uint8/float frames in one stream")
        frames = frames.to(self._p.device)
        self._pending.append(frames if is_uint8 else frames.float())
        self._pending_n += len(frames)

        emissions = []
        while self._pending_n >= self._need():
            # A step encodes exactly its own frames: quantum, + margin on
            # the first step.
            emissions.append(self._run_step(
                self._encode(self._take(self._need()))))
        return emissions

    @torch.inference_mode()
    def flush(self) -> List[Dict]:
        """Finish the stream: emit outputs for all remaining frames
        (zero-phi back fill, exactly the offline schedule's padding). The
        final emission is trimmed to the real frame count."""
        if self._finished:
            raise RuntimeError("stream finished; call reset() first")
        self._finished = True
        r = self._pending_n   # un-encoded real frames
        # Un-emitted frames: the tail also holds `margin` encoded frames
        # whose outputs have not been emitted yet.
        u = r + (self.margin if self._tail is not None else 0)
        if u == 0:
            return []
        if r:
            phi_real = self._encode(self._take(r), pad_to=_bucket(r))
        else:
            phi_real = self._tail.new_zeros((0, self._tail.shape[-1]))
        emissions = []
        emitted = 0
        offset = 0  # consumed entries of phi_real
        for _ in range(-(-u // self.quantum)):
            need = self._need()
            chunk = phi_real[offset:offset + need]
            offset += chunk.shape[0]
            chunk = F.pad(chunk, (0, 0, 0, need - chunk.shape[0]))
            out = self._run_step(chunk)
            keep = min(self.quantum, u - emitted)
            if keep < self.quantum:
                out = {k: v[:keep] for k, v in out.items()}
            emitted += keep
            emissions.append(out)
        return emissions
