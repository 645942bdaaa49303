"""Device and idle time by the program's own phase spans.

The port names its phases with ``record_function`` ranges while a profiler
runs (``human_dynamics_tpu_torch.utils.logging.span``): the predictor's
"hmmr.encode", "hmmr.window" and, inside it, "hmmr.smpl"; the trainer's
"hmmr.train.forward" (with "hmmr.smpl" inside), "hmmr.train.backward" and
"hmmr.train.optimizer". They land in the traced window's trace beside the
kernels and their launch records, on the same clock, so a stretch in which
the device idles is charged to the phase whose host code launched the work
that ends it, from the moment that phase began. A program without the
spans (an older commit) gives no range, and its metrics read None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Optional, Sequence

SERVE = ("hmmr.encode", "hmmr.window")
TRAIN = ("hmmr.train.forward", "hmmr.train.backward", "hmmr.train.optimizer")
OUTSIDE = "outside"


def idle_by_span(reading, names: Sequence[str]) -> Dict[str, float]:
    """The window's idle seconds by span. Each gap in the device's work,
    walked as ``Reading.idle_gaps`` walks it, ends at a device operation
    launched at some host time; the ranges of ``names`` that hold that
    launch take the gap from their own start on, the innermost first, and
    what lies before the outermost's start goes to ``OUTSIDE``: a gap that
    opens before a phase began (the host between two clips, say) is not
    that phase's. Gaps whose operation was launched outside every range,
    and the stretch after the last operation, go to ``OUTSIDE`` whole.
    Names with no range in the trace are left out. The values sum to the
    window's length (``t1 - t0``) less ``busy_s``."""
    spans = sorted((s, e, n) for n in names for s, e in reading.ranges.get(n, ()))
    starts = [s for s, _, _ in spans]
    out = {n: 0.0 for n in names if n in reading.ranges}
    out[OUTSIDE] = 0.0

    def charge(g0: float, g1: float, at: Optional[float]) -> None:
        if at is not None:
            # The ranges that began by ``at`` and hold it, latest start
            # (innermost) first.
            for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
                s, e, n = spans[i]
                if e >= at and s < g1:
                    cut = max(g0, s)
                    out[n] += g1 - cut
                    g1 = cut
        out[OUTSIDE] += g1 - g0

    t0, t1 = reading.t0, reading.t1
    end = t0
    for ts, d, _, at in reading.device_events:
        g0, g1 = max(end, t0), min(ts, t1)
        if g1 > g0:
            charge(g0, g1, at)
        end = max(end, ts + d)
    out[OUTSIDE] += max(0.0, t1 - max(end, t0))
    return out


def device_ms(reading, name: str) -> Optional[float]:
    """Device milliseconds per unit of work launched inside ranges
    ``name``; None where the trace holds no such range."""
    s = reading.seconds_in_range(name)
    return None if s is None else s * 1e3 / reading.units


def idle_ms(reading, names: Sequence[str], name: str) -> Optional[float]:
    """Idle milliseconds per unit charged to ``name`` by ``idle_by_span``
    over ``names``; None where the trace holds no range ``name``."""
    s = idle_by_span(reading, names).get(name)
    return None if s is None else s * 1e3 / reading.units
