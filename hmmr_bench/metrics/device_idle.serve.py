"""The device's idle share of the traced window of served clips: the
seconds in which no device operation ran over the window's seconds. The
profiler's host cost lengthens a host-bound window, so this reads higher
than an untraced clip would."""

SPEC = {"unit": "%", "better": "lower", "source": "device_trace",
        "layer": "device", "moves": "clip_fps"}


def read(reading):
    if not reading.device_events:
        return None
    return (1.0 - reading.busy_s / reading.window_s) * 100.0
