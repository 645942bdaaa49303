"""Per-layer metrics, one file each: ``SPEC`` (its BENCHMARK.json entry but
the cells) and ``read(reading)`` (its value from the traced window, or
None when the window holds nothing for it)."""
