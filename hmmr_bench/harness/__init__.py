"""The harness: finding a cell's files, the run's clock and result line, the
inputs made from the seed, the profiler's trace and the planted faults."""
