"""The benchmark of human_dynamics_tpu_torch on NVIDIA GPUs.

``python3 hmmr_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Cells,
configurations, traffic kinds, end-to-end and per-layer metrics are files
of this folder, found by name (``harness.core``).
"""
