"""The closed training loop on synthetic data, runnable as modules.

Counterparts of the JAX repo's ``scripts/`` of the same names:

- ``stability_run``: the synthetic data generator (known-Omega tubes
  through the port's SMPL and projection, phi or rendered skeleton frames)
  and the long GAN stability run on it;
- ``summarize_stability``: a stability run's ``metrics.csv`` as markdown;
- ``synthetic_gauntlet``: train -> checkpoint -> eval -> demo pkl on the
  generator's records, with its gates and report.

    python -m human_dynamics_tpu_torch.scripts.synthetic_gauntlet --out D \\
        [--mode image] [--device cpu]

Every entry point runs on the CUDA device unless given ``--device``.
"""
