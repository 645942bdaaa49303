"""Summarize a stability run's metrics.csv into a markdown report.

A copy of the JAX repo's ``scripts/summarize_stability.py`` (the port keeps
its own; it prints the same text from the same file). Checks the GAN health
criteria the reference monitors visually (doc/train.md:83-85): finite
losses throughout, adversarial equilibrium (d_pose neither collapsing to 0
nor exploding), and monotone-ish decay of the supervised losses. Emits
stability-report markdown plus the downsampled curve table.

Usage:
    python -m human_dynamics_tpu_torch.scripts.summarize_stability \
        {model_dir} > stability_run.md
"""

from __future__ import annotations

import csv
import sys


def main(model_dir: str) -> None:
    rows = list(csv.DictReader(open(f"{model_dir}/metrics.csv")))
    rows = [
        {k: float(v) for k, v in r.items()} for r in rows if r["e_loss"]
    ]
    steps = [int(r["step"]) for r in rows]

    def col(k):
        return [r[k] for r in rows]

    def fmt(v):
        return f"{v:.4f}"

    keys = ["e_loss", "d_loss", "e_kp", "e_pose", "d_pose", "e_smpl",
            "e_hallucinate", "e_const"]

    print("# Training stability run (synthetic, learnable)")
    print()
    print(f"Model dir: `{model_dir}`")
    print(f"Steps logged: {steps[0]}..{steps[-1]} ({len(rows)} rows)")
    print()

    bad = [
        k for k in keys
        if any(v != v or abs(v) > 1e6 for v in col(k))
    ]
    print(f"- Finite throughout: {'NO: ' + ', '.join(bad) if bad else 'yes'}")
    d = col("d_pose")
    dmin, dmax = min(d), max(d)
    half = len(d) // 2
    d_late = d[half:]
    print(
        f"- d_pose range {fmt(dmin)}..{fmt(dmax)}; last-half mean "
        f"{fmt(sum(d_late) / len(d_late))} (collapse would read ~0, "
        f"runaway would grow unbounded)"
    )
    e_kp = col("e_kp")
    print(
        f"- e_kp first/last tenth: "
        f"{fmt(sum(e_kp[:10]) / 10)} -> {fmt(sum(e_kp[-10:]) / 10)}"
    )
    e = col("e_loss")
    print(f"- e_loss first/last tenth: "
          f"{fmt(sum(e[:10]) / 10)} -> {fmt(sum(e[-10:]) / 10)}")
    print()

    print("| step | " + " | ".join(keys) + " |")
    print("|---" * (len(keys) + 1) + "|")
    stride = max(1, len(rows) // 20)
    for i in range(0, len(rows), stride):
        r = rows[i]
        print(
            f"| {int(r['step'])} | "
            + " | ".join(fmt(r[k]) for k in keys) + " |"
        )


if __name__ == "__main__":
    main(sys.argv[1])
