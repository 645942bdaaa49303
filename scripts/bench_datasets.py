#!/usr/bin/env python3
"""chip_smoke.py's phase 17 alone: the dataset tools on the card.

    python3 scripts/bench_datasets.py

Needs one CUDA card, nvcc (K1 runs in the training step) and cv2. It makes
the full-width model and the synthetic SMPL model as chip_smoke.py's main
does (seeded weights) and runs ``chip_smoke.phase_datasets``: 150 JPEG
frames of 720x1280 with a walking person's keypoints; the phis of 24
augmented crops on the card against the CPU; TubeConverter.write_tubes on
the card (a 150- and a 24-frame tube, one shard), the short tube held to
the same converter on the CPU, a rerun skipping the shard; the ms per
150-frame tube split into host crops, augmentation, phis and the record's
encoding and write, and the phis' frames/s at batch 64; the shard through
the phi-mode TrainDataPipeline into one full-width Trainer.step;
fit_neutral_shape at V = 6890 (the card's first 100 steps against the CPU,
then the whole fit: iterations, ms per iteration, the recovered beta); a
test record of the 150 frames read back.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import numpy as np
    import torch

    import chip_smoke as S

    if not torch.cuda.is_available():
        raise SystemExit("bench_datasets: no CUDA device; this script needs "
                         "one GPU")
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.models import HmmrModel
    from human_dynamics_tpu_torch.ops import smpl_cuda

    card = S.card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(num_verts=S.SMPL_VERTS, num_kps=S.SMPL_KPS,
                                device=dev)
    model = HmmrModel(include_resnet=True, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    result = S.phase_datasets(torch, np, dev, model, smpl, smpl_cuda, card)
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    print(result)
    print(card)


if __name__ == "__main__":
    main()
