"""Faults planted under the timed path, to show that ``correct`` catches
them (the tests, and ``readings.py --fault`` on the card):

- ``answer_altered``: one frame of each served clip's present omega and
  vertices moved by 0.5 where the predictor produces them;
- ``state_unchanged``: ``Trainer.step`` computes its losses and leaves the
  models and Adam's state as they were;
- ``half_batch``: ``Trainer.step`` sees the first half of each batch's
  tubes, its losses the mean over them.

A training fault named ``<fault>@<n>`` starts at the trainer's step ``n``,
as a path that only a warm trainer takes would: the steps before it are
sound.
"""

from __future__ import annotations

import contextlib

FAULTS = ("answer_altered", "state_unchanged", "half_batch")


def parse(name: str):
    """(fault, first faulty step) of ``fault`` or ``fault@n``."""
    fault, _, after = name.partition("@")
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}, with @<step> or not")
    return fault, int(after or 0)


@contextlib.contextmanager
def planted(name: str):
    import torch

    from human_dynamics_tpu_torch.infer import predictor as P
    from human_dynamics_tpu_torch.train import trainer as T

    fault, after = parse(name)
    saved = [(P.HmmrPredictor, "predict_all_images",
              P.HmmrPredictor.predict_all_images), (T.Trainer, "step", T.Trainer.step)]
    sound_step = T.Trainer.step
    if fault == "answer_altered":
        orig = P.HmmrPredictor.predict_all_images

        def predict(self, *a, **kw):
            out = dict(orig(self, *a, **kw))
            mid = len(out["verts"]) // 2
            for k in ("omegas", "verts"):
                out[k] = out[k].clone()
                out[k][mid] += 0.5
            return out
        P.HmmrPredictor.predict_all_images = predict
    elif fault == "state_unchanged":
        def faulty(self, batch):
            with torch.no_grad(), T.full_fp32():
                self.dropout_generator.manual_seed(
                    T._step_seed(self.config.seed, self.state.step))
                _, _, metrics = T.compute_losses(
                    self.config, self.state.hmmr, self.state.disc, self.smpl, batch,
                    True, self.dropout_generator, self.fused_constants, self.mesh)
            return {k: v.detach() for k, v in metrics.items()}
    else:
        def faulty(self, batch):
            half = batch.phis.shape[0] // 2
            cut = [v if k == "poses_real" else v[:half]
                   for k, v in batch._asdict().items()]
            return sound_step(self, type(batch)(*cut))
    if fault != "answer_altered":
        def step(self, batch):
            return (faulty if self.state.step >= after else sound_step)(self, batch)
        T.Trainer.step = step
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
