from human_dynamics_tpu_torch.infer.window import WindowSchedule
from human_dynamics_tpu_torch.infer.predictor import HmmrPredictor
from human_dynamics_tpu_torch.infer.streaming import StreamingPredictor
from human_dynamics_tpu_torch.infer.service import (
    PredictionService,
    StreamingSession,
)
