"""Rendering and drawing for the demo and the training summaries. No module
here imports cv2 at import time; drawing and video writing import it when
they run."""

from human_dynamics_tpu_torch.viz.renderer import VisRenderer
from human_dynamics_tpu_torch.viz.skeleton import draw_skeleton, draw_text
from human_dynamics_tpu_torch.viz.video import make_video
