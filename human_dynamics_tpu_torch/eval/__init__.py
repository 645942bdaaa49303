from human_dynamics_tpu_torch.eval.metrics import (
    compute_accel,
    compute_error_3d,
    compute_error_accel,
    compute_error_kp,
    compute_error_verts,
    align_by_pelvis,
    compute_similarity_transform,
    compute_opt_cam_with_vis,
)
