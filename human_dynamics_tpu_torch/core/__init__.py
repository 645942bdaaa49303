from human_dynamics_tpu_torch.core.rotations import (
    skew_symmetric,
    rodrigues,
    rot_to_axis_angle,
    rotation_deltas,
    lrotmin,
)
from human_dynamics_tpu_torch.core.smpl import (
    SmplForward,
    SmplModel,
    convert_smpl_pkl,
    global_rigid_transformation,
    load_smpl_model,
    smpl_forward,
    synthetic_smpl_model,
)
from human_dynamics_tpu_torch.core.projection import (
    orth_proj_idrot,
    procrustes2d_vis,
    orth_proj_optcam,
)
