from human_dynamics_tpu_torch.ops.smpl_cuda import (
    FusedSmplConstants,
    blend_skin,
    blend_skin_reference,
    prepare_fused_constants,
    smpl_forward_fused,
)
