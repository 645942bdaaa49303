from human_dynamics_tpu_torch.train.losses import (
    keypoint_l1_loss,
    keypoint_l1_loss_optcam,
    loss_3d,
    masked_mse,
    beta_smoothness_loss,
    shape_prior_loss,
    lsgan_encoder_loss,
    lsgan_disc_fake_loss,
    lsgan_disc_real_loss,
    align_by_pelvis,
)
from human_dynamics_tpu_torch.train.trainer import (
    TrainConfig,
    TrainState,
    Trainer,
    create_train_state,
    train_step,
)
