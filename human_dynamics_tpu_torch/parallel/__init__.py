from human_dynamics_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    make_mesh_tp,
    shard_batch,
    shard_batch_2d,
    shard_params_tp,
    replicate,
)
from human_dynamics_tpu_torch.parallel.multihost import (
    initialize as initialize_multihost,
    process_env,
)
