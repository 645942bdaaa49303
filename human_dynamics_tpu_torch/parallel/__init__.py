from human_dynamics_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    make_mesh_tp,
    shard_batch,
    shard_batch_2d,
    replicate,
)
from human_dynamics_tpu_torch.parallel.tp import (
    gathered as gathered_tp,
    shard_params_tp,
)
from human_dynamics_tpu_torch.parallel.multihost import (
    initialize as initialize_multihost,
    process_env,
)
