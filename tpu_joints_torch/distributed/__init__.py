"""Multi-device execution: device meshes, sharded batches, ring collectives
(counterpart of ``tpu_joints/distributed``). One process drives every
device of a ``(data, model)`` mesh; the collectives are explicit tensor
movement (``mesh.py``)."""
from tpu_joints_torch.distributed.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    bank_sharding,
    make_mesh,
    replicated,
    scene_sharding,
)
from tpu_joints_torch.distributed.batch import (  # noqa: F401
    detect_batch,
    shard_inputs,
    stack_clouds,
)
from tpu_joints_torch.distributed.halo import (  # noqa: F401
    halo_radius_neighbors,
    ring_icp,
    ring_knn,
    sharded_match_votes,
)
