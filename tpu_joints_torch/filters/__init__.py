from tpu_joints_torch.filters.filters import (
    passthrough,
    voxel_downsample,
    uniform_sample_mask,
    compact_indices,
    compact_cloud,
    voxel_ids,
)

__all__ = [
    "passthrough",
    "voxel_downsample",
    "uniform_sample_mask",
    "compact_indices",
    "compact_cloud",
    "voxel_ids",
]
