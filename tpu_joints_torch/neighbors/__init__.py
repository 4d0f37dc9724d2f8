from tpu_joints_torch.neighbors.bruteforce import (
    knn,
    radius_neighbors,
    pairwise_sq_dist,
)
from tpu_joints_torch.neighbors.grid import (
    VoxelGrid,
    build_grid,
    grid_radius_neighbors,
)

__all__ = [
    "VoxelGrid",
    "build_grid",
    "grid_radius_neighbors",
    "knn",
    "pairwise_sq_dist",
    "radius_neighbors",
]
