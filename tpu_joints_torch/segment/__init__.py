from tpu_joints_torch.segment.region_growing import region_growing, cluster_curvature_filter
from tpu_joints_torch.segment.sac import sac_plane, sac_cylinder
from tpu_joints_torch.segment.voxel import region_growing_voxel

__all__ = ["region_growing", "region_growing_voxel",
           "cluster_curvature_filter", "sac_plane", "sac_cylinder"]
