from tpu_joints_torch.features.eigen3 import eigh3x3, smallest_eigenvector
from tpu_joints_torch.features.normals import estimate_normals, estimate_normals_radius
from tpu_joints_torch.features.lrf import shot_lrf, board_lrf
from tpu_joints_torch.features.shot import compute_shot, SHOT_DIM
from tpu_joints_torch.features.fpfh import compute_fpfh, FPFH_DIM
from tpu_joints_torch.features.variance import compute_variance_descriptor
from tpu_joints_torch.features.edges import detect_edges
from tpu_joints_torch.features.iss import iss_keypoints

__all__ = [
    "eigh3x3",
    "smallest_eigenvector",
    "estimate_normals",
    "estimate_normals_radius",
    "shot_lrf",
    "board_lrf",
    "compute_shot",
    "SHOT_DIM",
    "compute_fpfh",
    "FPFH_DIM",
    "compute_variance_descriptor",
    "detect_edges",
    "iss_keypoints",
]
