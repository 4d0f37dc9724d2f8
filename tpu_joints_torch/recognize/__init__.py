from tpu_joints_torch.recognize.matching import match_nn, match_ratio
from tpu_joints_torch.recognize.hough import hough_group
from tpu_joints_torch.recognize.gc import gc_group
from tpu_joints_torch.recognize.icp import icp, fitness_score, scene_coverage_multi
from tpu_joints_torch.recognize.hv import verify_hypotheses
from tpu_joints_torch.recognize.obb import oriented_bounding_box

__all__ = [
    "match_nn",
    "match_ratio",
    "hough_group",
    "gc_group",
    "icp",
    "fitness_score",
    "scene_coverage_multi",
    "verify_hypotheses",
    "oriented_bounding_box",
]
