from tpu_joints_torch.pipelines.cluster_tree import (
    ViewClusters,
    detect_tree,
    make_view_clusters,
)
from tpu_joints_torch.pipelines.detect import (
    DetectionResult,
    SceneFeatures,
    detect,
    detect_with_features,
    good_instances,
    match_bank,
    prepare_scene,
)
from tpu_joints_torch.pipelines.multi import (
    MultiPartResult,
    detect_parts,
    detect_parts_organized,
)

__all__ = [
    "MultiPartResult",
    "detect_parts",
    "detect_parts_organized",
    "DetectionResult",
    "SceneFeatures",
    "ViewClusters",
    "detect",
    "detect_tree",
    "detect_with_features",
    "good_instances",
    "make_view_clusters",
    "match_bank",
    "prepare_scene",
]
