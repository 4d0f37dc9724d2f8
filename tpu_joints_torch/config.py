"""Pipeline configuration (counterpart of ``tpu_joints/config.py``).

The same frozen dataclass with the same fields and defaults, so one
configuration drives both packages (``from_dict(dataclasses.asdict(cfg))``
turns the JAX package's config into this one). Field meanings are
documented on the reference's ``DetectionConfig``.

Fields that only steer TPU-runtime workarounds are accepted and ignored
here: ``icp_rows_per_call`` and ``icp_allow_pallas`` (every k=1 NN runs the
one CUDA kernel, in one call).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    # descriptor
    descriptor: str = "shot"
    descr_rad: float = 0.02
    rf_rad: float = 0.015
    rf_frames: str = "shot"
    rf_k_max: int = 256
    # sampling
    model_ss: float = 0.01
    scene_ss: float = 0.03
    keypoints: str = "uniform"
    key_group: int = 3
    iss_gamma_21: float = 0.975
    iss_gamma_32: float = 0.975
    # normals
    normal_k: int = 40
    normal_radius: float = 0.0
    normal_anchors: int = 0
    fpfh_surface: str = "cloud"
    fpfh_k_max: int = 0
    # matching
    match_mode: str = "nn"
    match_threshold: float = 0.25
    ratio: float = 1.0
    # grouping
    algorithm: str = "hough"
    cg_size: float = 0.03
    cg_thresh: float = 3.0
    use_distance_weight: bool = True
    max_instances_per_view: int = 4
    view_grouped_candidates: bool = False
    peak_grouped_candidates: bool = False
    split_rotation_modes: bool = False
    # refinement
    icp_iterations: int = 30
    icp_max_corr_dist: float = 3.0e38
    icp_max_corr_start: float = 0.0
    icp_point_to_plane: bool = False
    max_candidates: int = 4
    icp_rows_per_call: int = 0        # TPU workaround: ignored
    icp_allow_pallas: bool = True     # TPU workaround: ignored
    accept_fitness: float = 0.001
    select_by_model_fitness: bool = True
    rank_scene_coverage: bool = True
    coverage_clip: float = 0.05
    coverage_accept: float = 0.0
    coverage_local: bool = False
    refine_top: int = 0
    tier1_rows: int = 512
    tier1_iterations: int = 0
    tier1_view_iterations: int = 0
    tier1_polish_iterations: int = 0
    tier1_skip_view_fitness: bool = False
    final_icp_iterations: int = 0
    final_accept_fitness: float = 0.006
    final_point_to_plane: bool = True
    # verification
    hv_enabled: bool = False
    hv_inlier_threshold: float = 0.005
    hv_occlusion_threshold: float = 0.001
    hv_regularizer: float = 0.001
    # scene crop
    remove_plane: bool = False
    plane_dist: float = 0.02
    plane_min_fraction: float = 0.15
    segment_scene: bool = False
    rg_smoothness_deg: float = 7.0
    rg_curvature: float = 7.0
    rg_min_cluster: int = 50
    rg_backend: str = "graph"
    rg_voxel_leaf: float = 0.0
    rg_voxel_grid: int = 64
    rg_voxel_pitch: float = 0.005
    rg_max_edge: float = 3.0e38
    cluster_max_curvature: float = 0.04
    obb_largest_cluster: bool = False
    # capacities (static shapes)
    scene_capacity: int = 16384
    scene_key_capacity: int = 1024
    k_max: int = 96


def from_dict(d: dict) -> DetectionConfig:
    """DetectionConfig from a field dict; unknown fields raise TypeError."""
    return DetectionConfig(**d)
