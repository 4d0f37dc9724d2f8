from tpu_joints_torch.modelbank.scanner import icosphere_vertices, render_views, view_poses
from tpu_joints_torch.modelbank.bank import ModelBank, build_bank, save_bank, load_bank

__all__ = [
    "icosphere_vertices",
    "render_views",
    "view_poses",
    "ModelBank",
    "build_bank",
    "save_bank",
    "load_bank",
]
