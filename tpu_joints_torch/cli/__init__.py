"""Command-line entry points (counterpart of ``tpu_joints/cli``): render,
bank, detect, scenes, segment, crop, edges, var-desc, visualize, serve."""
from tpu_joints_torch.cli.main import build_parser, main  # noqa: F401
