"""Command-line entry points (counterpart of ``tpu_joints/cli``): the
``serve`` subcommand so far."""
from tpu_joints_torch.cli.main import build_parser, main  # noqa: F401
