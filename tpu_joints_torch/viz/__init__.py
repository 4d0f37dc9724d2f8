"""Host-side plots (counterpart of ``tpu_joints/viz``)."""
from tpu_joints_torch.viz.plot import (  # noqa: F401
    plot_clusters,
    plot_descriptor_histogram,
    plot_detection,
)
