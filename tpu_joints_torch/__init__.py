"""tpu_joints_torch — the PyTorch/CUDA port of ``tpu_joints``.

Same module layout and function names as the JAX package, so each module
has an obvious counterpart there: ``core/``, ``neighbors/``, ``filters/``,
``features/``, ``recognize/``, ``modelbank/``, ``pipelines/``. Plain
functions on tensors, fixed shapes padded with validity masks (invalid
points sit at ``core.cloud.SENTINEL``), no host synchronisation inside
``pipelines.detect.detect_organized``. The one TPU kernel on the main path
(the k=1 nearest-neighbour search) is a hand-written CUDA kernel,
``neighbors/csrc/nn1.cu``; on CPU tensors every wrapper runs its plain
PyTorch version.

The JAX reference computes every geometry and descriptor product at full
float32 precision, so TF32 is switched off here for matrix products and
for cuDNN convolutions alike.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from tpu_joints_torch.core.cloud import Cloud  # noqa: E402,F401
