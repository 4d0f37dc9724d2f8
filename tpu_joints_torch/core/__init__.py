from tpu_joints_torch.core.cloud import Cloud, make_cloud, pad_cloud, bucket_size
from tpu_joints_torch.core import transforms
from tpu_joints_torch.core import io
from tpu_joints_torch.core import posefile

__all__ = ["Cloud", "make_cloud", "pad_cloud", "bucket_size", "transforms", "io", "posefile"]
