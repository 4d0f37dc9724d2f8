"""Native (C++) host runtime: PCD reading, point ingestion, depth
unprojection (counterpart of ``tpu_joints/native``). Every entry returns
None without the library; ``available()`` says whether it is built."""
from tpu_joints_torch.native.loader import (  # noqa: F401
    available,
    depth_to_cloud_native,
    get_lib,
    ingest_native,
    load_pcd_native,
)
