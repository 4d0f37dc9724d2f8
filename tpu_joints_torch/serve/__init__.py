"""Serving layer: HTTP request server + depth→cloud ingestion + fake camera
(counterpart of ``tpu_joints/serve``).

Replaces the reference's ROS topic surface (scene subscription at
``SHOT.cpp:598``, grasp-centroid publication at ``FPFH_demo.cpp:890-915``,
simulator depth bridge at ``ROS_server.cpp:2112-2176``) with a host-side
HTTP/JSON front over the pipeline on the bank's device.
"""
from tpu_joints_torch.serve.depth import (  # noqa: F401
    FakeDepthCamera,
    depth_to_cloud,
    pixel_scales,
)
from tpu_joints_torch.serve.server import (  # noqa: F401
    BadRequest,
    DetectionService,
    make_server,
    scene_points_from_request,
    serve_forever,
)
