"""The port's configuration: the reference's frozen dataclasses and presets.

``odometry_tpu/config.py`` imports only the standard library, so the port
uses it as is rather than keeping a copy that could drift. The port's
modules import their configuration from here, the one place the port
reaches into the reference package.
"""

from odometry_tpu.config import (  # noqa: F401
    CameraConfig,
    DepthConfig,
    KeyframeConfig,
    PipelineConfig,
    TrackerConfig,
    accurate_config,
    adapt_to_camera,
    fast_config,
    kitti_config,
    tum_rgbd_config,
)
