from odometry_torch.camera.pinhole import (  # noqa: F401
    Pinhole,
    backproject,
    intrinsic_pyramid,
    level_intrinsics,
    project,
)
