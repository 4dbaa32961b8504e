from odometry_torch.camera.pinhole import (  # noqa: F401
    Pinhole,
    backproject,
    intrinsic_pyramid,
    level_intrinsics,
    project,
    warp_points,
)
from odometry_torch.camera.calibration import (  # noqa: F401
    MonoCalibration,
    RectifiedStereo,
    StereoCalibration,
    parse_kalibr_yaml,
    setup_stereo_from_kalibr,
    stereo_rectify,
)
