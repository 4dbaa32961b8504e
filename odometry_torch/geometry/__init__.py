from odometry_torch.geometry.se3 import (  # noqa: F401
    hat,
    mat_to_rt,
    rotation_angles_xyz,
    rt_to_mat,
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
    so3_exp,
    so3_log,
    vee,
)
