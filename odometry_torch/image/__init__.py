from odometry_torch.image.pyramid import (  # noqa: F401
    central_gradients,
    depth_pyramid,
    gaussian_blur3,
    gaussian_image_pyramid,
    pyr_down,
)
from odometry_torch.image.sampling import (  # noqa: F401
    clip_gather_2d,
    gather_2d,
    sample_bilinear,
    sample_channels_mm,
)
