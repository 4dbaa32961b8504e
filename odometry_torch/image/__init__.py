from odometry_torch.image.pyramid import (  # noqa: F401
    central_gradients,
    depth_pyramid,
    gaussian_blur3,
    gaussian_image_pyramid,
    gradient_magnitude,
    median_blur3,
    pyr_down,
)
from odometry_torch.image.sampling import (  # noqa: F401
    clip_gather_2d,
    gather_2d,
    remap_bilinear,
    sample_bilinear,
    sample_bilinear_mm,
    sample_channels_mm,
    sample_floor,
)
