"""Device-resident compute kernels (JAX/XLA).

This is the device analogue of the reference's L1 compute layer
(ssim.go / resize.go / effects.go): every hot loop in the reference's Go
code becomes a jitted array program here.
"""

from .color import luminance_device, luminance_host  # noqa: F401
from .resize import (  # noqa: F401
    box_downsample,
    lanczos_resize,
    smart_resize,
    smart_resize_dims,
)
from .ssim import (  # noqa: F401
    ms_ssim,
    pixel_ssim,
    ssim,
    ssim_fast,
)
from .effects import (  # noqa: F401
    adaptive_sharpen,
    gaussian_blur,
    sharpen,
)
