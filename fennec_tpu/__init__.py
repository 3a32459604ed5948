"""fennec-tpu — perceptual image compression on an accelerator.

A from-scratch JAX/XLA framework with the capabilities of the reference
Go library (shamspias/fennec): SSIM-guided JPEG quality search,
target-file-size optimization, perceptual color quantization, Lanczos-3
resize, MS-SSIM, image analysis, EXIF orientation, effects, and a batch
engine — redesigned for an accelerator: images are device arrays, every
hot loop is a fused XLA program, the JPEG quality bisection runs on
device with DCT coefficients cached across probes, and batches shard
over device meshes.

Quick start::

    import fennec_tpu as fennec

    result = fennec.compress_file(None, "in.jpg", "out.jpg",
                                  fennec.Options(quality=fennec.BALANCED))
    print(result)
"""

import os as _os

if _os.environ.get("FENNEC_FORCE_CPU"):
    # Deterministic CPU backend (CLI tests, examples) even when a GPU is
    # present: set through the config as well as the environment, so a
    # JAX initialised before this import still honours it.
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")

from .analyze import ImageStats, analyze  # noqa: F401
from .api import (  # noqa: F401
    compress,
    compress_bytes,
    compress_file,
    compress_image,
    compress_images,
)
from .batch import (  # noqa: F401
    BatchItem,
    BatchOptions,
    BatchResult,
    BatchSummary,
    compress_batch,
    summarize,
)
from .exif import (  # noqa: F401
    Orientation,
    apply_orientation,
    read_orientation,
)
from .io import (  # noqa: F401
    encode,
    open_and_orient,
    open_image,
    save,
)
from .ops import (  # noqa: F401
    adaptive_sharpen,
    box_downsample,
    gaussian_blur,
    lanczos_resize,
    ms_ssim,
    sharpen,
    smart_resize,
    ssim,
    ssim_fast,
)
from .types import (  # noqa: F401
    AGGRESSIVE,
    AUTO,
    BALANCED,
    HIGH,
    JPEG,
    LOSSLESS,
    MAXIMUM,
    PNG,
    ULTRA,
    VERSION,
    CanceledError,
    Context,
    EmptyImageError,
    FennecError,
    Format,
    NilImageError,
    NoCompressedDataError,
    Options,
    ProgressStage,
    Quality,
    Result,
    UnsupportedFormatError,
    ValidationError,
    default_options,
    human_bytes,
)

__version__ = VERSION
