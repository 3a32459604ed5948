"""Platform choices, made in one place.

Every decision the engines take from the JAX backend they run on lives
here, one function per choice, so that a new platform or a new
measurement changes one line:

  - device_entropy_default: whether the batch engines assemble the JPEG
    bitstream on the device or hand the winning coefficients to the C++
    host coder;
  - data_mesh_devices: whether the batch engines shard each chunk over
    every local device;
  - emit_onehot_cap: how large the emission's one-hot assembly operand
    may grow before the windowed-gather route takes over.

Supported platforms are ``gpu`` (the accelerator the program is built
for) and ``cpu`` (tests and machines without an accelerator).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import jax

# Fallback one-hot cap, in bf16 elements, for devices that report no
# memory limit (the CPU backend): 1 << 31 elements = 4 GiB.
_DEFAULT_ONEHOT_CAP = 1 << 31


def device_entropy_default() -> bool:
    """Entropy arm for ``Options.device_entropy=None``.

    On ``gpu`` the bitstream is assembled on the device: on the 512-file
    500x500 Balanced ``compress_batch`` it ran at 581.44 img/s against
    357.44 img/s for the C++ host coder, with byte-identical outputs
    (NVIDIA H100 80GB HBM3, 400 W power limit, chip_smoke.py).  On
    ``cpu`` the C++ host coder codes the winners: emulating the vector
    emission on the CPU backend is slower than coding the scan directly.
    """
    return jax.default_backend() == "gpu"


def data_mesh_devices() -> Optional[List]:
    """Devices the batch engines shard each chunk over, or None.

    On for any multi-device ``gpu`` backend.  ``FENNEC_MESH=0`` turns it
    off; ``FENNEC_MESH=1`` turns it on for any multi-device backend,
    which is how the tests reach the sharded engines on virtual CPU
    devices.  A single device always runs the unsharded programs, whose
    outputs are byte-identical.
    """
    flag = os.environ.get("FENNEC_MESH", "")
    if flag == "0":
        return None
    devs = jax.devices()
    if len(devs) < 2:
        return None
    if flag != "1" and devs[0].platform != "gpu":
        return None
    return devs


@functools.lru_cache(maxsize=1)
def emit_onehot_cap() -> int:
    """Most bf16 elements the emission's matmul assembly may materialize
    in one program, counting the vmap batch factor: a quarter of the
    device's memory limit (``memory_stats()["bytes_limit"]``), or 4 GiB
    where the device reports no limit."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return _DEFAULT_ONEHOT_CAP
    return int(limit) // 4 // 2
