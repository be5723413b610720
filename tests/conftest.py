"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated on virtual CPU devices
(xla_force_host_platform_device_count); the GPU path is exercised by
``python chip_smoke.py`` on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from mipsfusion_tpu.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# big scan bodies (track/BA) take minutes to compile on CPU; cache them
# across runs so the default suite is fast after the first execution
enable_compile_cache()
