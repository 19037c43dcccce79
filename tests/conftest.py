"""Test config: run on a virtual 8-device CPU mesh (sharding-testable without
accelerators); must set env before jax initializes."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# The tests compile many small programs once each; a persistent cache shared
# by the parallel test workers only adds disk traffic, and it would load
# XLA:CPU executables compiled for another host's CPU features.
jax.config.update("jax_enable_compilation_cache", False)
