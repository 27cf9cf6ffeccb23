"""Test configuration: force an 8-device virtual CPU mesh.

All tests run on CPU with `xla_force_host_platform_device_count=8` so
multi-device sharding (pjit/shard_map over a Mesh) is exercised without TPU
hardware, per the framework's CI strategy (SURVEY.md §4).

NOTE: in some environments (TPU plugin platforms) the JAX_PLATFORMS env var
is ignored; `jax.config.update('jax_platforms', ...)` is authoritative, so
both are set here before any backend initialization.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# persistent compile cache: the suite is compile-bound on the single-core CI
# host; warm runs skip all XLA compilation
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_test_cache")
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: multi-process / long-compile tests")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where there is none")
