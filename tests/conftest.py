"""Test harness: force CPU with a virtual 8-device mesh and float64.

Multi-device sharding tests run on a fake 8-device CPU backend
(the fake-backend the reference lacks; see SURVEY.md §4). The platform is
pinned both in the environment and through jax.config, so the suite runs
on the CPU even on a machine with a GPU; what needs the card is checked by
chip_smoke.py.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", jax.devices()

# Persistent XLA executable cache: the suite's wall time is dominated by
# CPU compiles of full jitted steps (~20 s per Model); with the cache a
# re-run of an unchanged tree compiles nothing. Keyed by HLO hash, so code
# changes invalidate exactly the affected entries.
from hnumo_tpu import compile_cache  # noqa: E402

compile_cache.enable()
