"""Test-session configuration.

Tests run on the CPU with a virtual 8-device mesh
(``--xla_force_host_platform_device_count=8``), so the multi-device
sharding logic is exercised without accelerators.  The program itself runs
on the GPU through ``python chip_smoke.py`` (``--four`` on four cards),
whose phases hold the checks that need the card.  The platform is pinned
here, before any backend initializes.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8, "virtual CPU mesh not active"

# persistent compilation cache: XLA:CPU compiles of the big IPM step graphs
# dominate the suite's wall time.  JAX_COMPILATION_CACHE_DIR wins when set;
# otherwise a cache in the home directory, outside the checkout, so the
# tree stays small.  Keyed by HLO + config, so a changed module recompiles;
# IXM_TEST_NO_CACHE=1 opts out for a cold-timing run.
if os.environ.get("IXM_TEST_NO_CACHE", "0") == "0":
    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            _cache = os.path.expanduser("~/.ixm_test_jax_cache")
            os.makedirs(_cache, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", _cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except Exception:
        pass
