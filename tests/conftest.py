"""Test configuration: force CPU with 8 virtual devices and enable x64.

Math-identity tests check operators in float64 against hand-computed
references; multi-device tests use the virtual CPU mesh
(SURVEY.md §4 multi-node story).
"""

import os

# force CPU: tests never open an accelerator (a JAX process reserves most of
# a GPU's memory, so a second process on the same card fails)
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

# set the config knob as well, in case jax was imported before this file
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
