"""The named presets. Their one home is ``desmo_tpu.configs``, which imports
no jax; the port re-exports it so its users name one package."""

from desmo_tpu.configs import GROUP_ORDER, RunConfig, get, names  # noqa: F401
