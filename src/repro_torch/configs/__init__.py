"""Architecture configs: ``get_config(arch_id, smoke=False)`` and
``list_archs()``."""

from .base import ArchConfig, get_config, list_archs, register  # noqa: F401
