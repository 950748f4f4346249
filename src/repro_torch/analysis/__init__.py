"""Static checks of the recorder geometry (the memory half of the
reference's ``analysis`` package)."""

from .memory_model import (DEFAULT_BUDGET_KB,  # noqa: F401
                           MemoryBudgetError, validate_config,
                           validate_params)
