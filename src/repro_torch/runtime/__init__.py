"""Host-side step runtime: plan-keyed executable cache + StepProgram
lifecycle (DESIGN.md §7).

Port of ``src/repro/runtime/__init__.py``.
"""

from repro_torch.runtime.exec_cache import (DEFAULT_CAPACITY, ExecCacheStats,
                                            ExecutableCache)
from repro_torch.runtime.program import (LoweredStep, StepProgram,
                                        program_scope)

__all__ = ["DEFAULT_CAPACITY", "ExecCacheStats", "ExecutableCache",
           "LoweredStep", "StepProgram", "program_scope"]
