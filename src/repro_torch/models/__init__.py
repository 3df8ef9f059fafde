"""Port of ``src/repro/models/__init__.py`` (the ported slices' names)."""

from repro_torch.models.config import (ArchConfig, MoEConfig, SSMConfig,
                                       HybridConfig, EncDecConfig, VLMConfig)
from repro_torch.models.tp import ParallelCtx, single_device_ctx
from repro_torch.models.transformer import (DecodeConfig, PagedConfig,
                                            decode_step, forward, init_cache,
                                            init_paged_pool, init_params,
                                            lm_loss, paged_decode_step,
                                            param_specs)
