"""Port of ``src/repro/models/__init__.py`` (the serving slice's names)."""

from repro_torch.models.config import (ArchConfig, MoEConfig, SSMConfig,
                                       HybridConfig, EncDecConfig, VLMConfig)
from repro_torch.models.tp import ParallelCtx, single_device_ctx
from repro_torch.models.transformer import (DecodeConfig, PagedConfig,
                                            decode_step, init_cache,
                                            init_paged_pool, init_params,
                                            paged_decode_step)
