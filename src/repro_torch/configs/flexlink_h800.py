"""The paper's own evaluation configuration (§5.1): 8x H800, PCIe 5.0 x16,
one ConnectX-6 (50 GB/s) NIC per GPU behind a shared PCIe switch, 4 MB
pinned buffers per path, NCCL 2.27.3 baseline.

This drives the bandwidth benchmarks (Table 2 / Fig 2 / Fig 5), not a model
architecture.  A copy of ``src/repro/configs/flexlink_h800.py`` on the
port's core.
"""

import dataclasses
from typing import Tuple

from repro_torch.core.communicator import CommConfig
from repro_torch.core.simulator import MiB
from repro_torch.core.topology import Collective


@dataclasses.dataclass(frozen=True)
class BandwidthEvalConfig:
    profile: str = "h800"
    gpu_counts: Tuple[int, ...] = (2, 4, 8)
    message_mib: Tuple[int, ...] = (32, 64, 128, 256)
    collectives: Tuple[Collective, ...] = (Collective.ALL_REDUCE,
                                           Collective.ALL_GATHER)
    buffer_bytes: int = 4 * MiB            # §5.1 empirical buffer choice
    comm: CommConfig = dataclasses.field(
        default_factory=lambda: CommConfig(backend="flexlink",
                                           profile="h800"))


CONFIG = BandwidthEvalConfig()
