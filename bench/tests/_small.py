"""A cell's files at a size the CPU runs in seconds: the published
widths cut, the traffic shortened, the cell's limits kept."""

import time

from bench import cells


def small_cell(cell: str, *, world: int = None, fault: str = "",
               seed: int = 2 ** 31 + 17, trace: bool = False):
    """The run spec of ``cell`` at a CPU size (``world`` gloo ranks)."""
    files = cells.load(cell)
    cfg = dict(files["config"])
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128,
               vocab_size=256)
    if cfg["family"] == "moe":
        cfg.update(num_local_experts=4)
    world = world or files["cell"]["chips"]
    trf = dict(files["traffic"], seq_len=64, pool=8, ranks=world)
    prog = dict(files["cell"]["program"],
                bucket_mb=0.01 if world > 1 else 0)
    cell_spec = dict(files["cell"], chips=world, program=prog)
    return {"config": cfg, "cell": cell_spec, "traffic": trf, "seed": seed,
            "seconds": 0.5, "trace": trace, "device": "cpu",
            "dist": "gloo", "t_process": time.time(), "timeout_s": 300,
            "fault": fault}


def small_files(spec):
    return {"cell": spec["cell"], "config": spec["config"],
            "traffic": spec["traffic"]}
