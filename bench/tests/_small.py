"""A cell's files at a size the CPU runs in seconds: the published
widths cut by the family's ``small``, the traffic shortened, the cell's
limits kept."""

import time

from bench import cells, reference


def small_cell(cell: str, *, world: int = None, fault: str = "",
               seed: int = 2 ** 31 + 17, trace: bool = False):
    """The run spec of ``cell`` at a CPU size (``world`` gloo ranks)."""
    files = cells.load(cell)
    cfg = reference.family(files["config"]).small(files["config"])
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
