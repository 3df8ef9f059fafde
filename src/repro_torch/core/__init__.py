"""FlexLink core of the port: heterogeneous-link collective aggregation on
torch process groups (port of ``src/repro/core/``).

``links``, ``topology``, ``simulator``, ``tuner``, ``balancer``,
``pipeline`` and ``codecs`` are plain-Python copies of the reference's
modules; ``collectives``, ``routing`` and ``communicator`` are ports.  The
names below, and the ``collectives`` module, are re-exported lazily (PEP
562), so importing this package loads none of them, and the control plane
(``repro_torch.control``) can import the core leaf modules without
re-entering it.
"""

_EXPORTS = {
    "LinkKind": "links", "LinkSpec": "links", "NodeProfile": "links",
    "PROFILES": "links", "idle_bw_opportunity": "links",
    "Collective": "topology", "RingSchedule": "topology",
    "PathTimingModel": "simulator", "NCCL_BASELINE_GBPS": "simulator",
    "FLEXLINK_IMPROVEMENT_PCT": "simulator", "MiB": "simulator",
    "SHARE_GRID": "tuner", "TuneResult": "tuner",
    "initial_tune": "tuner", "initialize_shares": "tuner",
    "Evaluator": "balancer", "LoadBalancer": "balancer",
    "CommConfig": "communicator", "FlexCommunicator": "communicator",
    "comm_init_rank": "communicator", "comm_destroy_all": "communicator",
}


def __getattr__(name):
    import importlib
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name == "collectives":       # the module itself, as the reference's
        return importlib.import_module(f"{__name__}.collectives")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
