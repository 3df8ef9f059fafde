"""peak_mem_gib: torch.cuda.max_memory_allocated() after the window, the
largest over the ranks, in GiB."""


def read(run):
    peaks = [r["peak_bytes"] for r in run["ranks"] if "peak_bytes" in r]
    return max(peaks) / 2 ** 30 if peaks else None
