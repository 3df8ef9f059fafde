"""setup_s: from the process's start to the window's first step (imports,
spawn, process groups, weights from the seed, the checked steps, warm-up),
the latest rank's."""


def read(run):
    return max(r["setup_s"] for r in run["ranks"])
