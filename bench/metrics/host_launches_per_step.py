"""host_launches_per_step: kernel launches a traced step (each launch,
cudaLaunchKernel or cuLaunchKernelEx, counted once by the kernel it put
on the device), the mean over ranks."""

from bench.metrics._common import mean, traced


def read(run):
    return mean([t["launches"] / t["steps"] for t in traced(run)])
