"""host_cpu_s_per_gib.stream (host process, all layers): the process's user
and system CPU seconds in the window (getrusage), per GiB that reached
device memory: what the pipeline costs the host. Per-layer metrics are read
in the --trace 1 run, so the reading includes torch.profiler's own host
work; compare it only between traced runs."""


def read(run):
    if not run.landed_bytes:
        return None
    return run.cpu_s / (run.landed_bytes / float(1 << 30))
