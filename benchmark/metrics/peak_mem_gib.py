"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window after a
reset, the largest rank's on a mesh, in GiB."""


def read(run):
    if run.get("window_s") is None:
        return None
    return run["peak_bytes"] / 2**30
