"""setup_s: process start to the end of the warm image (host clock)."""


def read(run):
    return run["setup_s"]
