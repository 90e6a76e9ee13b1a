"""image_s: the window's seconds over the images it completed (host clock):
what a user of a frame sequence or a batch of renders waits for each image."""


def read(run):
    if run.get("window_s") is None:
        return None
    return run["window_s"] / run["images"]
