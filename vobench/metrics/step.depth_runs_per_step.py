"""Depth-frontend runs per step of the window: the change of the SSD kernels'
launch counters (``kernels/disparity_band.LAUNCHES`` and
``disparity_full.LAUNCHES``; one launch per batched depth run at KITTI
width), over the window's steps, inits included."""


def read(run):
    steps = len(run.steps)
    return sum(run.window.launches.values()) / steps if steps else None
