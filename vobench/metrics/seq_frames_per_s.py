"""Every lane-frame completed in the window (init frames included), over the
window's seconds (host clock)."""


def read(run):
    return run.window.frames_done / run.window.window_s
