"""Seconds from the start of the process to the window: imports, rendering
the frames on the card, building the program's kernels where the checkout
has no build yet, and the warm-up steps (host clock)."""


def read(run):
    return run.setup_s
