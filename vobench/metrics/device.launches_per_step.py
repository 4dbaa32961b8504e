"""Kernels the card ran per traced step (copies and memsets not counted)."""


def read(run):
    if run.trace is None or run.trace.steps == 0:
        return None
    return run.trace.kernels / run.trace.steps
