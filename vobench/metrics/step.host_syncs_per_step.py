"""Device-to-host copies in the trace, per traced step: each is a point where
the host waits for the card (the program's reads of candidate masks and LM
flags, and the harness's one summary read)."""


def read(run):
    if run.trace is None or run.trace.steps == 0:
        return None
    return run.trace.dtoh_copies / run.trace.steps
