"""LM iterations captured in a CUDA graph over the run's process:
``tracking/tracker.GRAPH_CAPTURES`` (a program counter), the warm-up's and
the window's. The warm-up's first step captures one graph per pyramid level
(the window steps the same shapes), so a run whose window captured nothing
reads the number of levels; more is a capture after the warm-up, such as a
cache that drops graphs it still needs. Nothing where the program has no
such counter."""


def read(run):
    from odometry_torch.tracking import tracker

    return getattr(tracker, "GRAPH_CAPTURES", None)
