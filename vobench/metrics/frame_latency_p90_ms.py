"""The 90th percentile (nearest rank) over every step of the window, inits
included, of the time from the step's dispatch to its poses on the host
(host clock). Every lane's frame of a step waits that long."""

from vobench.stats import percentile


def read(run):
    return 1e3 * percentile([s["t1"] - s["t0"] for s in run.steps], 90)
