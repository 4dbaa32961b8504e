"""LM iterations the batch runs per step: for each step, the sum over pyramid
levels of the most iterations among the lanes (``StepOutput.track_stats``;
the batched loop runs until its slowest lane stops), averaged over the
window's steps (inits have none)."""


def read(run):
    v = run.window.lm_iters
    return sum(v) / len(v) if v else None
