"""submit_pct: the program's stage `video.submit_chunk` (utils/tracing.py, host
clock) as a share of the traced stretch."""


def read(run):
    if run.trace is None or "video.submit_chunk" not in run.trace.stages:
        return None
    return 100.0 * run.trace.stages["video.submit_chunk"] / run.trace.window_s
