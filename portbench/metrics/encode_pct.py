"""encode_pct: the program's stage `video.encode` (utils/tracing.py, host
clock) as a share of the traced stretch."""


def read(run):
    if run.trace is None or "video.encode" not in run.trace.stages:
        return None
    return 100.0 * run.trace.stages["video.encode"] / run.trace.window_s
