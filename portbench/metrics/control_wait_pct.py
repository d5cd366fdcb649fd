"""control_wait_pct: the program's stage `video.collect.control_fetch` (utils/tracing.py, host
clock) as a share of the traced stretch."""


def read(run):
    if run.trace is None or "video.collect.control_fetch" not in run.trace.stages:
        return None
    return 100.0 * run.trace.stages["video.collect.control_fetch"] / run.trace.window_s
