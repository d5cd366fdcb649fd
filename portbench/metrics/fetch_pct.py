"""fetch_pct: the program's stage `video.collect.event_fetch` (utils/tracing.py, host
clock) as a share of the traced stretch."""


def read(run):
    if run.trace is None or "video.collect.event_fetch" not in run.trace.stages:
        return None
    return 100.0 * run.trace.stages["video.collect.event_fetch"] / run.trace.window_s
