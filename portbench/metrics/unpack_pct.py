"""unpack_pct: the program's stage `video.unpack` (utils/tracing.py, host
clock), the wire events turned into an EventArray before the encode, as a
share of the traced stretch."""


def read(run):
    if run.trace is None or "video.unpack" not in run.trace.stages:
        return None
    return 100.0 * run.trace.stages["video.unpack"] / run.trace.window_s
