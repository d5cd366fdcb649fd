"""upload_pct: the program's stage `video.upload` (utils/tracing.py, host
clock), the frames' host-to-device copy as the host thread sees it, as a
share of the traced stretch."""


def read(run):
    if run.trace is None or "video.upload" not in run.trace.stages:
        return None
    return 100.0 * run.trace.stages["video.upload"] / run.trace.window_s
