"""device_idle_pct: the share of the traced stretch in which no kernel,
copy or memset ran on the card."""

from portbench import stats


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    ivs = [(a, b) for _, a, b in run.trace.device_ops]
    w = run.trace.window_s
    return 100.0 * (w - stats.busy(ivs, 0.0, w)) / w
