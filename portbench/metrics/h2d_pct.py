"""h2d_pct: the card's host-to-device copy time (torch.profiler's memcpy
operations) as a share of the traced stretch."""


def read(run):
    if run.trace is None:
        return None
    s = sum(b - a for name, a, b in run.trace.device_ops
            if "Memcpy HtoD" in name)
    return 100.0 * s / run.trace.window_s if s > 0 else None
