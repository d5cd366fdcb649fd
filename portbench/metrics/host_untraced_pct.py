"""host_untraced_pct: the share of the traced stretch that no host span of
the program covers (every kept span whose name does not start with
`portbench.`, the harness's own): 100 x (1 - their union over the
stretch)."""

from portbench import stats


def read(run):
    if run.trace is None:
        return None
    w = run.trace.window_s
    ivs = [(a, b) for name, a, b in run.trace.host_spans
           if not name.startswith("portbench.")]
    return 100.0 * (1.0 - stats.busy(ivs, 0.0, w) / w)
