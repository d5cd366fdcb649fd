"""rerun_pct: the program's `video.rerun` host spans (one a relaunched
chunk) over the chunks submitted in the traced stretch, x 100. A span
inside another of the same name counts once: the harness's range around a
stage and the program's own are one relaunch.

A program that records its reruns records its frame upload too
(`video.upload`, on every chunk submitted); without that stage the
program has no rerun span to read, and the metric is left out."""

NAME = "video.rerun"


def outermost(spans) -> int:
    """How many of the (start, end) spans lie inside no other (spans of one
    name on one thread are nested or disjoint)."""
    count, end = 0, float("-inf")
    for a, b in sorted(spans, key=lambda s: (s[0], -s[1])):
        if b > end:
            count, end = count + 1, b
    return count


def read(run):
    if (run.trace is None or not run.traced_chunks
            or "video.upload" not in run.trace.stages):
        return None
    n = outermost((a, b) for name, a, b in run.trace.host_spans if name == NAME)
    return 100.0 * n / len(run.traced_chunks)
