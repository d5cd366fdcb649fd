"""chunk_p95_ms: the 95th percentile of a chunk's time from its submit call
(before the upload) to the return of its collect call, over every chunk
the traced run's window collected but those submitted or collected while
the profiler ran (whose times hold the profiler's own cost)."""

from portbench import stats


def read(run):
    return stats.p95(run.latencies_ms) if run.latencies_ms else None
