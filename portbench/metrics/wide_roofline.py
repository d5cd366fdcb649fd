"""wide_roofline: on a wide plane (2^24 pixel-channels and more, whose
events take the program's wide layout), the least time the chunks
submitted in the traced stretch could take at the card's memory rate, over
the device time of the program's own kernels in it (those named
`adder_...`).

What a chunk must move (wide.chunk_bytes): its u8 frames read once, the
live part of its state read before and written after, and each event's
`.adder` record (11 bytes in colour) written once, whatever implements
it. Read only where the stretch holds the program's counter
`video.wide_events` (the wide layout ran); else nothing."""

from portbench import stats, wide

COUNTER = "video.wide_events"


def read(run):
    if (run.trace is None or not run.traced_chunks
            or COUNTER not in run.trace.stages):
        return None
    t = sum(b - a for name, a, b in run.trace.device_ops if "adder_" in name)
    if t <= 0:
        return None
    need = sum(wide.chunk_bytes(c.frames, c.n, c.live_before, c.live_after,
                                c.events, c.n // run.pixels_per_frame)
               for c in run.traced_chunks)
    return 100.0 * need / stats.HBM_BYTES_PER_S / t
