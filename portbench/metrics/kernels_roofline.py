"""kernels_roofline: the least time the chunks submitted in the traced
stretch could take at the card's memory rate, over the device time of the
program's own kernels in it (those named `adder_...`).

What a chunk must move (stats.chunk_bytes): its u8 frames read once, the
live part of its state read before and written after (each pixel's
`length` arena nodes, not the arena's whole depth, and its fixed fields),
8 bytes for each event written out, whatever implements it. No kernel of the path multiplies matrices, so
bytes bound it."""

from portbench import stats


def read(run):
    if run.trace is None or not run.traced_chunks:
        return None
    t = sum(b - a for name, a, b in run.trace.device_ops if "adder_" in name)
    if t <= 0:
        return None
    need = sum(stats.chunk_bytes(c.frames, c.n, c.live_before,
                                 c.live_after, c.events)
               for c in run.traced_chunks)
    return 100.0 * need / stats.HBM_BYTES_PER_S / t
