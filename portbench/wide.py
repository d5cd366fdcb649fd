"""What a chunk on a wide plane must move, for `wide_roofline`.

The least bytes of one framed chunk with its `.adder` records made on the
card, however the program implements it: its u8 frames read once, the live
part of its state read before and written after (`stats.state_bytes`),
and each event's record, 9 bytes mono or 11 colour, written once. Numbers
in, numbers out; nothing here reads the program.
"""

from __future__ import annotations

from portbench import stats


def record_bytes(channels: int) -> int:
    """An event's raw record: x, y, d, t (9 bytes), and c with its tag in
    colour (11)."""
    return 9 if channels == 1 else 11


def chunk_bytes(frames: int, n: int, live_before: int, live_after: int,
                events: int, channels: int) -> int:
    """The least bytes one chunk of `frames` frames over n pixel-channels
    moves: frames read, live state read and written, records written."""
    return (frames * n + stats.state_bytes(n, live_before)
            + stats.state_bytes(n, live_after)
            + record_bytes(channels) * events)
