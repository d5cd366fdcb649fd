"""The Raw sink's writer: the `.adder` bytes counted in memory, never stored.

A file-like object the encoder writes into. It counts every byte and
drops it, so a run writes nothing to disk and spends on the bytes no
more than a write into the page cache would. Only while `keep` is set
does it hold on to what it is given (the chunks the check compares), and
the first write, the header, is always kept.
"""

from __future__ import annotations


class MemoryWriter:
    def __init__(self):
        self.nbytes = 0
        self.header = None
        self.keep = False
        self.kept: list = []

    def write(self, data) -> int:
        n = memoryview(data).nbytes
        if self.header is None:
            self.header = bytes(memoryview(data).cast("B"))
        elif self.keep:
            self.kept.append(data)
        self.nbytes += n
        return n

    def take(self) -> bytes:
        """What was kept since the last call, as one bytes object."""
        out = b"".join(bytes(memoryview(x).cast("B")) for x in self.kept)
        self.kept = []
        return out
