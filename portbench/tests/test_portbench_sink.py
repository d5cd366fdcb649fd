"""The Raw sink's writer counts what it is given and keeps only what the
check asks for."""

import numpy as np

from portbench.sink import MemoryWriter


def test_counts_the_bytes_a_file_would_hold(tmp_path):
    rng = np.random.default_rng(3)
    parts = [b"adder\x03", rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(),
             memoryview(rng.integers(0, 256, 999, dtype=np.uint8).tobytes()),
             np.arange(7, dtype=np.uint16)]
    w = MemoryWriter()
    path = tmp_path / "out.adder"
    with open(path, "wb") as f:
        for p in parts:
            assert w.write(p) == f.write(p)
    data = path.read_bytes()
    assert w.nbytes == len(data)
    assert w.header == parts[0]
    assert w.take() == b""


def test_keeps_only_while_asked_the_bytes_a_file_holds(tmp_path):
    w = MemoryWriter()
    path = tmp_path / "out.adder"
    with open(path, "wb") as f:
        for keep, p in [(False, b"head"), (False, b"a"), (True, b"bc"),
                        (True, memoryview(b"d")),
                        (True, np.array([0x0201], dtype=np.uint16)),
                        (False, b"e")]:
            w.keep = keep
            w.write(p)
            f.write(p)
    data = path.read_bytes()
    assert w.take() == data[5:10] == b"bcd\x01\x02"
    assert w.take() == b""
    assert w.nbytes == len(data)
