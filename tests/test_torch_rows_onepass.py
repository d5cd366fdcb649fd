"""The row walk of K3 and K4 in one pass: its compaction and its C mirrors.

On the card a lane chunk's row kernel walks every pixel's rows once,
staging each cell's events (a cell is one pixel's sub-step) in the cell's
own ROW_SLOTS slots, slot-major; the exclusive scan of the cell counts and the rows
copy (`adder_rows_copy`) then put them in (sub-step, raster pixel, slot)
order. Here, on the CPU: the copy's plain version (`rows_copy_plain`) on
the staging `testing.stage_rows` makes of the plain route's events, held
to those events bit for bit (T = 2, 38 and 128, Normal and Collapse, the
8-byte DVS carrier and the DAVIS one, the exact capacity, half of it and
none, a group with no rows), and the ctypes mirrors of the kernels'
argument blocks held to the C structs. Tolerance: none.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from adder_tpu_torch import testing
from adder_tpu_torch.ops import cuda_build
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import pallas_kernel as PK


@pytest.mark.parametrize("lanes", testing.ROW_COPY_LANES)
def test_rows_copy_plain_gives_the_plain_routes_events(lanes):
    """The one-pass check harness on CPU tensors, one lane count at a
    time: chip_smoke.py runs it on the card with the kernels."""
    assert testing.check_rows_copy_against_plain("cpu", lanes=(lanes,)) == 0.0


def _group(multi: int, lanes: int = 4, seed: int = 3):
    n = 9 * 11
    p = testing._dvs_params(multi)
    plan = testing.lattice_plan(seed, n, lanes, density=0.6)
    c8, pb, _ = testing.carriers(plan, n, "cpu")
    st = FR.ops.init_state(n, "cpu", c_thresh=2, depth=FR.DVS_DEPTH)
    want = FR.dvs_rows8_resident_plain(st, c8, 2 * lanes, p, pb=pb)
    return want, c8, pb, n


@pytest.mark.parametrize("multi", [0, 1])
def test_rows_copy_reads_only_a_cells_events(multi):
    """Two stagings of one group that differ in every slot past each
    cell's count give the same events: the copy reads a cell's first
    counts[c] slots and nothing else."""
    want, c8, pb, n = _group(multi)
    total = int(want.per_interval.sum())
    assert total > 0
    out = []
    for seed in (0, 1):
        stage, counts = testing.stage_rows(want, c8, n, 2, pb, seed)
        offsets = FR.exclusive_scan(counts)
        out.append(FR.rows_copy(stage, counts, offsets, total))
    for a, b, w in zip(out[0], out[1], (want.pixd, want.t)):
        assert torch.equal(a, b) and torch.equal(a, w)


def test_rows_stage_puts_each_cells_events_in_its_slots():
    """`stage_rows` against a direct count: cell c (its rank among the
    carrier's (sub-step, pixel) cells) holds the events of its sub-step and
    pixel, in their order, slot k in entry k C + c (slot-major)."""
    want, c8, pb, n = _group(1, lanes=3)
    stage, counts = testing.stage_rows(want, c8, n, 2, pb)
    keys = testing.row_cell_keys(c8, n, 2, pb).numpy()
    T = want.per_interval.numel()
    sub = np.repeat(np.arange(T), want.per_interval.numpy())
    pix = want.pixd.numpy().view(np.uint32) >> 8
    words = stage.numpy().reshape(FR.ROW_SLOTS, len(keys))
    for c, key in enumerate(keys):
        mine = np.flatnonzero(sub * n + pix == key)
        assert counts[c] == len(mine)
        got = np.ascontiguousarray(words[:len(mine), c]).view(
            np.uint32).reshape(-1, 2)
        np.testing.assert_array_equal(got[:, 0],
                                      want.pixd.numpy()[mine].view(np.uint32))
        np.testing.assert_array_equal(got[:, 1],
                                      want.t.numpy()[mine].view(np.uint32))


def test_rows_copy_runs_plain_on_cpu_tensors():
    want, c8, pb, n = _group(0)
    stage, counts = testing.stage_rows(want, c8, n, 2, pb)
    offsets = FR.exclusive_scan(counts)
    FR.reset_launch_counts()
    got = FR.rows_copy(stage, counts, offsets, 5)
    assert FR.LAUNCHES["adder_rows_copy"] == 0
    assert torch.equal(got[0], want.pixd[:5]) and torch.equal(got[1],
                                                              want.t[:5])


_CTYPE = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
          "float": ctypes.c_float}


def _c_fields(source: str, struct: str):
    """(name, ctypes type, array length) of each field of a C struct of the
    kernels' sources."""
    text = (cuda_build.CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
    out = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        m = re.fullmatch(r"(?:const )?([\w ]+?)(\*?)\s*(\w+)(?:\[(\d+)\])?;",
                         decl)
        assert m, decl
        typ = ctypes.c_void_p if m.group(2) else _CTYPE[m.group(1)]
        out.append((m.group(3), typ, int(m.group(4) or 0)))
    return out


@pytest.mark.parametrize("source, struct, mirror", [
    ("adder_interval.cuh", "AdderRowsArgs", FR._RowsArgs),
    ("dvs_resident.cu", "AdderRowsCopyArgs", FR._RowsCopyArgs),
    ("dvs_resident.cu", "AdderRowsGroupArgs", FR._RowsGroupArgs),
    ("adder_interval.cuh", "AdderChunkArgs", FR._ChunkArgs),
    ("fused_resident.cu", "AdderCopyArgs", FR._CopyArgs),
    ("adder_interval.cuh", "AdderIntervalArgs", PK.IntervalArgs),
])
def test_ctypes_mirrors_follow_the_c_structs(source, struct, mirror):
    """Every argument block the wrappers pass by pointer has the C struct's
    fields, in its order and of its types (a mismatch would shift every
    later field on the card)."""
    want = _c_fields(source, struct)
    got = []
    for name, typ in mirror._fields_:
        length = getattr(typ, "_length_", 0)
        base = typ._type_ if length else typ
        got.append((name, base, length))
    assert got == want


def test_row_walk_has_no_pass_to_choose():
    """One walk a chunk: the row kernels' argument block says only whether
    the events are staged; the rows copy has its own launch count."""
    names = [f for f, _ in FR._RowsArgs._fields_]
    assert "events" in names and "pass_" not in names
    assert "adder_rows_copy" in FR.LAUNCHES
    assert "adder_rows_copy" in cuda_build.SIGNATURES
