"""The port's multi-process helpers (`adder_tpu_torch/parallel/multihost.py`)
against adder_tpu's, on the CPU.

- The cases of tests/test_multihost.py: the single-process no-op, pixel
  slices and row bands, a process's exact pixel slice, and simulated
  processes whose parts merge into the one-shot global assembly at (bands,
  processes) = (4, 2) and (8, 4); the port's merge equals adder_tpu's
  global assembly of its own sharded resident chunk.
- Part files written by one package are read and merged by the other.
- One real two-process job under gloo on the CPU (a subprocess each, under
  a timeout of their own): each process transcodes only its band of rows
  through a `ShardedVideo(pixels=...)`, writes its part, and rank 0 merges
  the parts into a Raw `.adder` whose bytes equal a single-process
  `Video`'s.
Tolerance: none; every comparison is exact.
"""

import io
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adder_tpu.ops import integrate as jops
from adder_tpu.parallel import multihost as jmh
from adder_tpu.parallel import sharding as jsh
from adder_tpu_torch import Video, convert, testing
from adder_tpu_torch.codec.encoder import EncoderOptions, EncoderType
from adder_tpu_torch.core import types as T
from adder_tpu_torch.ops import integrate as ops
from adder_tpu_torch.parallel import multihost as mh
from adder_tpu_torch.parallel import sharding as sh

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_init_multihost_single_process_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mh.init_multihost() is False
    assert mh.init_multihost() is False  # safe to call twice
    assert mh.process_count() == 1 and mh.process_index() == 0
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mh.init_multihost() is False


@pytest.mark.parametrize("local_rank", [0, 1])
def test_nccl_rank_takes_its_local_card(monkeypatch, local_rank):
    """An NCCL job (two processes on a host of two cards, torch.cuda and
    init_process_group faked): the process sets its device to
    cuda:LOCAL_RANK before the group starts, and make_mesh() without
    devices gives that card alone; outside the job, every card."""
    import torch.distributed as dist

    cur = {"dev": 0}
    group = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: cur["dev"])
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: cur.update(dev=int(d)))

    def init_process_group(backend, **kw):
        group.update(kw, backend=backend, device_then=cur["dev"])

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(group))
    monkeypatch.setattr(dist, "get_backend", lambda *a: group["backend"])
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    for k, v in (("WORLD_SIZE", "2"), ("RANK", str(local_rank)),
                 ("LOCAL_RANK", str(local_rank)), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    assert sh.make_mesh() == [torch.device("cuda", 0),
                              torch.device("cuda", 1)]
    assert mh.init_multihost("tcp://localhost:1") is True
    assert group["backend"] == "nccl" and group["rank"] == local_rank
    assert group["device_then"] == local_rank == cur["dev"]
    assert sh.make_mesh() == [torch.device("cuda", local_rank)]
    assert sh.make_mesh(["cuda:0"] * 2) == [torch.device("cuda", 0)] * 2


def test_gloo_job_keeps_the_device_and_every_card(monkeypatch):
    """Processes that share a card (more processes than cards) start gloo:
    no device is set, and make_mesh() keeps every visible card."""
    import torch.distributed as dist

    calls, group = [], {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: group.update(backend=backend))
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(group))
    monkeypatch.setattr(dist, "get_backend", lambda *a: group["backend"])
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert mh.init_multihost("tcp://localhost:1") is True
    assert group["backend"] == "gloo" and calls == []
    assert sh.make_mesh() == [torch.device("cuda", 0)]


def test_host_pixel_slice_and_rows_equal_jax():
    assert mh.host_pixel_slice(48, 0, 2) == (0, 24)
    assert mh.host_pixel_slice(48, 1, 2) == (24, 48)
    assert mh.host_rows(6, 8, 1, 0, 2) == (0, 3)
    assert mh.host_rows(6, 8, 1, 1, 2) == (3, 6)
    assert mh.host_pixel_slice(24, 1, 3) == (8, 16)
    assert mh.host_rows(4, 6, 1, 1, 3) == (1, 3)
    with pytest.raises(ValueError):
        mh.host_pixel_slice(25, 0, 2)
    for H, W, C, nproc in ((6, 8, 1, 2), (4, 6, 1, 3), (5, 4, 3, 4),
                           (1080, 1920, 1, 2), (7, 9, 3, 7)):
        for pid in range(nproc):
            assert (mh.host_pixel_slice(H * W * C, pid, nproc)
                    == jmh.host_pixel_slice(H * W * C, pid, nproc))
            assert (mh.host_rows(H, W, C, pid, nproc)
                    == jmh.host_rows(H, W, C, pid, nproc))


@pytest.mark.parametrize("H,W,C,nproc", [(5, 4, 1, 2), (7, 9, 3, 3)])
def test_local_band_frames_cover_exact_slice(H, W, C, nproc):
    T_ = 3
    frames = np.random.default_rng(0).integers(0, 256, (T_, H, W, C)).astype(
        np.uint8)
    flat = frames.reshape(T_, -1)
    got = []
    for pid in range(nproc):
        r0, r1 = mh.host_rows(H, W, C, pid, nproc)
        band = frames[:, r0:r1]  # what this process would decode
        local = mh.local_band_frames(band, H, W, C, pid, nproc)
        np.testing.assert_array_equal(
            local, jmh.local_band_frames(band, H, W, C, pid, nproc))
        p0, p1 = mh.host_pixel_slice(H * W * C, pid, nproc)
        np.testing.assert_array_equal(local, flat[:, p0:p1])
        shards = mh.local_shard_frames(local, ["cpu"] * 2)
        np.testing.assert_array_equal(
            torch.cat(shards, dim=1).numpy(), flat[:, p0:p1])
        got.append(local)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), flat)


def _resident(ndev, n_local, T_, seed):
    """The same chunk through the port's bands and adder_tpu's sharded
    resident kernel (interpret mode): (port results, JAX global stream)."""
    n = n_local * ndev
    frames = np.random.default_rng(seed).integers(0, 256, (T_, n)).astype(
        np.uint8)
    jstate = jops.set_initial_d(jops.init_state(n),
                                jnp.asarray(frames[0].astype(np.int32)))
    mesh = jsh.make_mesh(jax.devices("cpu")[:ndev])
    outs = jsh.make_resident_chunk_sharded(
        jops.TranscodeParams(), 4 * n_local * T_, mesh, pallas_block=n_local,
        interpret=True)(jsh.shard_state(jstate, mesh), jnp.asarray(frames),
                        jnp.float32(255.0), jnp.zeros((n,), jnp.uint8))
    (_, bp, bt, tot, _, pmax, _, counts) = outs
    jax_global = jsh.assemble_resident_sharded(
        np.asarray(bp), np.asarray(bt), np.asarray(tot), np.asarray(counts),
        ndev, pack_max=np.asarray(pmax), n_local_px=n_local)
    states = sh.shard_state(convert.state_from_numpy(jstate, "cpu"),
                            ["cpu"] * ndev)
    fr = [torch.from_numpy(np.ascontiguousarray(frames[:, d * n_local:
                                                       (d + 1) * n_local]))
          for d in range(ndev)]
    res = sh.resident_chunk_sharded(states, fr, 255.0, ops.TranscodeParams(),
                                    event_cap_per_dev=4 * n_local * T_)
    return res, jax_global, outs


@pytest.mark.parametrize("ndev,nhosts", [(4, 2), (8, 4)])
def test_host_parts_merge_matches_global(tmp_path, ndev, nhosts):
    """Simulated processes: each assembles its bands' events with global
    pixel ids, writes a part, and the merged parts equal the one-shot global
    assembly of both packages."""
    n_local, T_ = 128, 3
    res, (want_p, want_t), _ = _resident(ndev, n_local, T_, seed=6)
    pixd, t, totals, per_int = mh.addressable_host_view(res)
    got_p, got_t = sh.assemble_resident_sharded(pixd, t, totals, per_int,
                                                n_local_px=n_local)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_t, want_t)
    assert len(want_p) > 0 and np.count_nonzero(per_int.sum(axis=0)) >= 2
    dper = ndev // nhosts
    parts = []
    for h in range(nhosts):
        ds = range(h * dper, (h + 1) * dper)
        hp, ht, per = mh.assemble_host_events(
            [pixd[d] for d in ds], [t[d] for d in ds], totals[list(ds)],
            per_int[list(ds)], [d * n_local for d in ds])
        path = tmp_path / f"events.part{h}.npz"
        mh.write_event_part(path, hp, ht, per, h * dper * n_local,
                            process_id=h)
        parts.append(mh.read_event_part(path))
    merged_p, merged_t = mh.merge_event_parts(parts[::-1])
    np.testing.assert_array_equal(merged_p, want_p)
    np.testing.assert_array_equal(merged_t, want_t)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_part_files_cross_packages(tmp_path, writer):
    """Parts written by one package, read and merged by the other: the same
    stream as the writer's own merge."""
    ndev, nhosts, n_local, T_ = 4, 2, 128, 3
    res, _, outs = _resident(ndev, n_local, T_, seed=9)
    (_, bp, bt, tot, _, pmax, _, counts) = outs
    bp, bt, tot, counts = (np.asarray(x) for x in (bp, bt, tot, counts))
    pixd, t, totals, per_int = mh.addressable_host_view(res)
    cap = len(bp) // ndev
    dper = ndev // nhosts
    paths = []
    for h in range(nhosts):
        ds = list(range(h * dper, (h + 1) * dper))
        path = tmp_path / f"part{h}.npz"
        if writer == "jax":
            hp, ht, per = jmh.assemble_host_events(
                bp[ds[0] * cap:(ds[-1] + 1) * cap],
                bt[ds[0] * cap:(ds[-1] + 1) * cap], tot[ds], counts[ds], ds,
                n_local, pack_max=np.asarray(pmax))
            jmh.write_event_part(path, hp, ht, per, ds[0] * n_local,
                                 process_id=h)
        else:
            hp, ht, per = mh.assemble_host_events(
                [pixd[d] for d in ds], [t[d] for d in ds], totals[ds],
                per_int[ds], [d * n_local for d in ds])
            mh.write_event_part(path, hp, ht, per, ds[0] * n_local,
                                process_id=h)
        paths.append(path)
    jp, jt = jmh.merge_event_parts([jmh.read_event_part(p) for p in paths])
    pp, pt = mh.merge_event_parts([mh.read_event_part(p) for p in paths])
    assert len(pp) > 0
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pt, jt)
    assert pp.dtype == np.uint32 and pt.dtype == np.int64


def test_merge_event_parts_empty_and_validation(tmp_path):
    p0, t0 = mh.merge_event_parts([])
    assert len(p0) == 0 and len(t0) == 0
    a = {"pixel_offset": 0, "per_interval": np.array([0, 0]),
         "pixd": np.empty(0, np.uint32), "t": np.empty(0, np.int64)}
    b = {"pixel_offset": 8, "per_interval": np.array([0]),
         "pixd": np.empty(0, np.uint32), "t": np.empty(0, np.int64)}
    with pytest.raises(ValueError):
        mh.merge_event_parts([a, b])
    np.savez(tmp_path / "bad.npz", magic=np.frombuffer(b"nope", np.uint8))
    with pytest.raises(ValueError):
        mh.read_event_part(tmp_path / "bad.npz")


# --- a real two-process job ---------------------------------------------------

H, W, C, FRAMES, CHUNK = 25, 40, 1, 12, 4  # 500 px a process: 12.5 rows

_JOB = r"""
import io, sys
import numpy as np
import adder_tpu_torch as at
from adder_tpu_torch import testing
from adder_tpu_torch.parallel import multihost as mh

port, rank, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
H, W, C, FRAMES, CHUNK = (int(x) for x in sys.argv[4:9])
assert mh.init_multihost(f"tcp://localhost:{port}", 2, rank)
import torch.distributed as dist
assert dist.get_backend() == "gloo"
plane = at.PlaneSize(W, H, C)
r0, r1 = mh.host_rows(H, W, C)
band = testing.moving_shapes(3, FRAMES, H, W, C)[:, r0:r1]  # its rows only
local = mh.local_band_frames(band, H, W, C)
v = at.ShardedVideo(plane, at.Mode.FramePerfect, mesh=["cpu"] * 2,
                    pixels=mh.host_pixel_slice(plane.volume()))
v.time_parameters(255 * 30, 255, 255 * 24, at.TimeMode.DeltaT)
v.update_quality_manual(0, 0, 24, 1, 0)
# every rank attaches a sink with the same options (they carry the CRF
# parameters of the chunks); rank 0's is the file, the other's Empty
f = open(f"{out_dir}/job.adder", "wb") if rank == 0 else None
v.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
            at.PixelMultiMode.Collapse, None,
            at.EncoderType.Raw if f else at.EncoderType.Empty,
            at.EncoderOptions.default(plane), f)
for i in range(0, FRAMES, CHUNK):
    v.submit_chunk(local[i:i + CHUNK])
n = mh.gather_parts(v, out_dir)
if f:
    v.end_write_stream()
    f.close()
    print("MERGED", n)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_job_equals_single_process(tmp_path):
    port = _free_port()
    args = [str(x) for x in (H, W, C, FRAMES, CHUNK)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JOB, str(port), str(rank), str(tmp_path),
         *args], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "MERGED" in outs[0][0]

    frames = testing.moving_shapes(3, FRAMES, H, W, C)
    v = Video(T.PlaneSize(W, H, C), T.Mode.FramePerfect, device="cpu")
    v.time_parameters(255 * 30, 255, 255 * 24, T.TimeMode.DeltaT)
    v.update_quality_manual(0, 0, 24, 1, 0)
    buf = io.BytesIO()
    v.write_out(T.SourceCamera.FramedU8, T.TimeMode.DeltaT,
                T.PixelMultiMode.Collapse, None, EncoderType.Raw,
                EncoderOptions.default(v.plane), buf)
    for i in range(0, FRAMES, CHUNK):
        v.submit_chunk(frames[i:i + CHUNK])
    v.end_write_stream()
    got = (tmp_path / "job.adder").read_bytes()
    assert len(got) > 1000 and got == buf.getvalue()
    assert int(outs[0][0].split()[-1]) > 0
