"""The port's `adder_viz` against the JAX tool's, on the CPU, and the tools
package as a whole.

- Every script of `tools/` has a port twin `adder_tpu_torch.tools.<name>`
  with `main(argv) -> int` whose `--help` exits 0; the examples too.
- `Session` driven synchronously on the caller's thread (its worker's
  `_run`): the play tab on a seeded `.adder` file and the transcode tab on
  the seeded FFV1 clip of tests/test_torch_pipelines.py give the JAX
  Session's last PNG frame and statistics (but for the measured rates),
  and the transcode tab's `.adder` output equals the JAX one's.
- The transcode tab runs under its device's context on the worker thread,
  and `stop()` joins the worker before returning.
- One HTTP smoke on 127.0.0.1:0: the page, a play start, a PNG frame, a
  live view switch, a stop.
"""

import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from test_torch_file_sources import write_clip
from test_torch_tools_codec import adder_file  # noqa: F401
from torch_tools_common import REPO

TOOLS = sorted(p.stem for p in (REPO / "tools").glob("*.py"))
EXAMPLES = ["frames_to_adder", "events_to_instantaneous_frames"]


def test_every_jax_tool_has_a_port_twin():
    port = sorted(p.stem for p in (REPO / "adder_tpu_torch" / "tools")
                  .glob("*.py") if p.stem != "__init__")
    assert len(TOOLS) == 14 and port == TOOLS


@pytest.mark.parametrize("name", [f"tools.{n}" for n in TOOLS]
                         + [f"examples.{n}" for n in EXAMPLES])
def test_main_and_help(name, capsys):
    mod = importlib.import_module(f"adder_tpu_torch.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    assert capsys.readouterr().out.startswith("usage: ")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("clip") / "clip.avi", "FFV1",
                      n_frames=20, seed=3)


def _drive(session, cfg, frames):
    """Run the session's worker body on this thread, stopping after
    `frames` frames; returns the last PNG and the statistics."""
    encode = session._encode
    count = [0]

    def counted(frame):
        encode(frame)
        count[0] += 1
        if count[0] >= frames:
            session.stop_flag.set()

    session._encode = counted
    session.kind = cfg["tab"]  # as start() sets it
    session._run(cfg)
    assert count[0] == frames, session.status
    return session.frame_png, dict(session.stats)


def _sessions():
    from adder_tpu_torch.tools import adder_viz as PORT

    jax = importlib.import_module("runpy").run_path(
        str(REPO / "tools" / "adder_viz.py"))
    return jax["Session"](), PORT.Session(device="cpu")


def _cfg(tab, path, **kw):
    return {"tab": tab, "path": str(path), "crf": 3, "view_mode": 0,
            "features": "off", "roi": "", "dtref": 255, "dtmult": 4,
            "outpath": "", **kw}


@pytest.mark.parametrize("view", [0, 2])
def test_session_play_equals_jax(adder_file, view):  # noqa: F811
    jax, port = _sessions()
    cfg = _cfg("play", adder_file, view_mode=view)
    want_png, want = _drive(jax, cfg, 5)
    got_png, got = _drive(port, cfg, 5)
    assert got_png[:8] == b"\x89PNG\r\n\x1a\n" and got_png == want_png
    for k in ("frames_emitted", "events_total"):
        assert got[k] == want[k] > 0, k


@pytest.mark.parametrize("features", ["off", "instant"])
def test_session_transcode_equals_jax(clip, tmp_path, features):
    jax, port = _sessions()
    out = {}
    for name, s in (("jax", jax), ("port", port)):
        cfg = _cfg("transcode", clip, features=features, quality=True,
                   outpath=str(tmp_path / f"{name}.adder"))
        out[name] = _drive(s, cfg, 2)
    (got_png, got), (want_png, want) = out["port"], out["jax"]
    assert got_png == want_png and len(got_png) > 100
    assert got.keys() == want.keys() and "psnr" in got
    for k in got.keys() - {"transcoded_fps"}:
        assert got[k] == want[k], k
    assert ((tmp_path / "port.adder").read_bytes()
            == (tmp_path / "jax.adder").read_bytes())


def test_session_worker_runs_under_its_device_and_stop_joins(clip,
                                                            monkeypatch):
    from adder_tpu_torch.parallel import sharding
    from adder_tpu_torch.tools import adder_viz as PORT

    entered = []
    context = sharding.device_context

    def recording(dev):
        entered.append((str(dev), threading.current_thread().name))
        return context(dev)

    monkeypatch.setattr(sharding, "device_context", recording)
    s = PORT.Session(device="cpu")
    s.start(_cfg("transcode", clip))
    worker = s.thread
    deadline = time.monotonic() + 60
    while s.frame_png is None and time.monotonic() < deadline:
        time.sleep(0.05)
    s.stop()
    assert s.thread is None and not worker.is_alive()
    assert entered == [("cpu", worker.name)]
    assert s.frame_png is not None and s.status == "idle"


def test_http_play_smoke(adder_file):  # noqa: F811
    from adder_tpu_torch.tools import adder_viz as PORT

    srv = PORT.make_server("127.0.0.1", 0)
    port = srv.server_address[1]
    PORT.SESSION.device = "cpu"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"

    def post(path, cfg):
        urllib.request.urlopen(urllib.request.Request(
            base + path, json.dumps(cfg).encode(), method="POST"))

    try:
        assert b"ADDER viz" in urllib.request.urlopen(base + "/").read()
        cfg = _cfg("play", adder_file)
        post("/api/start", cfg)
        frame, stats = None, {}
        for _ in range(200):
            time.sleep(0.05)
            stats = json.loads(urllib.request.urlopen(
                base + "/api/stats").read())["stats"]
            try:
                frame = urllib.request.urlopen(base + "/api/frame").read()
            except urllib.error.HTTPError:
                continue
            if stats.get("frames_emitted", 0) > 0:
                break
        assert frame[:8] == b"\x89PNG\r\n\x1a\n"
        assert stats.get("frames_emitted", 0) > 0
        post("/api/adaptive", {**cfg, "view_mode": 2})
        post("/api/stop", {})
        assert PORT.SESSION.thread is None
    finally:
        PORT.SESSION.stop()
        srv.shutdown()
        srv.server_close()
