"""ShardedVideo: the Video API over pixel bands on several devices.

Port of `adder_tpu/transcoder/sharded.py`. The plane splits into k
contiguous pixel bands, one per device of the mesh (`parallel/sharding.py`;
one card may hold several bands), and every chunk runs the resident chunk
kernels of the single-device engine on each band with the band's own event
buffers: K1 (and its display output) when events are fetched, K2 for the
Empty sink. Collection merges the bands' events into the reference order on
the host, so the `.adder` bytes equal the single-device `Video`'s.

The JAX contract, kept:
- full-depth arenas (`ops.DEPTH`): no shallow-depth rerun (`:74-75`);
- per-band capacity `_cap_mult` x n_local x T (the full K_SLOTS at once
  where n_local x T <= FULL_CAP_VOLUME), a capacity rerun from the
  pre-chunk state when any band's total exceeds it, and the decay
  (`:155-208`);
- at most two chunks in flight; a collected chunk's state becomes the
  Video's only when no newer chunk is in flight (`:214-219`);
- the display frame and features: with features on, `submit_chunk`
  collects every chunk in flight first (`:117-118`), and the display and
  the feature pipeline see the whole plane (`:220-224`, `:269-271`);
- ROI, the void sink, checkpoints (the port `Video`'s layout, `n_state`
  equal to `n`: a checkpoint of the JAX ShardedVideo's padded plane is
  refused, as the port `Video` refuses it).
The JAX pack rerun (`:201-202`) has no counterpart: the port's resident
kernel writes every slot and has no packed lanes. One host read of the
control scalars per chunk serves all bands: their totals, flags and
interval counts are stacked on the first device before one `.cpu()`.

The bands keep the narrow event layout, pix << 8 | d in 32 bits: the
24-bit pixel index (`fused_resident.MAX_PIXELS`) guards the whole plane, not
a band, since the merged events carry global ids. A plane of 2^24
pixel-channels or more (4K colour) is refused; the single-device `Video`'s
resident engine takes it in its wide layout.

`pixels=(p0, p1)` makes the Video one process's part of a multi-process
job (`parallel/multihost.py`): it transcodes the plane's pixels [p0, p1)
only, from frames of that many pixels (`multihost.local_band_frames`), and
its events go to a part (`part`, `write_part`) instead of the encoder;
features, the display frame and checkpoints need the whole plane and are
refused there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import convert
from ..core.types import EventArray, Mode, PlaneSize
from ..ops import fused_resident as FR
from ..ops import integrate as ops
from ..parallel import multihost
from ..parallel import sharding as sh
from ..utils import tracing
from .video import FULL_CAP_VOLUME, RESIDENT, SourceError, Video


class ShardedVideo(Video):
    """Video over a mesh of devices (`sharding.make_mesh`: every visible
    card by default; `["cuda:0"] * k` for k bands on one card)."""

    _trace = "sharded"

    def __init__(self, plane: PlaneSize, pixel_tree_mode: Mode,
                 chunk_frames: int = 8, mesh=None, *,
                 pixels: Optional[tuple] = None):
        n = plane.volume()
        if n >= FR.MAX_PIXELS:
            raise ValueError(
                f"plane of {n} pixel-channels: the bands' events pack the "
                f"global pixel index into 24 bits (at most "
                f"{FR.MAX_PIXELS - 1}); the single-device Video takes it")
        self.mesh = sh.make_mesh(mesh)
        p0, p1 = (0, n) if pixels is None else (int(pixels[0]),
                                                 int(pixels[1]))
        if not 0 <= p0 < p1 <= n:
            raise ValueError(f"pixels [{p0}, {p1}) outside the plane of {n}")
        self.pixels = (p0, p1)
        self.bounds = sh.band_bounds(p1 - p0, len(self.mesh))
        self.n_local = self.bounds[0][1] - self.bounds[0][0]
        self._offsets = [p0 + lo for lo, _ in self.bounds]
        self._part = None if pixels is None else []
        super().__init__(plane, pixel_tree_mode, chunk_frames,
                         device=self.mesh[0])
        self.engine = RESIDENT

    @property
    def n_devices(self) -> int:
        return len(self.mesh)

    def _new_state(self, depth: int) -> list:
        # full-depth arenas whatever the engine's depth: no depth rerun
        return [ops.init_state(hi - lo, dev, depth=ops.DEPTH)
                for (lo, hi), dev in zip(self.bounds, self.mesh)]

    def _whole_plane(self, what: str) -> None:
        if self._part is not None:
            raise SourceError(f"{what} needs the whole plane; this Video "
                              f"holds pixels {self.pixels}")

    # -- the state, band by band --

    def _reset_c_thresh(self, base: int) -> None:
        self.state = [
            st._replace(
                c_thresh=torch.full((hi - lo,), base, dtype=torch.int32,
                                    device=dev),
                c_increase_counter=torch.zeros((hi - lo,), dtype=torch.int32,
                                               device=dev))
            for st, (lo, hi), dev in zip(self.state, self.bounds, self.mesh)]

    def _apply_roi(self) -> None:
        if self.roi is None:
            return
        mask, base = self._roi_mask()
        mask = mask[self.pixels[0]:self.pixels[1]]
        new = []
        for st, (lo, hi) in zip(self.state, self.bounds):
            m = mask[lo:hi]
            if m.any():
                c = st.c_thresh.clone()
                c[torch.from_numpy(m).to(c.device)] = base
                st = st._replace(c_thresh=c)
            new.append(st)
        self.state = new

    def _c_thresh_numpy(self) -> np.ndarray:
        return np.concatenate([st.c_thresh.cpu().numpy() for st in self.state])

    def _put_c_thresh(self, c: np.ndarray) -> None:
        self.state = [
            st._replace(c_thresh=torch.from_numpy(c[lo:hi].copy()).to(dev))
            for st, (lo, hi), dev in zip(self.state, self.bounds, self.mesh)]

    def _state_numpy(self) -> dict:
        self._whole_plane("a checkpoint")
        return convert.state_to_numpy(sh.gather_state(self.state, "cpu"))

    def load_checkpoint(self, path) -> None:
        """Restore a checkpoint of either package's Video or of this one
        (same plane, unpadded), padded to full depth, into the bands."""
        self._whole_plane("a checkpoint")
        super().load_checkpoint(path)
        self.state = sh.shard_state(
            ops.pad_state_depth(self.state, ops.DEPTH), self.mesh)

    # -- transcoding --

    def _run_chunk(self, states, pending: dict) -> list:
        """One chunk of every band from `states`: K1 (with the display when
        run0 is given) at the pending capacity per band, or K2."""
        return sh.resident_chunk_sharded(
            states, pending["frames"], pending["t"], self._params(),
            pending["run0"],
            event_cap_per_dev=None if pending["group"] else pending["cap"])

    def submit_chunk(self, frames: np.ndarray, time_spanned=None) -> dict:
        """Launch a chunk on every band; pair with collect_chunk. The frames
        are (T, H, W, C), or (T, p1 - p0) for a Video of `pixels`."""
        if self._emit_running:
            self._whole_plane("the display frame and features")
        if self.feature_detection:
            self.flush()
        frames = np.asarray(frames)
        T = frames.shape[0]
        flat = frames.reshape(T, -1)
        p0, p1 = self.pixels
        if flat.shape[1] != p1 - p0:
            raise SourceError(f"frame shape {frames.shape[1:]} != "
                              f"{p1 - p0} pixel-channels")
        if time_spanned is None:
            time_spanned = float(self.ref_time)
        bands = multihost.local_shard_frames(flat, self.mesh)
        if self.in_interval_count == 0:
            self.state = [ops.set_initial_d(st, fr[0].to(torch.int32))
                          for st, fr in zip(self.state, bands)]
        self._apply_roi()
        self.in_interval_count += T
        pending = {
            "frames": bands,
            "t": float(np.float32(time_spanned)),
            "group": (bool(self.void_events) and not self.feature_detection
                      and self._part is None),
            "state_before": self.state,
            "T": T,
            "run0": self._run0(),
        }
        if not pending["group"]:
            mult = min(self._cap_mult, ops.K_SLOTS)
            if self.n_local * T <= FULL_CAP_VOLUME:
                mult = ops.K_SLOTS
            pending.update(mult=mult, cap=mult * self.n_local * T)
        with tracing.stage("sharded.submit_chunk", items=T * (p1 - p0)):
            pending["outs"] = self._run_chunk(self.state, pending)
        self.state = [o.state for o in pending["outs"]]
        self._inflight.append(pending)
        while len(self._inflight) > 2:
            self._collect_oldest()
        return pending

    def _band_runnings(self, outs: list) -> list:
        """Each band's (T, n_d) display frames; a chunk submitted with the
        display off counts as all-zero frames, as in `Video._runnings`."""
        return [o.runnings if o.runnings is not None else torch.zeros(
                    (o.per_interval.shape[0], hi - lo), dtype=torch.uint8,
                    device=dev)
                for o, (lo, hi), dev in zip(outs, self.bounds, self.mesh)]

    def _run0(self) -> Optional[list]:
        """Each band's display frame for a new chunk: the last in-flight
        chunk's last frame on its device, or the host frame; None with the
        display off."""
        if not self._emit_running:
            return None
        if self._inflight:
            return [r[-1] for r in
                    self._band_runnings(self._inflight[-1]["outs"])]
        return [r[0] for r in multihost.local_shard_frames(
            self.running_intensities.reshape(1, -1), self.mesh)]

    def _collect_oldest(self) -> EventArray:
        pending = self._inflight.pop(0)
        T = pending["T"]
        while True:
            outs = pending["outs"]
            with tracing.stage("sharded.collect.control_fetch"):
                totals, _, per_int = sh.band_controls(outs, self.device)
            if pending["group"]:
                break
            cap, mult = pending["cap"], pending["mult"]
            top = int(totals.max())
            if top <= cap:
                if top * 8 < cap and self._cap_mult > 1:
                    self._cap_mult //= 2
                break
            if mult >= ops.K_SLOTS:
                break  # K_SLOTS x n_local x T bounds a band's chunk
            # capacity overflow: rerun every band from the untouched
            # pre-chunk state with a larger buffer
            mult *= 2
            self._cap_mult = mult
            pending["mult"] = mult
            pending["cap"] = min(mult, ops.K_SLOTS) * self.n_local * T
            pending["outs"] = self._run_chunk(pending["state_before"],
                                              pending)
        if not self._inflight:
            self.state = [o.state for o in outs]
        runnings = None
        if self._emit_running:
            runnings = torch.cat([r.to(self.device)
                                  for r in self._band_runnings(outs)], dim=1)
        whole = FR.ChunkResult(None, None, None,
                               torch.from_numpy(per_int.sum(axis=0)),
                               None, runnings)
        if pending["group"] or (self.void_events and not self.feature_detection
                                and self._part is None):
            return self._finish_chunk(whole, None)
        with tracing.stage("sharded.collect.event_fetch",
                           items=int(totals.sum())):
            fetched = [(o.pixd[:k].cpu().numpy(), o.t[:k].cpu().numpy())
                       for o, k in zip(outs, totals.tolist())]
        with tracing.stage("sharded.collect.assemble",
                           items=int(totals.sum())):
            pixd, t, per = sh.merge_bands(
                [f[0] for f in fetched], [f[1] for f in fetched], totals,
                per_int, self._offsets)
        if self._part is not None:
            self._part.append((pixd, t, per))
            return EventArray.empty()
        return self._finish_chunk(whole, (pixd, t))

    # -- one process's part of a multi-process job --

    def part(self) -> tuple:
        """This Video's events so far, for `multihost.write_event_part`:
        (pixd uint32 with global pixel ids, t, per-interval counts), in the
        order of its pixels, interval by interval."""
        if self._part is None:
            raise SourceError("part: this Video holds the whole plane")
        self.flush()
        if not self._part:
            return (np.zeros(0, np.uint32), np.zeros(0, np.uint32),
                    np.zeros(0, np.int64))
        return tuple(np.concatenate(x) for x in zip(*self._part))

    def write_part(self, path, process_id: Optional[int] = None) -> None:
        """Write `part()` as a part file (`multihost.write_event_part`),
        with this Video's first pixel as its offset."""
        pixd, t, per = self.part()
        multihost.write_event_part(path, pixd, t, per, self.pixels[0],
                                   process_id)
