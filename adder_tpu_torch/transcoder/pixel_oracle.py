# Copy of adder_tpu/transcoder/pixel_oracle.py (the port's scalar oracle, behind batched=False).
"""Scalar oracle for the ADDER per-pixel integration state machine.

This is the *semantic specification* of the transcoder: an exact, f32-accurate
re-implementation of the reference's pixel arena
(ref: adder-codec-rs/src/transcoder/event_pixel_tree.rs) and of the per-pixel
driver `integrate_for_px` (ref: transcoder/source/video.rs:1317-1380).

It is NOT the production path — the dense JAX/Pallas kernel in
`adder_tpu.ops.integrate` is — but every kernel change is validated
bit-for-bit against this oracle, and the reference's own unit tests are
transliterated against it in tests/test_pixel_oracle.py.

All stored real values are numpy float32 and every arithmetic step rounds to
f32, mirroring the reference's `Intensity32`/f32 math exactly.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.types import (
    D_EMPTY,
    D_MAX,
    D_SHIFT_F32,
    D_ZERO_INTEGRATION,
    Coord,
    Event,
    Mode,
    PixelMultiMode,
    TimeMode,
)

F32 = np.float32
F32_EPSILON = np.float32(1.1920929e-07)  # f32::EPSILON
_U32_MAX = 0xFFFFFFFF


def as_u32(x) -> int:
    """Rust `f32 as u32`: truncate toward zero, saturating, NaN -> 0."""
    xf = float(x)
    if xf != xf:  # NaN
        return 0
    if xf <= 0.0:
        return 0
    if xf >= _U32_MAX:
        return _U32_MAX
    return int(xf)


def get_d_from_intensity(intensity) -> int:
    """floor(log2(trunc(intensity))), clamped to D_MAX; 128 below 1.0.

    ref: event_pixel_tree.rs:482-499
    """
    if intensity < 1.0:
        return D_ZERO_INTEGRATION
    return min(int(intensity).bit_length() - 1, D_MAX)


class PixelNode:
    """One node of the pixel arena (ref: event_pixel_tree.rs:41-49)."""

    __slots__ = ("alt", "d", "integration", "delta_t", "best_d", "best_dt")

    def __init__(self, start_intensity):
        self.alt = False
        self.d = get_d_from_intensity(start_intensity)
        self.integration = F32(0.0)
        self.delta_t = F32(0.0)
        self.best_d: Optional[int] = None  # None => no best event
        self.best_dt = F32(0.0)


class PixelArena:
    """Per-pixel asynchronous integration state machine.

    ref: event_pixel_tree.rs:53-499. The arena is a flat list encoding a
    degenerate binary tree: node i's "alt" child is node i+1.
    """

    MAX_DEPTH = 8  # reference SmallVec inline capacity is 6; can heap-grow

    def __init__(self, start_intensity, coord: Coord):
        self.coord = coord
        self.time_mode = TimeMode.AbsoluteT
        self.last_fired_t = F32(0.0)
        self.running_t = F32(0.0)
        self.length = 1
        self.base_val = 0
        self.need_to_pop_top = False
        self.arena: List[PixelNode] = [PixelNode(F32(start_intensity))]
        self.c_thresh = 10
        self.c_increase_counter = 1
        self.dtm_reached = False
        self.popped_dtm = False

    def set_time_mode(self, time_mode: Optional[TimeMode]):
        if time_mode is not None:
            self.time_mode = time_mode

    # -- event emission helpers --

    def _get_zero_event(self, idx: int, next_intensity) -> tuple:
        """Forced d=254... no: d=D_ZERO_INTEGRATION(128) filler event when the
        integration is 0 (ref: event_pixel_tree.rs:96-111)."""
        node = self.arena[idx]
        ev = (D_ZERO_INTEGRATION, node.delta_t)
        node.delta_t = F32(0.0)
        if next_intensity is not None:
            node.d = get_d_from_intensity(next_intensity)
        return ev

    def _delta_t_to_absolute_t(self, ev: tuple, mode: Mode, ref_time: int) -> Event:
        """ref: event_pixel_tree.rs:113-137"""
        d, dt = ev
        if self.time_mode == TimeMode.AbsoluteT:
            dt = F32(dt + self.last_fired_t)
            self.last_fired_t = dt
            if mode == Mode.FramePerfect:
                lf = as_u32(self.last_fired_t)
                if lf % ref_time == 0:
                    self.last_fired_t = F32(lf)
                else:
                    self.last_fired_t = F32((lf // ref_time + 1) * ref_time)
        return Event(self.coord.x, self.coord.y, self.coord.c, d, as_u32(dt))

    # -- popping --

    def pop_top_event(self, next_intensity, mode: Mode, ref_time: int) -> Event:
        """ref: event_pixel_tree.rs:139-147"""
        ev = self._pop_top_event_recursive(F32(next_intensity))
        self.popped_dtm = True
        return self._delta_t_to_absolute_t(ev, mode, ref_time)

    def _pop_top_event_recursive(self, next_intensity) -> tuple:
        """ref: event_pixel_tree.rs:151-210"""
        self.need_to_pop_top = False
        root = self.arena[0]
        if root.best_d is None:
            if root.integration == 0.0 and root.delta_t > 0.0:
                return self._get_zero_event(0, next_intensity)
            # Frame-perfect near-dtm case: synthesize the best event in place
            if root.integration < 1.0:
                d = D_ZERO_INTEGRATION
            else:
                d = int(root.integration).bit_length() - 1
            root.best_d = d
            root.best_dt = root.delta_t
            if len(self.arena) > 1:
                self.arena[1] = PixelNode(next_intensity)
                self.length = 2
            else:
                self.arena.append(PixelNode(next_intensity))
                self.length += 1
            return self._pop_top_event_recursive(next_intensity)
        ev = (root.best_d, root.best_dt)
        for i in range(self.length - 1):
            self.arena[i] = self.arena[i + 1]
        self.length -= 1
        return ev

    def pop_best_events(
        self,
        buffer: List[Event],
        mode: Mode,
        multi_mode: PixelMultiMode,
        ref_time: int,
        intensity,
    ) -> None:
        """Drain all nodes' best events (ref: event_pixel_tree.rs:213-287)."""
        local: List[Event] = []
        for node_idx in range(self.length):
            node = self.arena[node_idx]
            if node.best_d is None:
                if node.delta_t > 0.0 and node.integration == 0.0:
                    ev = self._get_zero_event(node_idx, None)
                    local.append(self._delta_t_to_absolute_t(ev, mode, ref_time))
            else:
                ev = (node.best_d, node.best_dt)
                local.append(self._delta_t_to_absolute_t(ev, mode, ref_time))

        if self.popped_dtm and multi_mode == PixelMultiMode.Collapse and local:
            # Keep only the first event plus a D_EMPTY filler at running_t
            buffer.append(local[0])
            self.last_fired_t = self.running_t
            buffer.append(
                Event(
                    self.coord.x,
                    self.coord.y,
                    self.coord.c,
                    D_EMPTY,
                    as_u32(self.running_t),
                )
            )
            self.arena[0] = PixelNode(F32(intensity))
        else:
            buffer.extend(local)
            # Move the (best-event-free) tail node to the front
            self.arena[0], self.arena[self.length - 1] = (
                self.arena[self.length - 1],
                self.arena[0],
            )
        self.length = 1
        self.need_to_pop_top = False
        self.dtm_reached = False
        self.popped_dtm = False

    def set_d_for_continuous(self, next_intensity, ref_time: int) -> Optional[Event]:
        """Re-aim D at the new intensity, possibly emitting a D_EMPTY filler.

        ref: event_pixel_tree.rs:289-312
        """
        assert self.arena[0].best_d is None
        next_d = get_d_from_intensity(next_intensity)
        ret = None
        if next_d < self.arena[0].d and self.arena[0].delta_t > 0.0:
            ev = (D_EMPTY, self.arena[0].delta_t)
            ret = self._delta_t_to_absolute_t(ev, Mode.Continuous, ref_time)
            self.arena[0].delta_t = F32(0.0)
            self.arena[0].integration = F32(0.0)
        self.arena[0].d = next_d
        return ret

    # -- integration --

    def integrate(
        self,
        intensity,
        time,
        mode: Mode,
        dtm: int,
        ref_time: int,
        c_thresh_max: int,
        c_increase_velocity: int,
        multi_mode: PixelMultiMode,
    ) -> None:
        """Integrate one intensity over `time` ticks (ref: event_pixel_tree.rs:317-413)."""
        intensity = F32(intensity)
        time = F32(time)
        start_time = time
        tail = self.arena[self.length - 1]
        if tail.delta_t == 0.0 and tail.integration == 0.0:
            tail.d = get_d_from_intensity(intensity)
        self.running_t = F32(self.running_t + time)

        idx = 0
        count = 0
        while True:
            count += 1
            res = self._integrate_main(idx, intensity, time, mode)
            if res is not None:
                if len(self.arena) > idx + 1:
                    self.arena[idx + 1] = PixelNode(intensity)
                else:
                    self.arena.append(PixelNode(intensity))
                self.length = idx + 2
                self.arena[idx].alt = True
                intensity, time = res
                filled = True
            else:
                filled = False

            idx += 1

            if self.popped_dtm and multi_mode == PixelMultiMode.Collapse and idx > 0:
                break

            if filled:
                if mode == Mode.FramePerfect:
                    break
                # Continuous: keep integrating the remainder down the tree
                if time > F32(ref_time):
                    self.arena[idx].d = get_d_from_intensity(intensity)
                if intensity == 0.0:
                    break

            if idx >= self.length:
                break
            if count > 30:
                raise RuntimeError(f"Infinite loop detected, idx {idx}")

        assert self.length > 0

        self.dtm_reached = bool(self.arena[0].delta_t >= F32(dtm))
        self.need_to_pop_top = self.arena[0].d == D_MAX or (
            self.dtm_reached and not self.popped_dtm
        )

        # Adaptive contrast threshold (ref: event_pixel_tree.rs:402-412)
        if self.c_thresh < c_thresh_max:
            if self.c_increase_counter >= (c_increase_velocity - 1) % 256:
                self.c_thresh = min(self.c_thresh + 1, 255)
                self.c_increase_counter = 0
            else:
                inc = (as_u32(start_time) // ref_time) % 256
                self.c_increase_counter = min(self.c_increase_counter + inc, 255)

    def _integrate_main(self, index: int, intensity, time, mode: Mode):
        """Integrate one node; returns (remaining_intensity, remaining_time)
        when the node fires, else None (ref: event_pixel_tree.rs:418-479)."""
        node = self.arena[index]
        d_usize = node.d
        if F32(node.integration + intensity) >= D_SHIFT_F32[d_usize]:
            new_d = get_d_from_intensity(F32(node.integration + intensity))
            prop = F32(F32(D_SHIFT_F32[new_d] - node.integration) / intensity) if intensity != 0 else F32(np.inf)
            if (
                new_d == D_ZERO_INTEGRATION
                or d_usize == D_ZERO_INTEGRATION
                or intensity < F32_EPSILON
            ):
                prop = F32(1.0)
            node.d = new_d
            d_usize = new_d

            node.best_d = node.d
            node.best_dt = F32(node.delta_t + F32(time * prop))

            # Bump D to the next power of two for continued integration
            if node.d < D_MAX:
                node.integration = F32(node.integration + intensity)
                node.delta_t = F32(node.delta_t + time)
                integ_int = as_u128_trunc(node.integration)
                while True:
                    d_usize += 1
                    if d_shift_u128(d_usize) > integ_int:
                        break
                node.d = d_usize

            rem_i = F32(intensity - F32(intensity * prop))
            if rem_i >= 0.0:
                if mode == Mode.FramePerfect:
                    return (F32(0.0), F32(0.0))
                return (rem_i, F32(time - F32(time * prop)))
            return (F32(0.0), F32(0.0))
        node.integration = F32(node.integration + intensity)
        node.delta_t = F32(node.delta_t + time)
        return None


def d_shift_u128(d: int) -> int:
    """Integer D_SHIFT with the reference's table semantics (index 128 -> 0)."""
    return 0 if d >= 128 else 1 << d


def as_u128_trunc(x) -> int:
    xf = float(x)
    if xf <= 0.0 or xf != xf:
        return 0
    return int(xf)


# --- the per-pixel transcode driver (ref: video.rs:1317-1380) ---------------


def integrate_for_px(
    px: PixelArena,
    frame_val: int,
    intensity,
    time_spanned,
    buffer: List[Event],
    pixel_tree_mode: Mode,
    pixel_multi_mode: PixelMultiMode,
    delta_t_max: int,
    ref_time: int,
    c_thresh_max: int,
    c_increase_velocity: int,
) -> bool:
    """One pixel, one input interval. Returns True if events were emitted."""
    grew = False
    if px.need_to_pop_top:
        buffer.append(px.pop_top_event(intensity, pixel_tree_mode, ref_time))
        grew = True

    base_val = px.base_val
    c = px.c_thresh
    if frame_val < max(base_val - c, 0) or frame_val > min(base_val + c, 255):
        px.pop_best_events(buffer, pixel_tree_mode, pixel_multi_mode, ref_time, intensity)
        grew = True
        px.base_val = frame_val
        if pixel_tree_mode == Mode.Continuous:
            ev = px.set_d_for_continuous(intensity, ref_time)
            if ev is not None:
                buffer.append(ev)

    px.integrate(
        intensity,
        time_spanned,
        pixel_tree_mode,
        delta_t_max,
        ref_time,
        c_thresh_max,
        c_increase_velocity,
        pixel_multi_mode,
    )

    if px.need_to_pop_top:
        buffer.append(px.pop_top_event(intensity, pixel_tree_mode, ref_time))
        grew = True
    return grew
