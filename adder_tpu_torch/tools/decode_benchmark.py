"""Time full-file event digestion (ref: bin/decode_benchmark.rs), and
optionally the reconstruction stage: --frame adds host framing, --device
frames on the accelerator (framer/device.py, on `--torch-device`) and
reports device-framing throughput.

The port's twin of `tools/decode_benchmark.py`: the same flags and printed
lines (their times are this run's). `--device` keeps its meaning, framing
on the accelerator; `--torch-device` picks the torch device it runs on.

    python -m adder_tpu_torch.tools.decode_benchmark -i in.adder --frame
"""

import argparse
import sys
import time

from ..codec.decoder import open_file_decoder
from . import add_torch_device, stream_errors


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="decode benchmark")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--fps", type=float, default=60.0)
    p.add_argument(
        "--frame", action="store_true",
        help="also reconstruct frames (host framer)",
    )
    p.add_argument(
        "--device", action="store_true",
        help="also reconstruct frames on the accelerator (device framer)",
    )
    add_torch_device(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    def run() -> int:
        benchmark(args)
        return 0

    return stream_errors(run)


def benchmark(args) -> list:
    """Digest (and frame) the file as the tool does, printing its lines;
    returns the frames (none without --frame or --device)."""
    t0 = time.perf_counter()
    dec = open_file_decoder(args.input)
    events = dec.digest_all()
    dt = time.perf_counter() - t0
    print(
        f"digested {len(events)} events in {dt*1000:.1f} ms "
        f"({len(events)/max(dt,1e-9)/1e6:.1f} Mev/s)"
    )
    if not (args.frame or args.device):
        return []

    from ..framer.driver import FramerBuilder

    m = dec.meta
    b = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, args.fps)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
    )
    if args.device:
        from ..framer.device import DeviceFramer

        fr = DeviceFramer(b, device=args.torch_device)
        fr.ingest_event_array(events)  # warm ingest + pop ops off the clock
        fr.drain()
        fr = DeviceFramer(b, device=args.torch_device)
        t0 = time.perf_counter()
        fr.ingest_event_array(events)
        frames = fr.drain()
        dt = time.perf_counter() - t0
        label = "device-framed"
    else:
        fr = b.finish()
        t0 = time.perf_counter()
        fr.ingest_event_array(events)
        frames = []
        while fr.is_frame_0_filled():
            frames.append(fr.pop_next_frame()[0])
        if fr.flush_frame_buffer():
            while fr.is_frame_0_filled():
                frames.append(fr.pop_next_frame()[0])
        dt = time.perf_counter() - t0
        label = "host-framed"
    n_px = len(frames) * m.plane.volume()
    print(
        f"{label} {len(frames)} frames in {dt*1000:.1f} ms "
        f"({n_px/max(dt,1e-9)/1e6:.1f} Mpx/s, "
        f"{len(events)/max(dt,1e-9)/1e6:.1f} Mev/s)"
    )
    return frames


if __name__ == "__main__":
    sys.exit(main())
