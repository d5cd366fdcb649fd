"""Decode an .adder file and reconstruct instantaneous frames.

The port's twin of `examples/events_to_instantaneous_frames.py` (ref:
examples/events_to_instantaneous_frames.rs): the Decoder and FrameSequence
pair driven directly, batch by batch.

    python -m adder_tpu_torch.examples.events_to_instantaneous_frames in.adder
"""

import argparse
import sys

from ..codec.decoder import open_file_decoder
from ..framer.driver import FramerBuilder


def reconstruct(path: str):
    """Yield each frame the framer completes, batch by batch."""
    dec = open_file_decoder(path)
    m = dec.meta
    fs = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max,
                         m.tps / m.ref_interval)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    while True:
        batch = dec.digest_batch(1 << 16)
        if len(batch) == 0:
            break
        if fs.ingest_event_array(batch):
            while fs.is_frame_0_filled():
                frame, _ = fs.pop_next_frame()
                yield frame


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=".adder -> instantaneous frames")
    p.add_argument("input")
    args = p.parse_args(argv)
    m = open_file_decoder(args.input).meta
    count = sum(1 for _ in reconstruct(args.input))
    print(f"reconstructed {count} frames of {m.plane.width}x{m.plane.height}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
