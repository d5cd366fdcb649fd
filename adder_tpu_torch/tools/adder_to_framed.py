"""Reconstruct frames from an .adder file (ref: bin/adder_to_framed.rs).

The port's twin of `tools/adder_to_framed.py`: the host framer over the
port's decoder, the same flags, printed line and frame bytes.

    python -m adder_tpu_torch.tools.adder_to_framed -i in.adder -o out.gray
"""

import argparse
import sys

from ..codec.decoder import open_file_decoder
from ..framer.driver import FramerBuilder
from . import stream_errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ADDER -> raw frames")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True, help="raw gray/bgr24 output")
    p.add_argument("--fps", type=float, default=0.0, help="0 = tps/ref_interval")
    args = p.parse_args(argv)
    return stream_errors(lambda: _run(args))


def _run(args) -> int:
    dec = open_file_decoder(args.input)
    m = dec.meta
    fps = args.fps or (m.tps / m.ref_interval)
    fs = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    n = 0
    with open(args.output, "wb") as out:
        fs.ingest_event_array(dec.digest_all())
        n += fs.write_multi_frame_bytes(out)
        if fs.flush_frame_buffer():
            n += fs.write_multi_frame_bytes(out)
    print(f"wrote {n} frames ({m.plane.width}x{m.plane.height}x{m.plane.channels})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
