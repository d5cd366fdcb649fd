"""Migrate a v0/v1 DeltaT .adder file to v2+ AbsoluteT
(ref: bin/migrate_raw_v0_v1_to_v2.rs).

The port's twin of `tools/migrate_raw_v0_v1_to_v2.py`, over the port's copy
of `utils/stream_migration.py`: the same flags, printed line and bytes.

    python -m adder_tpu_torch.tools.migrate_raw_v0_v1_to_v2 -i v1.adder -o v3.adder
"""

import argparse
import sys

from ..codec.decoder import open_file_decoder
from ..codec.encoder import Encoder, EncoderOptions
from ..codec.header import CodecMetadata, LATEST_CODEC_VERSION
from ..core.types import TimeMode
from ..utils.stream_migration import migrate_v2
from . import stream_errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="migrate to codec v2+ AbsoluteT")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)
    return stream_errors(lambda: _run(args))


def _run(args) -> int:
    dec = open_file_decoder(args.input)
    m = dec.meta
    out_meta = CodecMetadata(
        codec_version=LATEST_CODEC_VERSION,
        time_mode=TimeMode.AbsoluteT,
        plane=m.plane,
        tps=m.tps,
        ref_interval=m.ref_interval,
        delta_t_max=m.delta_t_max,
        source_camera=m.source_camera,
        adu_interval=m.adu_interval,
    )
    enc = Encoder.new_raw(
        out_meta, open(args.output, "wb"), EncoderOptions.default(m.plane)
    )
    enc = migrate_v2(dec, enc)
    enc.close_writer().close()
    print(f"migrated {args.input} (v{m.codec_version}) -> {args.output} (v{LATEST_CODEC_VERSION})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
