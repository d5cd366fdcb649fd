"""Recompress an ADDER stream between codecs: raw `adder` <->
reference-compatible `addec` (adaptive range coder) <-> own `addrn`
(interleaved rANS, parallel-friendly decode).

The port's twin of `tools/adder_recompress.py`: the same flags, printed
line and output bytes. The decode side auto-detects the input codec by
magic; event data is preserved exactly at lossless settings
(c_thresh_max=0).

    python -m adder_tpu_torch.tools.adder_recompress -i in.adder -o out.addrn
"""

import argparse
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ADDER stream recompressor")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument(
        "--codec", default="rans", choices=["raw", "cabac", "rans"],
        help="output codec: raw events, addec (reference-compatible "
        "adaptive coder), or addrn (interleaved rANS)",
    )
    ap.add_argument(
        "--crf", type=int, default=0,
        help="compressed quality (0 = lossless t, the default for a "
        "recompressor; >0 enables the lossy t-quantization)",
    )
    ap.add_argument(
        "--adu-interval", type=int, default=0,
        help="ADU span in ref intervals for compressed outputs "
        "(default: keep the input's, or 8 if it has none)",
    )
    args = ap.parse_args(argv)

    from ..codec.decoder import open_file_decoder
    from ..codec.encoder import (
        Encoder,
        EncoderOptions,
        RawOutput,
    )
    from ..codec.header import CodecError

    try:
        dec = open_file_decoder(args.input)
    except (OSError, CodecError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    events = dec.digest_all()
    meta = dec.meta
    if args.codec != "raw":
        from ..core.types import TimeMode

        if meta.time_mode != TimeMode.AbsoluteT:
            # the ADU framing (like the reference's) spans absolute time;
            # DeltaT events would be mis-bucketed and deduplicated
            print(
                "error: compressed codecs require an AbsoluteT stream; "
                "migrate with `python -m "
                "adder_tpu_torch.tools.migrate_raw_v0_v1_to_v2` first",
                file=sys.stderr,
            )
            return 1
        meta.adu_interval = args.adu_interval or meta.adu_interval or 8
        # the adu_interval header field is a v3 extension; older inputs
        # must be re-headered or the decoder would assume span 1
        meta.codec_version = max(meta.codec_version, 3)

    out = open(args.output, "wb")
    opts = EncoderOptions.default(meta.plane)
    if args.codec != "raw":
        from ..codec.rate_controller import Crf

        opts.crf = Crf(args.crf, meta.plane)
    if args.codec == "raw":
        enc = Encoder(RawOutput(meta, out), opts)
    else:
        enc = Encoder.new_compressed(meta, out, opts, entropy=args.codec)
    enc.ingest_event_array(events)
    enc.close_writer()
    out.close()
    in_size = pathlib.Path(args.input).stat().st_size
    out_size = pathlib.Path(args.output).stat().st_size
    print(
        f"{len(events)} events: {in_size} B -> {out_size} B "
        f"({out_size / max(in_size, 1):.2%})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
