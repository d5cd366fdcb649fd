"""DAVIS aedat4 -> ADDER transcoder CLI.

The port's twin of `tools/davis_to_adder.py`: the same flags, defaults,
printed line and `.adder` bytes, transcoding on `--torch-device` (K4 for the
DVS lanes, K3 for the frames and gaps as raster chunks).

ref: adder-codec-rs/src/bin_cv/davis_to_adder.rs (args: edi_args /
transcode_from {framed, raw-davis, raw-dvs} / adder_c_thresh_pos/neg /
delta_t_max_multiplier / write_out). The EDI stage is the in-repo
reconstructor (transcoder/edi.py) instead of davis-edi-rs.

    python -m adder_tpu_torch.tools.davis_to_adder -i in.aedat4 \\
        --output-events-filename out.adder -t raw-davis
"""

import argparse
import sys

from . import add_torch_device, refuse_scalar_oracle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="DAVIS aedat4 -> ADDER")
    ap.add_argument("-i", "--input", required=True, help="input .aedat4 file")
    ap.add_argument("--output-events-filename", required=True)
    ap.add_argument(
        "-t", "--transcode-from", default="framed",
        choices=["framed", "raw-davis", "raw-dvs"],
        help='"framed": deblurred APS frames only; "raw-davis": frames + DVS'
        ' events; "raw-dvs": events only (ref: davis_to_adder.rs mode map)',
    )
    ap.add_argument("--adder-c-thresh-pos", type=int, default=5)
    ap.add_argument("--delta-t-max-multiplier", type=float, default=1.0)
    ap.add_argument("--ref-time", type=int, default=255)
    ap.add_argument("--start-c", type=float, default=0.30344322344322345)
    ap.add_argument("--optimize-c", action="store_true")
    ap.add_argument("--optimize-c-frequency", type=int, default=1)
    ap.add_argument("--crf", type=int, default=None)
    ap.add_argument(
        "--compressed", action="store_true", help="write addec instead of raw"
    )
    ap.add_argument(
        "--entropy", default="cabac", choices=["cabac", "rans"],
        help="compressed entropy stage: reference-compatible addec or the"
        " interleaved-rANS addrn",
    )
    ap.add_argument("--batched", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="batched device integration (the only route of "
                         "the port); --no-batched, the scalar oracle, is "
                         "refused")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="run EDI inline instead of on a worker thread")
    add_torch_device(ap)
    args = ap.parse_args(argv)
    refuse_scalar_oracle(ap, args)

    from ..codec.encoder import EncoderOptions, EncoderType
    from ..core.types import PixelMultiMode, SourceCamera, TimeMode
    from ..transcoder.davis import Davis, TranscoderMode
    from ..transcoder.edi import EdiReconstructor

    mode = {
        "framed": TranscoderMode.Framed,
        "raw-davis": TranscoderMode.RawDavis,
        "raw-dvs": TranscoderMode.RawDvs,
    }[args.transcode_from]

    try:
        recon = EdiReconstructor(
            args.input,
            start_c=args.start_c,
            optimize=args.optimize_c,
            optimize_frequency=args.optimize_c_frequency,
        )
    except (OSError, ValueError) as e:
        print(f"error: cannot open {args.input}: {e}", file=sys.stderr)
        return 1
    if not args.no_prefetch:
        # EDI on a dedicated thread, like the reference (davis.rs:626-632)
        from ..transcoder.edi import ThreadedProvider

        recon = ThreadedProvider(recon)

    # DAVIS346 timebase: 1e6 us/s * ref_time ticks per us (davis.rs tps)
    tps = args.ref_time * 1_000_000
    dtm = int(args.ref_time * 1_000_000 * args.delta_t_max_multiplier)
    src = Davis(
        recon, ref_time=args.ref_time, tps=tps, delta_t_max=max(dtm, args.ref_time),
        mode=mode, device=args.torch_device,
    )
    out = open(args.output_events_filename, "wb")
    src.write_out(
        SourceCamera.DavisU8,
        TimeMode.AbsoluteT,
        PixelMultiMode.Collapse,
        None,
        EncoderType.Compressed if args.compressed else EncoderType.Raw,
        EncoderOptions.default(src.plane),
        out,
        entropy=args.entropy,
    )
    if args.crf is not None:
        src.crf(args.crf)
    else:
        src.video.update_quality_manual(
            args.adder_c_thresh_pos, args.adder_c_thresh_pos,
            max(int(args.delta_t_max_multiplier * 1_000_000 // max(args.ref_time, 1)), 1),
            1, 2.0,
        )

    n_events = 0
    n_packets = 0
    try:
        while True:
            ev = src.consume()
            n_events += len(ev)
            n_packets += 1
    except EOFError:
        pass
    src.end_write_stream()
    out.close()
    print(
        f"transcoded {n_packets} packets -> {n_events} events -> "
        f"{args.output_events_filename}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
