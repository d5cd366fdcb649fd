"""CRF rate/quality sweep: transcode -> reconstruct -> PSNR/SSIM/bitrate.

The port's twin of `tools/evaluate_crf_sweep.py`: the same flags, defaults
and JSON-lines rows, transcoding on `--torch-device` (K1 on the card) and
reconstructing with the host framer. `--vmaf` runs an ffmpeg CLI with
libvmaf when one is on PATH, as the JAX tool does.

ref: the reference's evaluation scripts (evaluation/simul_frame.sh sweeps
c-thresholds into VMAF via docker easyVmaf; evaluation/mmsys23 computes
PSNR/SSIM). This is the in-repo equivalent using the framework's own
quality metrics (utils/cv.py PSNR/SSIM, the same formulas the reference
implements in utils/cv.rs:282-429), producing a JSON-lines report:

  {"crf": N, "events": E, "bytes": B, "bitrate_mbps": R,
   "psnr": P, "ssim": S, "frames": F}

    python -m adder_tpu_torch.tools.evaluate_crf_sweep -i in.mp4 --crfs 0,3
"""

import argparse
import io
import json
import pathlib
import sys

import numpy as np

from . import add_torch_device


def _vmaf_score(gt_frames, recon_frames):
    """VMAF via an ffmpeg CLI with libvmaf, when one is on PATH (the
    in-repo analogue of the reference's evaluation/simul_frame.sh ->
    easyVmaf docker flow, which is likewise an external tool). Returns
    the pooled mean VMAF or None (with a stderr note) when unavailable."""
    import json as _json
    import shutil
    import subprocess
    import tempfile

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        print(
            "# vmaf: no ffmpeg CLI on PATH; run the reference's easyVmaf "
            "docker flow (evaluation/simul_frame.sh) on exported frames",
            file=sys.stderr,
        )
        return None
    k = min(len(gt_frames), len(recon_frames))
    if k == 0:
        return None
    h, w = np.asarray(gt_frames[0]).shape[:2]
    with tempfile.TemporaryDirectory() as td:
        ref_p = pathlib.Path(td) / "ref.gray"
        dis_p = pathlib.Path(td) / "dis.gray"
        log_p = pathlib.Path(td) / "vmaf.json"
        with open(ref_p, "wb") as f:
            for fr in gt_frames[:k]:
                f.write(np.asarray(fr, np.uint8).reshape(h, w, -1)[..., 0]
                        .tobytes())
        with open(dis_p, "wb") as f:
            for fr in recon_frames[:k]:
                f.write(np.asarray(fr, np.uint8).reshape(h, w, -1)[..., 0]
                        .tobytes())
        args_v = [
            ffmpeg, "-hide_banner", "-loglevel", "error",
            "-f", "rawvideo", "-pix_fmt", "gray", "-s", f"{w}x{h}",
            "-i", str(dis_p),
            "-f", "rawvideo", "-pix_fmt", "gray", "-s", f"{w}x{h}",
            "-i", str(ref_p),
            "-lavfi", f"libvmaf=log_fmt=json:log_path={log_p}",
            "-f", "null", "-",
        ]
        try:
            subprocess.run(args_v, check=True, capture_output=True,
                           timeout=600)
            with open(log_p) as f:
                data = _json.load(f)
            return round(
                float(data["pooled_metrics"]["vmaf"]["mean"]), 3
            )
        except Exception as e:  # no libvmaf build, old ffmpeg, ...
            print(f"# vmaf: ffmpeg/libvmaf failed: {e}", file=sys.stderr)
            return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="CRF rate/quality sweep")
    ap.add_argument("-i", "--input", required=True, help="input video (mp4)")
    ap.add_argument("--crfs", default="0,3,6,9",
                    help="comma-separated CRF values to sweep")
    ap.add_argument("--frames", type=int, default=48,
                    help="number of source frames to evaluate")
    ap.add_argument("--ref-time", type=int, default=255)
    ap.add_argument("--delta-t-max-mult", type=int, default=24)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--output", default="", help="optional JSONL report path")
    ap.add_argument(
        "--vmaf", action="store_true",
        help="also compute VMAF per CRF via an ffmpeg CLI with libvmaf "
        "(the analogue of the reference's evaluation/simul_frame.sh "
        "easyVmaf docker flow); reports null with a note when no such "
        "ffmpeg is on PATH",
    )
    add_torch_device(ap)
    args = ap.parse_args(argv)

    from ..codec.decoder import Decoder
    from ..codec.encoder import EncoderOptions, EncoderType
    from ..core.types import PixelMultiMode, SourceCamera, TimeMode
    from ..framer.driver import FramerBuilder
    from ..transcoder.framed import Framed
    from ..utils.cv import QualityMetrics, calculate_quality_metrics

    out_f = open(args.output, "w") if args.output else None
    for crf in [int(c) for c in args.crfs.split(",") if c != ""]:
        src = Framed(args.input, False, scale=args.scale,
                     max_frames=args.frames, device=args.torch_device)
        src.auto_time_parameters(
            args.ref_time, args.ref_time * args.delta_t_max_mult,
            TimeMode.AbsoluteT,
        )
        buf = io.BytesIO()
        src.write_out(
            SourceCamera.FramedU8, TimeMode.AbsoluteT,
            PixelMultiMode.Collapse, None, EncoderType.Raw,
            EncoderOptions.default(src.video.plane), buf,
        )
        src.crf(crf)
        n_events = 0
        while True:
            try:
                ev = src.consume_batch()
            except EOFError:
                break
            n_events += len(ev)
        src.video.end_write_stream()
        data = buf.getvalue()

        # reconstruct
        dec = Decoder(io.BytesIO(data))
        m = dec.meta
        fps = m.tps / max(m.ref_interval, 1)
        fs = (
            FramerBuilder(m.plane)
            .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
            .codec_meta(m.codec_version, m.time_mode)
            .source_info(dec.get_source_type(), m.source_camera)
            .finish()
        )
        fs.ingest_event_array(dec.digest_all())
        recon = []
        while fs.is_frame_0_filled():
            vals, _ = fs.pop_next_frame()
            recon.append(np.asarray(vals))
        # drain the tail: repeated back-filling flushes (simulproc shutdown)
        while len(recon) < args.frames and fs.flush_frame_buffer():
            popped_any = False
            while fs.is_frame_0_filled():
                vals, _ = fs.pop_next_frame()
                recon.append(np.asarray(vals))
                popped_any = True
            if not popped_any:
                break

        gt = [np.asarray(f) for f in src.frames]
        k = min(len(recon), len(gt))
        psnrs, ssims = [], []
        for r, g in zip(recon[:k], gt[:k]):
            q = calculate_quality_metrics(
                g.astype(np.float64), r.astype(np.float64),
                QualityMetrics(psnr=0.0, mse=0.0, ssim=0.0),
            )
            psnrs.append(q.psnr)
            ssims.append(q.ssim)
        seconds = k / (m.tps / m.ref_interval)
        row = {
            "crf": crf,
            "events": n_events,
            "bytes": len(data),
            "bitrate_mbps": round(len(data) * 8 / max(seconds, 1e-9) / 1e6, 3),
            "psnr": round(float(np.mean(psnrs)), 3) if psnrs else None,
            "ssim": round(float(np.mean(ssims)), 4) if ssims else None,
            "frames": k,
        }
        if args.vmaf:
            row["vmaf"] = _vmaf_score(gt[:k], recon[:k])
        print(json.dumps(row))
        if out_f:
            out_f.write(json.dumps(row) + "\n")
    if out_f:
        out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
