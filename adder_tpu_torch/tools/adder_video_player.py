"""Play back an .adder file: reconstruct frames, optionally write an mp4
(ref: bin_cv/adder_video_player.rs; headless, a display needs a GUI).

The port's twin of `tools/adder_video_player.py`: the port's player (host
framer), the same flags, printed lines and frames.

    python -m adder_tpu_torch.tools.adder_video_player -i in.adder -o out.mp4
"""

import argparse
import sys

import numpy as np

from ..framer.scale_intensity import FramedViewMode
from ..models.player import AdderPlayer
from ..utils.viz import write_frames_to_video
from . import stream_errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ADDER stream player")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output-video", default="", help="mp4 output path")
    p.add_argument(
        "--view-mode", choices=["intensity", "d", "delta_t", "sae"],
        default="intensity",
    )
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--realtime", action="store_true", help="pace to stream rate")
    args = p.parse_args(argv)
    return stream_errors(lambda: _run(args))


def _run(args) -> int:
    vm = {
        "intensity": FramedViewMode.Intensity,
        "d": FramedViewMode.D,
        "delta_t": FramedViewMode.DeltaT,
        "sae": FramedViewMode.SAE,
    }[args.view_mode]
    player = AdderPlayer(args.input, view_mode=vm)
    frames = []
    for frame in player.frames(realtime=args.realtime):
        frames.append(frame)
        if args.max_frames and len(frames) >= args.max_frames:
            break
    print(
        f"played {player.stats.frames_emitted} frames, "
        f"{player.stats.events_total} events, "
        f"{player.stats.events_per_sec/1e6:.2f} Mev/s"
    )
    if args.output_video and frames:
        ok = write_frames_to_video(np.stack(frames), args.output_video, player.fps)
        print(f"wrote {args.output_video}" if ok else "video write failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
