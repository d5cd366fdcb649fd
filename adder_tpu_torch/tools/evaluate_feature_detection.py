"""Transcode with feature detection enabled and log CRF/feature statistics
(ref: bin_cv/evaluate_feature_detection_transcode.rs).

The port's twin of `tools/evaluate_feature_detection.py`: the same flags,
defaults, printed line and JSON-lines log, transcoding on `--torch-device`
(K1 with its display output, FAST through `Video.update_detect_features`).

    python -m adder_tpu_torch.tools.evaluate_feature_detection -i in.mp4
"""

import argparse
import sys

import numpy as np

from ..core.types import TimeMode
from ..transcoder.framed import Framed
from ..utils.cv import fast_mask, feature_precision_recall_accuracy
from ..utils.logging import FeatureLogger
from ..utils.viz import ShowFeatureMode
from . import add_torch_device, stream_errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="feature-detection evaluation")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--crf", type=int, default=3)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--max-frames", type=int, default=120)
    p.add_argument("--log", default="feature_eval.jsonl")
    add_torch_device(p)
    args = p.parse_args(argv)
    return stream_errors(lambda: _run(args))


def _run(args) -> int:
    src = Framed(args.input, False, args.scale, max_frames=args.max_frames,
                 device=args.torch_device)
    src.auto_time_parameters(255, 255 * 30, TimeMode.AbsoluteT)
    src.crf(args.crf)
    src.video.update_detect_features(True, ShowFeatureMode.Off, False, False)

    with open(args.log, "w") as fh:
        logger = FeatureLogger(fh, src.video.plane)
        chunk = 0
        while True:
            try:
                events = src.consume_batch()
            except EOFError:
                break
            chunk += 1
            # ground truth: dense FAST over the current reconstruction
            gt_mask = fast_mask(src.video.running_intensities)
            gt = {(int(x), int(y)) for y, x in np.argwhere(gt_mask)}
            pred = set(src.video.features)
            pr, rc, acc = feature_precision_recall_accuracy(
                gt, pred, src.video.plane
            )
            logger.log_precision_recall(pr, rc, acc)
            logger.log_bitrate(
                len(events) * src.video.tps / max(
                    src.video.chunk_frames * src.video.ref_time, 1
                ),
                src.video.get_event_size(),
            )
    print(f"evaluated {chunk} chunks -> {args.log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
