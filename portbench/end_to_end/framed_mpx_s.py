"""framed_mpx_s: H x W x the frames of the chunks collected in the window,
over the window's seconds, in millions (channels not counted)."""

from portbench import stats


def read(run):
    return stats.rate(run.pixels_per_frame * run.frames, run.window_s) / 1e6
