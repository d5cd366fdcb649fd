// Copy of adder_tpu/transcoder/native/videodec.cpp, built for the port by adder_tpu_torch/ops/native_build.py.
// ffmpeg-based RGB24 video decoder reproducing the reference's video-rs
// pipeline (adder-codec-rs/src/transcoder/source/framed.rs:44-79:
// video_rs Decoder::new_with_options_and_resize + Resize::Fit + an RGB24
// swscale stage). It links the same libraries video-rs wraps
// (libavformat/libavcodec/libswscale), so the decoded RGB24 bytes are
// bit-identical to what the Rust implementation transcodes — unlike
// cv2.VideoCapture, whose own YUV->BGR arithmetic differs by +-1 on a few
// percent of pixels and forced the lake golden test to a 95% byte gate.
//
// Build: g++ -O2 -shared -fPIC videodec.cpp -lavformat -lavcodec
//        -lswscale -lavutil

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstring>

namespace {

struct VDec {
    AVFormatContext *fmt = nullptr;
    AVCodecContext *cc = nullptr;
    SwsContext *sws = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
    // swscale's SIMD paths write past tight row ends; scale into this
    // aligned, padded buffer and copy rows into the caller's array
    uint8_t *rgb_data[4] = {nullptr};
    int rgb_linesize[4] = {0};
    int stream_idx = -1;
    int out_w = 0, out_h = 0;
    bool flushing = false;
};

}  // namespace

extern "C" {

// Open `path`; out_w/out_h <= 0 selects the native size. On success fills
// got_w/got_h (output frame size) and fps, and returns a handle.
void *vdec_open(const char *path, int out_w, int out_h, int *got_w,
                int *got_h, double *fps) {
    av_log_set_level(AV_LOG_ERROR);
    VDec *d = new VDec();
    if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) goto fail;
    if (avformat_find_stream_info(d->fmt, nullptr) < 0) goto fail;
    {
        const AVCodec *codec = nullptr;
        d->stream_idx = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1,
                                            -1, &codec, 0);
        if (d->stream_idx < 0 || codec == nullptr) goto fail;
        AVStream *st = d->fmt->streams[d->stream_idx];
        d->cc = avcodec_alloc_context3(codec);
        if (d->cc == nullptr) goto fail;
        if (avcodec_parameters_to_context(d->cc, st->codecpar) < 0) goto fail;
        if (avcodec_open2(d->cc, codec, nullptr) < 0) goto fail;
        d->out_w = out_w > 0 ? out_w : d->cc->width;
        d->out_h = out_h > 0 ? out_h : d->cc->height;
        // video-rs builds its RGB24 scaler with Flags::AREA; at 1:1 size
        // swscale dispatches the unscaled yuv->rgb converter either way
        d->sws = sws_getContext(d->cc->width, d->cc->height, d->cc->pix_fmt,
                                d->out_w, d->out_h, AV_PIX_FMT_RGB24,
                                SWS_AREA, nullptr, nullptr, nullptr);
        if (d->sws == nullptr) goto fail;
        d->frame = av_frame_alloc();
        d->pkt = av_packet_alloc();
        if (d->frame == nullptr || d->pkt == nullptr) goto fail;
        if (av_image_alloc(d->rgb_data, d->rgb_linesize, d->out_w, d->out_h,
                           AV_PIX_FMT_RGB24, 64) < 0)
            goto fail;
        *got_w = d->out_w;
        *got_h = d->out_h;
        AVRational r = st->avg_frame_rate;  // video-rs frame_rate()
        if (r.num == 0 || r.den == 0) r = st->r_frame_rate;
        *fps = (r.den != 0) ? av_q2d(r) : 0.0;
    }
    return d;
fail:
    if (d->cc) avcodec_free_context(&d->cc);
    if (d->fmt) avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
}

// Decode the next frame into `out` (out_h * out_w * 3 bytes, RGB24,
// tightly packed). Returns 1 on a frame, 0 at EOF, <0 on error.
int vdec_next(void *handle, uint8_t *out) {
    VDec *d = static_cast<VDec *>(handle);
    for (;;) {
        int r = avcodec_receive_frame(d->cc, d->frame);
        if (r == 0) {
            sws_scale(d->sws, d->frame->data, d->frame->linesize, 0,
                      d->cc->height, d->rgb_data, d->rgb_linesize);
            av_frame_unref(d->frame);
            for (int y = 0; y < d->out_h; ++y)
                std::memcpy(out + static_cast<size_t>(y) * d->out_w * 3,
                            d->rgb_data[0] +
                                static_cast<size_t>(y) * d->rgb_linesize[0],
                            static_cast<size_t>(d->out_w) * 3);
            return 1;
        }
        if (r == AVERROR_EOF) return 0;
        if (r != AVERROR(EAGAIN)) return r;
        if (d->flushing) return 0;
        // feed the decoder until it produces a frame or the file ends
        for (;;) {
            r = av_read_frame(d->fmt, d->pkt);
            if (r < 0) {
                avcodec_send_packet(d->cc, nullptr);  // enter drain mode
                d->flushing = true;
                break;
            }
            if (d->pkt->stream_index == d->stream_idx) {
                r = avcodec_send_packet(d->cc, d->pkt);
                av_packet_unref(d->pkt);
                if (r < 0 && r != AVERROR(EAGAIN)) return r;
                break;
            }
            av_packet_unref(d->pkt);
        }
    }
}

void vdec_close(void *handle) {
    VDec *d = static_cast<VDec *>(handle);
    if (d == nullptr) return;
    if (d->rgb_data[0]) av_freep(&d->rgb_data[0]);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->frame) av_frame_free(&d->frame);
    if (d->sws) sws_freeContext(d->sws);
    if (d->cc) avcodec_free_context(&d->cc);
    if (d->fmt) avformat_close_input(&d->fmt);
    delete d;
}

}  // extern "C"
