// selfc_x265 — native H.265 encode/decode bridge for the host codec span of
// selfc_tpu_torch's compression eval (selfc_tpu_torch/codec/h265.py), the
// port's own copy of selfc_tpu/native/selfc_x265.cpp.
//
// The reference drives libx265 through the ffmpeg CLI via skvideo pipes
// (reference: codes/models/modules/Quantization_h265_rgb_stream.py:72-147).
// Where a machine has the ffmpeg *libraries* (libavcodec/libavformat/
// libswscale + libx265) but no CLI binary, this tool reproduces the exact
// pipeline natively:
//
//   encode: stdin raw rgb24 frames -> swscale rgb24->yuv444p -> libx265
//           (preset/tune/x265-params identical to the reference) -> .mkv
//   decode: .mkv -> hevc decode -> swscale ->rgb24 -> stdout
//
// Rate accounting matches the reference (file size of the Matroska output,
// Quantization_h265_rgb_stream.py:128-131), so the container overhead is
// included in bpp exactly as the golden logs measured it.
//
// Build: g++ -O2 -o selfc_x265 selfc_x265.cpp -lavformat -lavcodec -lavutil -lswscale
//
// Usage:
//   selfc_x265 encode --size WxH --crf Q [--keyint K] [--all-default]
//                     [--preset veryfast] [--tune zerolatency] -o OUT.mkv
//   selfc_x265 decode -i IN.mkv
//   selfc_x265 probe
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#ifdef _WIN32
#else
#include <unistd.h>
#endif

static void die(const char *msg, int err = 0) {
    char buf[256] = {0};
    if (err) av_strerror(err, buf, sizeof(buf));
    fprintf(stderr, "selfc_x265: %s %s\n", msg, buf);
    exit(1);
}

static size_t read_full(FILE *f, uint8_t *dst, size_t n) {
    size_t got = 0;
    while (got < n) {
        size_t r = fread(dst + got, 1, n - got, f);
        if (r == 0) break;
        got += r;
    }
    return got;
}

struct Args {
    std::string mode, out, in, preset, tune, x265_params;
    int w = 0, h = 0, crf = -1, keyint = 0;
    bool all_default = false;
};

static Args parse(int argc, char **argv) {
    Args a;
    if (argc < 2) die("usage: selfc_x265 encode|decode|probe ...");
    a.mode = argv[1];
    for (int i = 2; i < argc; i++) {
        std::string k = argv[i];
        auto next = [&]() -> const char * {
            if (i + 1 >= argc) die("missing value for arg");
            return argv[++i];
        };
        if (k == "--size") {
            if (sscanf(next(), "%dx%d", &a.w, &a.h) != 2) die("bad --size");
        } else if (k == "--crf") a.crf = atoi(next());
        else if (k == "--keyint") a.keyint = atoi(next());
        else if (k == "--preset") a.preset = next();
        else if (k == "--tune") a.tune = next();
        else if (k == "--all-default") a.all_default = true;
        else if (k == "--x265-params") a.x265_params = next();
        else if (k == "-o") a.out = next();
        else if (k == "-i") a.in = next();
        else die("unknown arg");
    }
    return a;
}

// ---------------------------------------------------------------- encode --
static int run_encode(const Args &a) {
    if (a.w <= 0 || a.h <= 0 || a.out.empty()) die("encode needs --size and -o");

    const AVCodec *codec = avcodec_find_encoder_by_name("libx265");
    if (!codec) die("libx265 encoder not available in this libavcodec");

    AVFormatContext *oc = nullptr;
    int err = avformat_alloc_output_context2(&oc, nullptr, "matroska", a.out.c_str());
    if (err < 0 || !oc) die("alloc matroska muxer", err);

    AVCodecContext *ctx = avcodec_alloc_context3(codec);
    ctx->width = a.w;
    ctx->height = a.h;
    ctx->pix_fmt = AV_PIX_FMT_YUV444P;   // reference: "-pix_fmt yuv444p" (:81)
    // skvideo feeds rawvideo with no -r, so ffmpeg assumes 25 fps.
    ctx->time_base = AVRational{1, 25};
    ctx->framerate = AVRational{25, 1};
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
        ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

    // Reference param string (Quantization_h265_rgb_stream.py:73-77):
    //   "crf=Q:keyint=K:no-info=1"  (keyint omitted when <= 0)
    std::string params = a.x265_params;
    if (params.empty()) {
        if (a.crf < 0) die("encode needs --crf (or --x265-params)");
        params = "crf=" + std::to_string(a.crf);
        if (a.keyint > 0) params += ":keyint=" + std::to_string(a.keyint);
        params += ":no-info=1";
    }
    av_opt_set(ctx->priv_data, "x265-params", params.c_str(), 0);
    // streaming mode adds "-preset veryfast -tune zerolatency" (:82-84);
    // h265_all_default drops both (:86-92).
    if (!a.all_default) {
        if (!a.preset.empty()) av_opt_set(ctx->priv_data, "preset", a.preset.c_str(), 0);
        if (!a.tune.empty()) av_opt_set(ctx->priv_data, "tune", a.tune.c_str(), 0);
    }

    err = avcodec_open2(ctx, codec, nullptr);
    if (err < 0) die("open libx265", err);

    AVStream *st = avformat_new_stream(oc, nullptr);
    st->time_base = ctx->time_base;
    avcodec_parameters_from_context(st->codecpar, ctx);

    if (!(oc->oformat->flags & AVFMT_NOFILE)) {
        err = avio_open(&oc->pb, a.out.c_str(), AVIO_FLAG_WRITE);
        if (err < 0) die("open output file", err);
    }
    err = avformat_write_header(oc, nullptr);
    if (err < 0) die("write header", err);

    // rgb24 -> yuv444p with swscale, same library/coefficients the ffmpeg
    // CLI uses for this conversion (default bt601 matrix).
    SwsContext *sws = sws_getContext(a.w, a.h, AV_PIX_FMT_RGB24,
                                     a.w, a.h, AV_PIX_FMT_YUV444P,
                                     SWS_BICUBIC, nullptr, nullptr, nullptr);
    AVFrame *yuv = av_frame_alloc();
    yuv->format = AV_PIX_FMT_YUV444P;
    yuv->width = a.w;
    yuv->height = a.h;
    av_frame_get_buffer(yuv, 0);

    const size_t frame_bytes = (size_t)a.w * a.h * 3;
    std::vector<uint8_t> rgb(frame_bytes);
    AVPacket *pkt = av_packet_alloc();
    int64_t pts = 0;

    auto drain = [&](bool flush) {
        int e = avcodec_send_frame(ctx, flush ? nullptr : yuv);
        if (e < 0) die("send frame", e);
        while (true) {
            e = avcodec_receive_packet(ctx, pkt);
            if (e == AVERROR(EAGAIN) || e == AVERROR_EOF) break;
            if (e < 0) die("receive packet", e);
            av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
            pkt->stream_index = st->index;
            e = av_interleaved_write_frame(oc, pkt);
            if (e < 0) die("write packet", e);
        }
    };

    long nframes = 0;
    while (read_full(stdin, rgb.data(), frame_bytes) == frame_bytes) {
        av_frame_make_writable(yuv);
        const uint8_t *src[1] = {rgb.data()};
        int stride[1] = {3 * a.w};
        sws_scale(sws, src, stride, 0, a.h, yuv->data, yuv->linesize);
        yuv->pts = pts++;
        drain(false);
        nframes++;
    }
    drain(true);  // flush encoder

    av_write_trailer(oc);
    fprintf(stderr, "selfc_x265: encoded %ld frames -> %s\n", nframes, a.out.c_str());

    av_packet_free(&pkt);
    av_frame_free(&yuv);
    sws_freeContext(sws);
    avcodec_free_context(&ctx);
    if (!(oc->oformat->flags & AVFMT_NOFILE)) avio_closep(&oc->pb);
    avformat_free_context(oc);
    return 0;
}

// ---------------------------------------------------------------- decode --
static int run_decode(const Args &a) {
    if (a.in.empty()) die("decode needs -i");
    AVFormatContext *ic = nullptr;
    int err = avformat_open_input(&ic, a.in.c_str(), nullptr, nullptr);
    if (err < 0) die("open input", err);
    err = avformat_find_stream_info(ic, nullptr);
    if (err < 0) die("stream info", err);

    int vidx = av_find_best_stream(ic, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (vidx < 0) die("no video stream");
    AVStream *st = ic->streams[vidx];

    const AVCodec *codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) die("no decoder");
    AVCodecContext *ctx = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(ctx, st->codecpar);
    err = avcodec_open2(ctx, codec, nullptr);
    if (err < 0) die("open decoder", err);

    AVFrame *fr = av_frame_alloc();
    AVPacket *pkt = av_packet_alloc();
    SwsContext *sws = nullptr;
    std::vector<uint8_t> rgb;
    long nframes = 0;

    auto emit = [&]() {
        if (!sws) {
            sws = sws_getContext(fr->width, fr->height, (AVPixelFormat)fr->format,
                                 fr->width, fr->height, AV_PIX_FMT_RGB24,
                                 SWS_BICUBIC, nullptr, nullptr, nullptr);
            rgb.resize((size_t)fr->width * fr->height * 3);
        }
        uint8_t *dst[1] = {rgb.data()};
        int stride[1] = {3 * fr->width};
        sws_scale(sws, fr->data, fr->linesize, 0, fr->height, dst, stride);
        fwrite(rgb.data(), 1, rgb.size(), stdout);
        nframes++;
    };

    while (av_read_frame(ic, pkt) >= 0) {
        if (pkt->stream_index == vidx) {
            err = avcodec_send_packet(ctx, pkt);
            if (err < 0) die("send packet", err);
            while (avcodec_receive_frame(ctx, fr) >= 0) emit();
        }
        av_packet_unref(pkt);
    }
    avcodec_send_packet(ctx, nullptr);  // flush
    while (avcodec_receive_frame(ctx, fr) >= 0) emit();

    fflush(stdout);
    fprintf(stderr, "selfc_x265: decoded %ld frames\n", nframes);

    if (sws) sws_freeContext(sws);
    av_packet_free(&pkt);
    av_frame_free(&fr);
    avcodec_free_context(&ctx);
    avformat_close_input(&ic);
    return 0;
}

int main(int argc, char **argv) {
    av_log_set_level(AV_LOG_ERROR);
    Args a = parse(argc, argv);
    if (a.mode == "probe") {
        const AVCodec *e = avcodec_find_encoder_by_name("libx265");
        const AVCodec *d = avcodec_find_decoder(AV_CODEC_ID_HEVC);
        printf("libx265_encoder=%d hevc_decoder=%d\n", e != nullptr, d != nullptr);
        return (e && d) ? 0 : 1;
    }
    if (a.mode == "encode") return run_encode(a);
    if (a.mode == "decode") return run_decode(a);
    die("unknown mode");
    return 1;
}
