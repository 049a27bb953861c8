// cvsim-av — native container I/O for cvsim_tpu, linked against the
// system FFmpeg libraries (libavformat/libavcodec/libavutil/libswscale/
// libswresample), the same layer the reference links in-process
// (ffmpeg_to_composite.cpp:34-53, 1966-2118).  The TPU pipelines speak
// Y4M / raw PCM over pipes; this tool is the bridge to real containers:
//
//   cvsim-av probe -i IN
//       one JSON line of stream info on stdout
//   cvsim-av decode -i IN [-pix 420|422] [-ts] [-frame-log F] [-pkt-log F]
//                   [-audio-pkt-log F]
//       decode best video stream -> Y4M on stdout.  -ts adds an in-band
//       "Xt=<pts90k>:<dur90k>" parameter to each FRAME marker (streaming-
//       safe VFR: the duration map arrives WITH the frame, not at EOF).
//       Sidecar logs feed the Python tools *real* container timestamps:
//         -frame-log      "rate 90000" + "<pts> <duration>" per frame in
//                         presentation order  (== the CLI's -video-pts-in
//                         VFR/telecine duration map,
//                         ffmpeg_to_composite.cpp:1641-1647 reordered_opaque)
//         -pkt-log        "<stream_index> <pts|none>" per packet in mux
//                         order              (== normalize-ts -pts-in)
//         -audio-pkt-log  "rate <hz>" + "<pts_samples|none> <nsamples>"
//                         per best-audio-stream packet (== -audio-pts-in,
//                         the A/V master-clock gap fill,
//                         ffmpeg_to_composite.cpp:1892-1915)
//   cvsim-av decode-audio -i IN -rate R -ch C
//       decode + resample best audio stream -> s16le interleaved on stdout
//   cvsim-av encode -o OUT [-wav W] [-crf N] [-crf-max N] [-preset P]
//                   [-vb BPS] [-interlaced] [-pts-log F]
//       Y4M on stdin -> H.264 (gop 15, no B-frames, 4:3 DAR) + PCM S16LE
//       in one container, the reference's output shape
//       (ffmpeg_to_composite.cpp:2034-2106).  -pts-log replays a
//       "rate <hz>" / "<pts> <duration>" frame log as the encode
//       timestamps (VFR-preserving mux).
//   cvsim-av vhsled|frameblend|filmac -i IN -o OUT [tool flags]
//       the restore tools' whole decode -> kernel -> encode loop in ONE
//       address space, the reference binaries' cost class
//       (ffmpeg_vhsled.cpp:838-977, frameblend.cpp:929-1081,
//       filmac.cpp:842-1010).  The pixel kernels are the same hostpix.cpp
//       functions the Python fallback loop calls through ctypes, so both
//       paths are byte-identical (tests/test_restore_native.py).  The
//       Python CLI parses/validates user flags and delegates here with
//       the canonical internal flags (-width/-height/-underscan/-or-num/
//       -or-den/-fa/-ffa/-sqnr/-gamma plus the encoder profile).

#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <utility>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

// hostpix.cpp kernels, compiled into this binary (same objects the Python
// fallback loop dlopens as libhostpix.so — the two tool paths share one
// pixel implementation)
// The tool loops use the uint8 forms: every kernel boundary carries 0..255
// values, so u8 planes hold the identical numbers at 1/4 the bytes of the
// int32 ctypes API the Python fallback loop dlopens (hostpix.cpp exports
// both flavours of ONE templated implementation).
extern "C" {
void cvsim_scale_frame_bc_u8(const uint8_t *y, const uint8_t *u,
                             const uint8_t *v, long sh, long sw, long ch,
                             long cw, long dh, long dw, const int64_t *hx0,
                             const int64_t *hx1, const float *hf, int has_h,
                             const int64_t *vx0, const int64_t *vx1,
                             const float *vf, int has_v,
                             const int64_t *cux0, const int64_t *cux1,
                             const float *cuf, int has_cu,
                             const int64_t *cvx0, const int64_t *cvx1,
                             const float *cvf, int has_cv, uint8_t *out);
void cvsim_rgb_to_yuv_sub_u8(const uint8_t *rgb, long h, long w, int is422,
                             uint8_t *yo, long ys, uint8_t *uo, long us,
                             uint8_t *vo, long vs);
void cvsim_vhsled_dejitter_u8(const uint8_t *f, long h, long w, uint8_t *out);
void cvsim_frameblend_mix_u8(const uint8_t **frames, long k, long h, long w,
                             const int64_t *w16, const int64_t *gdec,
                             const int64_t *genc, uint8_t *out);
void cvsim_filmac_measure_u8(const uint8_t *rgb, long h, long w,
                             const int64_t *gdec, int64_t *minv_out,
                             int64_t *maxv_out);
void cvsim_filmac_rescale_u8(const uint8_t *rgb, long h, long w, int64_t minv,
                             int64_t maxv, int64_t scaleto,
                             const int64_t *gdec, const int64_t *genc,
                             uint8_t *out);
}

// FFmpeg 6/7 renamed the frame duration and interlace fields; keep 5.x
// (this image: 5.1) and 6+/7+ building from one source.
#if LIBAVUTIL_VERSION_MAJOR >= 58
#define FRAME_DURATION(f) ((f)->duration)
#else
#define FRAME_DURATION(f) ((f)->pkt_duration)
#endif
#ifdef AV_FRAME_FLAG_INTERLACED
#define FRAME_INTERLACED(f) (((f)->flags & AV_FRAME_FLAG_INTERLACED) != 0)
#define FRAME_TFF(f) (((f)->flags & AV_FRAME_FLAG_TOP_FIELD_FIRST) != 0)
#define SET_FRAME_INTERLACED(f, il, tff)                        \
  do {                                                          \
    if (il) (f)->flags |= AV_FRAME_FLAG_INTERLACED;             \
    if (tff) (f)->flags |= AV_FRAME_FLAG_TOP_FIELD_FIRST;       \
  } while (0)
#else
#define FRAME_INTERLACED(f) ((f)->interlaced_frame != 0)
#define FRAME_TFF(f) ((f)->top_field_first != 0)
#define SET_FRAME_INTERLACED(f, il, tff)    \
  do {                                      \
    (f)->interlaced_frame = (il) ? 1 : 0;   \
    (f)->top_field_first = (tff) ? 1 : 0;   \
  } while (0)
#endif

namespace {

[[noreturn]] void die(const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  fprintf(stderr, "cvsim-av: ");
  vfprintf(stderr, fmt, ap);
  fprintf(stderr, "\n");
  va_end(ap);
  exit(1);
}

[[noreturn]] void die_av(const char *what, int err) {
  char buf[256];
  av_strerror(err, buf, sizeof buf);
  die("%s: %s", what, buf);
}

void check(int err, const char *what) {
  if (err < 0) die_av(what, err);
}

struct Args {
  std::string in, out, wav, frame_log, pkt_log, audio_pkt_log, pts_log;
  std::string pix = "420";
  std::string preset;
  int crf = 18, crf_max = -1, rate = 44100, ch = 2;
  long vb = 0;   // >0: ABR at this bit rate instead of crf (frameblend.cpp:794)
  bool interlaced = false, ts = false;
  // restore-tool flags (canonical internal form, set by the Python CLI)
  int width = -1, height = -1;   // <0: follow the input's dims
  int underscan = 0, fa = 1;
  bool ffa = false, sqnr = false;
  double gamma = -1.0;
  long long or_num = 60000, or_den = 1001;   // frameblend output rate
};

Args parse_args(int argc, char **argv) {
  Args a;
  for (int i = 0; i < argc; i++) {
    std::string f = argv[i];
    auto val = [&]() -> std::string {
      if (++i >= argc) die("flag %s needs a value", f.c_str());
      return argv[i];
    };
    if (f == "-i") a.in = val();
    else if (f == "-o") a.out = val();
    else if (f == "-wav") a.wav = val();
    else if (f == "-pix") a.pix = val();
    else if (f == "-crf") a.crf = atoi(val().c_str());
    else if (f == "-crf-max") a.crf_max = atoi(val().c_str());
    else if (f == "-vb") a.vb = atol(val().c_str());
    else if (f == "-preset") a.preset = val();
    else if (f == "-rate") a.rate = atoi(val().c_str());
    else if (f == "-ch") a.ch = atoi(val().c_str());
    else if (f == "-frame-log") a.frame_log = val();
    else if (f == "-pkt-log") a.pkt_log = val();
    else if (f == "-audio-pkt-log") a.audio_pkt_log = val();
    else if (f == "-pts-log") a.pts_log = val();
    else if (f == "-interlaced") a.interlaced = true;
    else if (f == "-ts") a.ts = true;
    else if (f == "-width") a.width = atoi(val().c_str());
    else if (f == "-height") a.height = atoi(val().c_str());
    else if (f == "-underscan") a.underscan = atoi(val().c_str());
    else if (f == "-fa") a.fa = atoi(val().c_str());
    else if (f == "-ffa") a.ffa = true;
    else if (f == "-sqnr") a.sqnr = true;
    else if (f == "-gamma") a.gamma = atof(val().c_str());
    else if (f == "-or-num") a.or_num = atoll(val().c_str());
    else if (f == "-or-den") a.or_den = atoll(val().c_str());
    else die("unknown flag %s", f.c_str());
  }
  return a;
}

FILE *open_log(const std::string &path) {
  if (path.empty()) return nullptr;
  FILE *f = fopen(path.c_str(), "w");
  if (!f) die("cannot open %s", path.c_str());
  return f;
}

AVFormatContext *open_input(const std::string &path) {
  AVFormatContext *fc = nullptr;
  check(avformat_open_input(&fc, path.c_str(), nullptr, nullptr),
        "open input");
  check(avformat_find_stream_info(fc, nullptr), "find stream info");
  return fc;
}

AVCodecContext *open_decoder(AVFormatContext *fc, int stream) {
  AVStream *st = fc->streams[stream];
  const AVCodec *dec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!dec) die("no decoder for stream %d", stream);
  AVCodecContext *ctx = avcodec_alloc_context3(dec);
  check(avcodec_parameters_to_context(ctx, st->codecpar), "codec params");
  ctx->pkt_timebase = st->time_base;
  check(avcodec_open2(ctx, dec, nullptr), "open decoder");
  return ctx;
}

// ---------------------------------------------------------------- probe

int cmd_probe(const Args &a) {
  if (a.in.empty()) die("probe needs -i");
  AVFormatContext *fc = open_input(a.in);
  printf("{\"format\": \"%s\", \"duration_sec\": %.6f, \"streams\": [",
         fc->iformat->name,
         fc->duration > 0 ? fc->duration / (double)AV_TIME_BASE : -1.0);
  for (unsigned i = 0; i < fc->nb_streams; i++) {
    AVStream *st = fc->streams[i];
    AVCodecParameters *p = st->codecpar;
    const char *type = av_get_media_type_string(p->codec_type);
    const char *codec = avcodec_get_name(p->codec_id);
    if (i) printf(", ");
    printf("{\"index\": %u, \"type\": \"%s\", \"codec\": \"%s\"", i,
           type ? type : "?", codec);
    if (p->codec_type == AVMEDIA_TYPE_VIDEO) {
      AVRational fr = av_guess_frame_rate(fc, st, nullptr);
      printf(", \"width\": %d, \"height\": %d, \"fps\": \"%d:%d\""
             ", \"pix_fmt\": \"%s\"",
             p->width, p->height, fr.num, fr.den,
             av_get_pix_fmt_name((AVPixelFormat)p->format)
                 ? av_get_pix_fmt_name((AVPixelFormat)p->format) : "?");
    } else if (p->codec_type == AVMEDIA_TYPE_AUDIO) {
      printf(", \"sample_rate\": %d, \"channels\": %d", p->sample_rate,
             p->ch_layout.nb_channels);
    }
    printf(", \"time_base\": \"%d:%d\", \"nb_frames\": %lld}",
           st->time_base.num, st->time_base.den,
           (long long)st->nb_frames);
  }
  printf("]}\n");
  avformat_close_input(&fc);
  return 0;
}

// --------------------------------------------------------------- decode

struct Y4MOut {
  int w = 0, h = 0, ch = 0, cw = 0;
  bool wrote_header = false;

  void header(int width, int height, AVRational fps, char ilace,
              AVRational sar, bool is422) {
    w = width;
    h = height;
    ch = is422 ? h : h / 2;
    cw = w / 2;
    printf("YUV4MPEG2 W%d H%d F%d:%d I%c A%d:%d C%s\n", w, h,
           fps.num > 0 ? fps.num : 30000, fps.num > 0 ? fps.den : 1001,
           ilace, sar.num, sar.den, is422 ? "422" : "420jpeg");
    wrote_header = true;
  }

  void frame(const uint8_t *y, int ystride, const uint8_t *u, const uint8_t *v,
             int cstride, bool ts = false, int64_t pts90k = -1,
             int64_t dur90k = -1, bool has_pts = true) {
    // with ts, EVERY frame gets a marker — "n" means "no container
    // pts, extend by cadence" (a distinct token, NOT -1: real container
    // pts can be negative after rescale); omitting the marker would
    // desynchronize the consumer's frame-indexed duration map
    if (ts && !has_pts)
      printf("FRAME Xt=n:%lld\n", (long long)dur90k);
    else if (ts)
      printf("FRAME Xt=%lld:%lld\n", (long long)pts90k, (long long)dur90k);
    else
      fputs("FRAME\n", stdout);
    for (int r = 0; r < h; r++) fwrite(y + (size_t)r * ystride, 1, w, stdout);
    for (int r = 0; r < ch; r++) fwrite(u + (size_t)r * cstride, 1, cw, stdout);
    for (int r = 0; r < ch; r++) fwrite(v + (size_t)r * cstride, 1, cw, stdout);
  }
};

int cmd_decode(const Args &a) {
  if (a.in.empty()) die("decode needs -i");
  bool is422 = a.pix == "422";
  AVFormatContext *fc = open_input(a.in);
  int vidx = av_find_best_stream(fc, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vidx < 0) die("no video stream in %s", a.in.c_str());
  int aidx = av_find_best_stream(fc, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  AVCodecContext *dec = open_decoder(fc, vidx);
  AVStream *vst = fc->streams[vidx];

  FILE *flog = open_log(a.frame_log);
  FILE *plog = open_log(a.pkt_log);
  FILE *alog = open_log(a.audio_pkt_log);
  if (flog) fprintf(flog, "rate 90000\n");
  int arate = 0;
  if (alog) {
    if (aidx < 0) die("-audio-pkt-log: no audio stream");
    arate = fc->streams[aidx]->codecpar->sample_rate;
    fprintf(alog, "rate %d\n", arate);
  }

  Y4MOut y4m;
  AVPixelFormat outfmt = is422 ? AV_PIX_FMT_YUV422P : AV_PIX_FMT_YUV420P;
  SwsContext *sws = nullptr;
  AVFrame *frame = av_frame_alloc(), *conv = av_frame_alloc();
  AVPacket *pkt = av_packet_alloc();
  AVRational fps = av_guess_frame_rate(fc, vst, nullptr);
  AVRational tb90k = {1, 90000};
  // fallback frame duration when the container carries none: 1/fps
  int64_t dur90k_cfr =
      fps.num > 0 ? av_rescale_q(1, av_inv_q(fps), tb90k) : 3003;

  auto emit = [&](AVFrame *f) {
    if (!y4m.wrote_header) {
      char ilace = FRAME_INTERLACED(f) ? (FRAME_TFF(f) ? 't' : 'b') : 'p';
      AVRational sar = f->sample_aspect_ratio.num > 0
                           ? f->sample_aspect_ratio
                           : (AVRational){0, 0};
      y4m.header(f->width, f->height, fps, ilace, sar, is422);
    }
    AVFrame *src = f;
    if (f->format != outfmt) {
      sws = sws_getCachedContext(sws, f->width, f->height,
                                 (AVPixelFormat)f->format, f->width,
                                 f->height, outfmt, SWS_BILINEAR, nullptr,
                                 nullptr, nullptr);
      conv->format = outfmt;
      conv->width = f->width;
      conv->height = f->height;
      av_frame_unref(conv);
      conv->format = outfmt;
      conv->width = f->width;
      conv->height = f->height;
      check(av_frame_get_buffer(conv, 0), "alloc conv frame");
      sws_scale(sws, f->data, f->linesize, 0, f->height, conv->data,
                conv->linesize);
      src = conv;
    }
    int64_t pts = f->best_effort_timestamp;
    int64_t p90 = pts == AV_NOPTS_VALUE
                      ? -1
                      : av_rescale_q(pts, vst->time_base, tb90k);
    int64_t d90 = FRAME_DURATION(f) > 0
                      ? av_rescale_q(FRAME_DURATION(f), vst->time_base,
                                     tb90k)
                      : dur90k_cfr;
    y4m.frame(src->data[0], src->linesize[0], src->data[1], src->data[2],
              src->linesize[1], a.ts, p90, d90, pts != AV_NOPTS_VALUE);
    if (flog) fprintf(flog, "%lld %lld\n", (long long)p90, (long long)d90);
  };

  auto drain = [&]() {
    while (avcodec_receive_frame(dec, frame) == 0) emit(frame);
  };

  while (av_read_frame(fc, pkt) >= 0) {
    if (plog) {
      if (pkt->pts == AV_NOPTS_VALUE)
        fprintf(plog, "%d none\n", pkt->stream_index);
      else
        fprintf(plog, "%d %lld\n", pkt->stream_index, (long long)pkt->pts);
    }
    if (alog && pkt->stream_index == aidx) {
      AVStream *ast = fc->streams[aidx];
      AVRational smp = {1, arate};
      int64_t ps = pkt->pts == AV_NOPTS_VALUE
                       ? -1
                       : av_rescale_q(pkt->pts, ast->time_base, smp);
      int64_t ns = pkt->duration > 0
                       ? av_rescale_q(pkt->duration, ast->time_base, smp)
                       : 0;
      if (ps < 0)
        fprintf(alog, "none %lld\n", (long long)ns);
      else
        fprintf(alog, "%lld %lld\n", (long long)ps, (long long)ns);
    }
    if (pkt->stream_index == vidx) {
      check(avcodec_send_packet(dec, pkt), "send packet");
      drain();
    }
    av_packet_unref(pkt);
  }
  avcodec_send_packet(dec, nullptr);
  drain();

  for (FILE *f : {flog, plog, alog})
    if (f) fclose(f);
  fflush(stdout);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  av_frame_free(&conv);
  sws_freeContext(sws);
  avcodec_free_context(&dec);
  avformat_close_input(&fc);
  return 0;
}

// --------------------------------------------------------- decode-audio

int cmd_decode_audio(const Args &a) {
  if (a.in.empty()) die("decode-audio needs -i");
  AVFormatContext *fc = open_input(a.in);
  int aidx = av_find_best_stream(fc, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (aidx < 0) die("no audio stream in %s", a.in.c_str());
  AVCodecContext *dec = open_decoder(fc, aidx);
  AVStream *ast = fc->streams[aidx];

  FILE *alog = open_log(a.audio_pkt_log);
  if (alog) fprintf(alog, "rate %d\n", dec->sample_rate);

  SwrContext *swr = nullptr;
  AVChannelLayout outlay;
  av_channel_layout_default(&outlay, a.ch);
  check(swr_alloc_set_opts2(&swr, &outlay, AV_SAMPLE_FMT_S16, a.rate,
                            &dec->ch_layout, dec->sample_fmt,
                            dec->sample_rate, 0, nullptr),
        "swr opts");
  check(swr_init(swr), "swr init");

  AVFrame *frame = av_frame_alloc();
  AVPacket *pkt = av_packet_alloc();
  std::vector<uint8_t> buf;

  auto emit = [&](AVFrame *f) {
    int max_out = swr_get_out_samples(swr, f ? f->nb_samples : 0);
    if (max_out <= 0) return;
    buf.resize((size_t)max_out * a.ch * 2);
    uint8_t *out = buf.data();
    int n = swr_convert(swr, &out, max_out,
                        f ? (const uint8_t **)f->extended_data : nullptr,
                        f ? f->nb_samples : 0);
    if (n > 0) fwrite(buf.data(), 2 * a.ch, n, stdout);
  };

  while (av_read_frame(fc, pkt) >= 0) {
    if (pkt->stream_index == aidx) {
      AVRational smp = {1, dec->sample_rate};
      int64_t log_pts = pkt->pts;
      // containers without packet durations (raw ADTS, some MPEG-TS)
      // would log n=0, which the pad-fill consumer reads as "this packet
      // contributes no samples" — instead attribute the samples the
      // decoder actually produces for this packet, the reference's own
      // decoded-frame accounting (ffmpeg_to_composite.cpp:1892-1915)
      int64_t ns = pkt->duration > 0
                       ? av_rescale_q(pkt->duration, ast->time_base, smp)
                       : -1;
      check(avcodec_send_packet(dec, pkt), "send packet");
      int64_t decoded = 0;
      while (avcodec_receive_frame(dec, frame) == 0) {
        decoded += frame->nb_samples;
        emit(frame);
      }
      if (alog) {
        if (ns < 0) ns = decoded;
        if (log_pts == AV_NOPTS_VALUE)
          fprintf(alog, "none %lld\n", (long long)ns);
        else
          fprintf(alog, "%lld %lld\n",
                  (long long)av_rescale_q(log_pts, ast->time_base, smp),
                  (long long)ns);
      }
    }
    av_packet_unref(pkt);
  }
  avcodec_send_packet(dec, nullptr);
  while (avcodec_receive_frame(dec, frame) == 0) emit(frame);
  emit(nullptr);  // flush resampler tail

  if (alog) fclose(alog);
  fflush(stdout);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  swr_free(&swr);
  av_channel_layout_uninit(&outlay);
  avcodec_free_context(&dec);
  avformat_close_input(&fc);
  return 0;
}

// --------------------------------------------------------------- encode

struct Y4MIn {
  int w = 0, h = 0, fn = 30000, fd = 1001, ch = 0, cw = 0;
  char ilace = 'p';
  bool is422 = false;

  void parse_header() {
    char line[512];
    if (!fgets(line, sizeof line, stdin)) die("empty y4m stream");
    if (strncmp(line, "YUV4MPEG2", 9)) die("not a YUV4MPEG2 stream");
    for (char *tok = strtok(line + 9, " \n"); tok;
         tok = strtok(nullptr, " \n")) {
      switch (tok[0]) {
        case 'W': w = atoi(tok + 1); break;
        case 'H': h = atoi(tok + 1); break;
        case 'F': sscanf(tok + 1, "%d:%d", &fn, &fd); break;
        case 'I': ilace = tok[1]; break;
        case 'C': is422 = !strncmp(tok + 1, "422", 3); break;
        default: break;
      }
    }
    if (!w || !h) die("missing W/H in y4m header");
    ch = is422 ? h : h / 2;
    cw = w / 2;
  }

  // reads one frame's planes into f (yuv420p/yuv422p); false at EOF
  bool read_frame(AVFrame *f) {
    char line[256];
    if (!fgets(line, sizeof line, stdin)) return false;
    if (strncmp(line, "FRAME", 5)) die("bad frame marker");
    auto plane = [&](uint8_t *dst, int stride, int rows, int cols) {
      for (int r = 0; r < rows; r++)
        if (fread(dst + (size_t)r * stride, 1, cols, stdin) != (size_t)cols)
          die("truncated y4m frame");
    };
    plane(f->data[0], f->linesize[0], h, w);
    plane(f->data[1], f->linesize[1], ch, cw);
    plane(f->data[2], f->linesize[2], ch, cw);
    return true;
  }
};

struct PtsLog {
  std::vector<std::pair<int64_t, int64_t>> entries;  // (pts, duration)
  int64_t rate = 90000;

  void load(const std::string &path) {
    FILE *f = fopen(path.c_str(), "r");
    if (!f) die("cannot open %s", path.c_str());
    char line[256];
    while (fgets(line, sizeof line, f)) {
      long long p, d;
      if (!strncmp(line, "rate ", 5)) rate = atoll(line + 5);
      else if (sscanf(line, "%lld %lld", &p, &d) == 2)
        entries.emplace_back(p, d);
    }
    fclose(f);
  }
};

int cmd_encode(const Args &a) {
  if (a.out.empty()) die("encode needs -o");
  Y4MIn in;
  in.parse_header();

  PtsLog plog;
  if (!a.pts_log.empty()) plog.load(a.pts_log);
  bool vfr = !plog.entries.empty();

  AVFormatContext *oc = nullptr;
  check(avformat_alloc_output_context2(&oc, nullptr, nullptr, a.out.c_str()),
        "alloc output");

  // -- video: H.264, gop 15, no B-frames, 4:3 DAR (the reference's
  //    output stream shape, ffmpeg_to_composite.cpp:2067-2106)
  const AVCodec *venc = avcodec_find_encoder_by_name("libx264");
  if (!venc) venc = avcodec_find_encoder(AV_CODEC_ID_H264);
  if (!venc) die("no H.264 encoder available");
  AVCodecContext *vc = avcodec_alloc_context3(venc);
  vc->width = in.w;
  vc->height = in.h;
  vc->pix_fmt = in.is422 ? AV_PIX_FMT_YUV422P : AV_PIX_FMT_YUV420P;
  vc->time_base = vfr ? (AVRational){1, (int)plog.rate}
                      : (AVRational){in.fd, in.fn};
  vc->framerate = {in.fn, in.fd};
  vc->gop_size = 15;
  vc->max_b_frames = 0;
  vc->thread_count = 0;   // auto frame-threading: the encoder otherwise
                          // serializes the whole tool at ~16 ms/frame SD
  // 4:3 display aspect: SAR = DAR * H / W
  vc->sample_aspect_ratio = av_d2q(4.0 * in.h / (3.0 * in.w), 4096);
  if (a.interlaced || in.ilace == 't' || in.ilace == 'b')
    vc->flags |= AV_CODEC_FLAG_INTERLACED_DCT | AV_CODEC_FLAG_INTERLACED_ME;
  if (oc->oformat->flags & AVFMT_GLOBALHEADER)
    vc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (a.vb > 0) {
    vc->bit_rate = a.vb;   // ABR, x264 default preset (frameblend.cpp:794)
  } else {
    char crfs[16];
    snprintf(crfs, sizeof crfs, "%d", a.crf);
    av_opt_set(vc->priv_data, "crf", crfs, 0);
    if (a.crf_max >= 0) {
      snprintf(crfs, sizeof crfs, "%d", a.crf_max);
      av_opt_set(vc->priv_data, "crf_max", crfs, 0);
    }
  }
  if (!a.preset.empty()) av_opt_set(vc->priv_data, "preset", a.preset.c_str(), 0);
  check(avcodec_open2(vc, venc, nullptr), "open video encoder");
  AVStream *vs = avformat_new_stream(oc, nullptr);
  check(avcodec_parameters_from_context(vs->codecpar, vc), "video params");
  vs->time_base = vc->time_base;
  vs->sample_aspect_ratio = vc->sample_aspect_ratio;
  // record the nominal rate: containers with coarse timebases (mkv: 1ms)
  // would otherwise make demuxers guess a rounded rate (e.g. 359/12)
  vs->avg_frame_rate = vc->framerate;

  // -- audio: decode the processed WAV, re-encode PCM S16LE alongside
  //    (ffmpeg_to_composite.cpp:2034-2065)
  AVFormatContext *wfc = nullptr;
  AVCodecContext *wdec = nullptr, *ac = nullptr;
  AVStream *as = nullptr;
  int widx = -1;
  if (!a.wav.empty()) {
    wfc = open_input(a.wav);
    widx = av_find_best_stream(wfc, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
    if (widx < 0) die("no audio stream in %s", a.wav.c_str());
    wdec = open_decoder(wfc, widx);
    const AVCodec *aenc = avcodec_find_encoder(AV_CODEC_ID_PCM_S16LE);
    ac = avcodec_alloc_context3(aenc);
    ac->sample_rate = wdec->sample_rate;
    check(av_channel_layout_copy(&ac->ch_layout, &wdec->ch_layout),
          "ch layout");
    ac->sample_fmt = AV_SAMPLE_FMT_S16;
    ac->time_base = {1, ac->sample_rate};
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
      ac->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    check(avcodec_open2(ac, aenc, nullptr), "open audio encoder");
    as = avformat_new_stream(oc, nullptr);
    check(avcodec_parameters_from_context(as->codecpar, ac), "audio params");
    as->time_base = ac->time_base;
  }

  if (!(oc->oformat->flags & AVFMT_NOFILE))
    check(avio_open(&oc->pb, a.out.c_str(), AVIO_FLAG_WRITE), "open file");
  check(avformat_write_header(oc, nullptr), "write header");

  AVPacket *opkt = av_packet_alloc();
  auto mux_from = [&](AVCodecContext *ctx, AVStream *st) {
    while (avcodec_receive_packet(ctx, opkt) == 0) {
      av_packet_rescale_ts(opkt, ctx->time_base, st->time_base);
      opkt->stream_index = st->index;
      check(av_interleaved_write_frame(oc, opkt), "write frame");
    }
  };

  // audio pump: encode WAV samples up to video time t (in seconds);
  // -shortest semantics — audio past the video end is dropped
  AVPacket *wpkt = av_packet_alloc();
  AVFrame *wframe = av_frame_alloc();
  bool wav_eof = a.wav.empty();
  double audio_t = 0.0;
  auto pump_audio = [&](double until_sec) {
    while (!wav_eof && audio_t < until_sec) {
      int rc = av_read_frame(wfc, wpkt);
      if (rc < 0) {
        wav_eof = true;
        break;
      }
      if (wpkt->stream_index != widx) {
        av_packet_unref(wpkt);
        continue;
      }
      check(avcodec_send_packet(wdec, wpkt), "send wav packet");
      av_packet_unref(wpkt);
      while (avcodec_receive_frame(wdec, wframe) == 0) {
        wframe->pts = av_rescale_q(
            (int64_t)(audio_t * ac->sample_rate + 0.5),
            (AVRational){1, ac->sample_rate}, ac->time_base);
        audio_t += wframe->nb_samples / (double)ac->sample_rate;
        check(avcodec_send_frame(ac, wframe), "send audio frame");
        mux_from(ac, as);
      }
    }
  };

  AVFrame *vf = av_frame_alloc();
  vf->format = vc->pix_fmt;
  vf->width = in.w;
  vf->height = in.h;
  check(av_frame_get_buffer(vf, 0), "alloc video frame");
  bool tff = a.interlaced || in.ilace == 't';
  bool ilaced = a.interlaced || in.ilace == 't' || in.ilace == 'b';

  int64_t n = 0;
  double video_t = 0.0;
  double last_dur_t = 0.0;  // VFR: last frame's duration in seconds
  while (true) {
    check(av_frame_make_writable(vf), "frame writable");
    if (!in.read_frame(vf)) break;
    if (vfr) {
      // rebase to the log's first entry: a raw demuxer log can start at a
      // large container offset (MPEG-TS), while the audio clock below is
      // 0-based — absolute pts would push the video `video_t` seconds
      // ahead and pump the whole WAV out at the first frame
      int64_t base = plog.entries.front().first;
      auto &e = n < (int64_t)plog.entries.size()
                    ? plog.entries[n]
                    : plog.entries.back();
      vf->pts = (n < (int64_t)plog.entries.size()
                     ? e.first
                     : plog.entries.back().first +
                           (n - (int64_t)plog.entries.size() + 1) * e.second)
                - base;
      video_t = vf->pts / (double)plog.rate;
      last_dur_t = e.second / (double)plog.rate;
    } else {
      vf->pts = n;
      video_t = n * in.fd / (double)in.fn;
    }
    SET_FRAME_INTERLACED(vf, ilaced, tff);
    pump_audio(video_t);
    check(avcodec_send_frame(vc, vf), "send video frame");
    mux_from(vc, vs);
    n++;
  }
  // extend audio past the last frame's START by its full duration
  // (CFR: one frame period; VFR: the log's last-entry duration)
  pump_audio(video_t + (vfr ? last_dur_t : in.fd / (double)in.fn));
  check(avcodec_send_frame(vc, nullptr), "flush video");
  mux_from(vc, vs);
  if (ac) {
    check(avcodec_send_frame(ac, nullptr), "flush audio");
    mux_from(ac, as);
  }
  check(av_write_trailer(oc), "write trailer");

  fprintf(stderr, "cvsim-av: %lld frames -> %s\n", (long long)n,
          a.out.c_str());
  av_packet_free(&opkt);
  av_packet_free(&wpkt);
  av_frame_free(&wframe);
  av_frame_free(&vf);
  if (wdec) avcodec_free_context(&wdec);
  if (wfc) avformat_close_input(&wfc);
  if (ac) avcodec_free_context(&ac);
  avcodec_free_context(&vc);
  if (!(oc->oformat->flags & AVFMT_NOFILE)) avio_closep(&oc->pb);
  avformat_free_context(oc);
  return 0;
}

// -------------------------------------------- restore tools (in-process)
// The reference restore tools run decode -> pixel loop -> encode in one
// address space; the Y4M-pipe bridge was the one place the reference
// binaries beat the framework at their own job (VERDICT r4 #2).  These
// loops mirror cli/tools.py's Python loops statement-for-statement and
// call the SAME hostpix.cpp kernels, so the two paths stay byte-identical
// (tests/test_restore_native.py pins y4m-in/y4m-out equality).

// frame planes in the layout cvsim_scale_frame consumes (contiguous rows)
struct PlaneView {
  const uint8_t *y, *u, *v;
  long h, w, ch, cw;
};

// in-process twin of the `cvsim-av decode` ingest: .y4m inputs keep their
// native chroma layout (the Python path reads Y4M directly), containers
// are converted to yuv420p (the decode pipe's default -pix 420)
struct VDecoder {
  AVFormatContext *fc = nullptr;
  AVCodecContext *dec = nullptr;
  AVStream *vst = nullptr;
  SwsContext *sws = nullptr;
  AVFrame *frame = nullptr, *conv = nullptr;
  AVPacket *pkt = nullptr;
  int vidx = -1;
  bool keep_chroma = false, flushing = false;
  bool neutral_chroma = false;  // cu/cv2 hold a GRAY8 frame's neutral fill
  AVRational fps = {30000, 1001};
  long w = 0, h = 0;
  std::vector<uint8_t> cy, cu, cv2;

  void open(const std::string &path) {
    keep_chroma =
        path.size() >= 4 && !path.compare(path.size() - 4, 4, ".y4m");
    fc = open_input(path);
    vidx = av_find_best_stream(fc, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (vidx < 0) die("no video stream in %s", path.c_str());
    dec = open_decoder(fc, vidx);
    vst = fc->streams[vidx];
    AVRational g = av_guess_frame_rate(fc, vst, nullptr);
    if (g.num > 0) fps = g;
    w = vst->codecpar->width;
    h = vst->codecpar->height;
    frame = av_frame_alloc();
    conv = av_frame_alloc();
    pkt = av_packet_alloc();
  }

  bool next(PlaneView *out) {
    while (true) {
      int rc = avcodec_receive_frame(dec, frame);
      if (rc == 0) return planeize(frame, out);
      if (rc == AVERROR_EOF) return false;
      if (rc != AVERROR(EAGAIN)) check(rc, "receive frame");
      if (flushing) return false;
      while (true) {
        int rr = av_read_frame(fc, pkt);
        if (rr < 0) {
          check(avcodec_send_packet(dec, nullptr), "flush decoder");
          flushing = true;
          break;
        }
        bool mine = pkt->stream_index == vidx;
        if (mine) check(avcodec_send_packet(dec, pkt), "send packet");
        av_packet_unref(pkt);
        if (mine) break;
      }
    }
  }

  bool planeize(AVFrame *f, PlaneView *out) {
    int fmt = f->format;
    bool as_is = keep_chroma &&
                 (fmt == AV_PIX_FMT_YUV420P || fmt == AV_PIX_FMT_YUV422P ||
                  fmt == AV_PIX_FMT_YUV444P || fmt == AV_PIX_FMT_GRAY8);
    if (fmt != AV_PIX_FMT_YUV420P && !as_is) {
      sws = sws_getCachedContext(sws, f->width, f->height, (AVPixelFormat)fmt,
                                 f->width, f->height, AV_PIX_FMT_YUV420P,
                                 SWS_BILINEAR, nullptr, nullptr, nullptr);
      av_frame_unref(conv);
      conv->format = AV_PIX_FMT_YUV420P;
      conv->width = f->width;
      conv->height = f->height;
      check(av_frame_get_buffer(conv, 0), "alloc conv frame");
      sws_scale(sws, f->data, f->linesize, 0, f->height, conv->data,
                conv->linesize);
      f = conv;
      fmt = AV_PIX_FMT_YUV420P;
    }
    long fh = f->height, fw = f->width, ch, cw;
    bool gray = fmt == AV_PIX_FMT_GRAY8;
    if (gray || fmt == AV_PIX_FMT_YUV444P) {
      ch = fh;
      cw = fw;
    } else if (fmt == AV_PIX_FMT_YUV422P) {
      ch = fh;
      cw = fw / 2;
    } else {
      ch = fh / 2;
      cw = fw / 2;
    }
    cy.resize((size_t)fh * fw);
    for (long r = 0; r < fh; r++)
      memcpy(&cy[r * fw], f->data[0] + (size_t)r * f->linesize[0], fw);
    if (gray) {
      // mono input: the Python loops fill full-res neutral chroma
      // (cli/tools.py `uf = np.full_like(yf, 128)`); refilled whenever the
      // buffers last held another frame's chroma, whatever its size
      if (!neutral_chroma || (long)cu.size() != fh * fw) {
        cu.assign((size_t)fh * fw, 128);
        cv2.assign((size_t)fh * fw, 128);
        neutral_chroma = true;
      }
    } else {
      neutral_chroma = false;
      cu.resize((size_t)ch * cw);
      cv2.resize((size_t)ch * cw);
      for (long r = 0; r < ch; r++) {
        memcpy(&cu[r * cw], f->data[1] + (size_t)r * f->linesize[1], cw);
        memcpy(&cv2[r * cw], f->data[2] + (size_t)r * f->linesize[2], cw);
      }
    }
    *out = {cy.data(), cu.data(), cv2.data(), fh, fw, ch, cw};
    return true;
  }

  void close() {
    av_packet_free(&pkt);
    av_frame_free(&frame);
    av_frame_free(&conv);
    sws_freeContext(sws);
    avcodec_free_context(&dec);
    avformat_close_input(&fc);
  }
};

// host/batching.hscale_consts + hostpix.scale_frame_to with the restore
// tools' bilinear chroma upsample (chroma="bilinear" — the reference's
// InputFile ingest is an SWS_BILINEAR resampler, ffmpeg_vhsled.cpp:318-323),
// consts cached on dims
struct Scaler {
  std::vector<int64_t> hx0, hx1, vx0, vx1, cux0, cux1, cvx0, cvx1;
  std::vector<float> hf, vf, cuf, cvf;
  int has_h = 0, has_v = 0, has_cu = 0, has_cv = 0;
  long sh = -1, sw = -1, dh = -1, dw = -1, cch = -1, ccw = -1;

  static void consts(long src, long dst, std::vector<int64_t> &x0,
                     std::vector<int64_t> &x1, std::vector<float> &f) {
    x0.resize(dst);
    x1.resize(dst);
    f.resize(dst);
    for (long i = 0; i < dst; i++) {
      double xs = ((double)i + 0.5) * (double)src / (double)dst - 0.5;
      int64_t a = (int64_t)std::floor(xs);
      if (a < 0) a = 0;
      if (a > src - 1) a = src - 1;
      x0[i] = a;
      x1[i] = a + 1 > src - 1 ? src - 1 : a + 1;
      f[i] = (float)(xs - (double)a);
    }
  }

  void run(const PlaneView &p, long dh_, long dw_, uint8_t *out) {
    if (sh != p.h || sw != p.w || dh != dh_ || dw != dw_ || cch != p.ch ||
        ccw != p.cw) {
      sh = p.h;
      sw = p.w;
      dh = dh_;
      dw = dw_;
      cch = p.ch;
      ccw = p.cw;
      has_h = sw != dw;
      has_v = sh != dh;
      has_cu = ccw != sw;
      has_cv = cch != sh;
      if (has_h) consts(sw, dw, hx0, hx1, hf);
      if (has_v) consts(sh, dh, vx0, vx1, vf);
      if (has_cu) consts(ccw, sw, cux0, cux1, cuf);
      if (has_cv) consts(cch, sh, cvx0, cvx1, cvf);
    }
    cvsim_scale_frame_bc_u8(p.y, p.u, p.v, p.h, p.w, p.ch, p.cw, dh_, dw_,
                            hx0.data(), hx1.data(), hf.data(), has_h,
                            vx0.data(), vx1.data(), vf.data(), has_v,
                            cux0.data(), cux1.data(), cuf.data(), has_cu,
                            cvx0.data(), cvx1.data(), cvf.data(), has_cv,
                            out);
  }

  // cli/tools._scale_underscan: render at (100-u)% size centered on black
  // (ffmpeg_vhsled.cpp:307-331)
  void run_underscan(const PlaneView &p, long W, long H, int underscan,
                     uint8_t *out, std::vector<uint8_t> &scratch) {
    if (underscan <= 0) {
      run(p, H, W, out);
      return;
    }
    int u = underscan > 99 ? 99 : underscan;
    long fw = (W * (100 - u)) / 100;
    if (fw < 1) fw = 1;
    long fh = (H * (100 - u)) / 100;
    if (fh < 1) fh = 1;
    scratch.resize((size_t)fh * fw * 3);
    run(p, fh, fw, scratch.data());
    memset(out, 0, (size_t)H * W * 3);
    long x0 = (W - fw) / 2, y0 = (H - fh) / 2;
    for (long r = 0; r < fh; r++)
      memcpy(out + ((y0 + r) * W + x0) * 3, scratch.data() + r * fw * 3,
             (size_t)fw * 3);
  }
};

// output sink: .y4m file byte-compatible with host/y4m.Y4MWriter, or the
// H.264 container encode shaped like cmd_encode's video side
struct Sink {
  bool is_y4m = false, is422 = false;
  long w = 0, h = 0, ch = 0, cw = 0;
  FILE *yf = nullptr;
  std::string path;
  AVFormatContext *oc = nullptr;
  AVCodecContext *vc = nullptr;
  AVStream *vs = nullptr;
  AVPacket *opkt = nullptr;
  AVFrame *vfr = nullptr;
  int64_t n = 0;
  std::vector<uint8_t> py, pu, pv;

  void open(const std::string &out, long w_, long h_, AVRational fps,
            bool is422_, const Args &a) {
    path = out;
    w = w_;
    h = h_;
    is422 = is422_;
    ch = is422 ? h : h / 2;
    cw = w / 2;
    is_y4m = out.size() >= 4 && !out.compare(out.size() - 4, 4, ".y4m");
    if (is_y4m) {
      yf = fopen(out.c_str(), "wb");
      if (!yf) die("cannot open %s", out.c_str());
      // byte-for-byte the header the Python tools write
      // (cli/tools._frame_loop_1to1 / run_frameblend)
      fprintf(yf, "YUV4MPEG2 W%ld H%ld F%d:%d Ip A4:3 C%s\n", w, h, fps.num,
              fps.den, is422 ? "422" : "420jpeg");
      py.resize((size_t)h * w);
      pu.resize((size_t)ch * cw);
      pv.resize((size_t)ch * cw);
      return;
    }
    check(avformat_alloc_output_context2(&oc, nullptr, nullptr, out.c_str()),
          "alloc output");
    const AVCodec *venc = avcodec_find_encoder_by_name("libx264");
    if (!venc) venc = avcodec_find_encoder(AV_CODEC_ID_H264);
    if (!venc) die("no H.264 encoder available");
    vc = avcodec_alloc_context3(venc);
    vc->width = w;
    vc->height = h;
    vc->pix_fmt = is422 ? AV_PIX_FMT_YUV422P : AV_PIX_FMT_YUV420P;
    vc->time_base = {fps.den, fps.num};
    vc->framerate = fps;
    vc->gop_size = 15;
    vc->max_b_frames = 0;
    vc->thread_count = 0;
    vc->sample_aspect_ratio = av_d2q(4.0 * h / (3.0 * w), 4096);
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
      vc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (a.vb > 0) {
      vc->bit_rate = a.vb;
    } else {
      char crfs[16];
      snprintf(crfs, sizeof crfs, "%d", a.crf);
      av_opt_set(vc->priv_data, "crf", crfs, 0);
      if (a.crf_max >= 0) {
        snprintf(crfs, sizeof crfs, "%d", a.crf_max);
        av_opt_set(vc->priv_data, "crf_max", crfs, 0);
      }
    }
    if (!a.preset.empty())
      av_opt_set(vc->priv_data, "preset", a.preset.c_str(), 0);
    check(avcodec_open2(vc, venc, nullptr), "open video encoder");
    vs = avformat_new_stream(oc, nullptr);
    check(avcodec_parameters_from_context(vs->codecpar, vc), "video params");
    vs->time_base = vc->time_base;
    vs->sample_aspect_ratio = vc->sample_aspect_ratio;
    vs->avg_frame_rate = vc->framerate;
    if (!(oc->oformat->flags & AVFMT_NOFILE))
      check(avio_open(&oc->pb, out.c_str(), AVIO_FLAG_WRITE), "open file");
    check(avformat_write_header(oc, nullptr), "write header");
    opkt = av_packet_alloc();
    vfr = av_frame_alloc();
    vfr->format = vc->pix_fmt;
    vfr->width = w;
    vfr->height = h;
    check(av_frame_get_buffer(vfr, 0), "alloc video frame");
  }

  void mux() {
    while (avcodec_receive_packet(vc, opkt) == 0) {
      av_packet_rescale_ts(opkt, vc->time_base, vs->time_base);
      opkt->stream_index = vs->index;
      check(av_interleaved_write_frame(oc, opkt), "write frame");
    }
  }

  // cli/tools._write_rgb: rgb->yuv601 with the chroma computed only at the
  // retained slice grid (420: u[0::2, 0::2]; 422: u[:, 0::2]) — identical
  // bytes, one strided pass straight into the AVFrame / Y4M plane buffers
  void write_rgb(const uint8_t *rgb) {
    if (is_y4m) {
      cvsim_rgb_to_yuv_sub_u8(rgb, h, w, is422, py.data(), w, pu.data(), cw,
                              pv.data(), cw);
      fputs("FRAME\n", yf);
      fwrite(py.data(), 1, (size_t)h * w, yf);
      fwrite(pu.data(), 1, (size_t)ch * cw, yf);
      fwrite(pv.data(), 1, (size_t)ch * cw, yf);
    } else {
      check(av_frame_make_writable(vfr), "frame writable");
      cvsim_rgb_to_yuv_sub_u8(rgb, h, w, is422, vfr->data[0],
                              vfr->linesize[0], vfr->data[1],
                              vfr->linesize[1], vfr->data[2],
                              vfr->linesize[2]);
      vfr->pts = n;
      check(avcodec_send_frame(vc, vfr), "send video frame");
      mux();
    }
    n++;
  }

  void finish() {
    if (is_y4m) {
      fclose(yf);
      return;
    }
    check(avcodec_send_frame(vc, nullptr), "flush video");
    mux();
    check(av_write_trailer(oc), "write trailer");
    fprintf(stderr, "cvsim-av: %lld frames -> %s\n", (long long)n,
            path.c_str());
    av_packet_free(&opkt);
    av_frame_free(&vfr);
    avcodec_free_context(&vc);
    if (!(oc->oformat->flags & AVFMT_NOFILE)) avio_closep(&oc->pb);
    avformat_free_context(oc);
  }
};

// models/restore.gamma_tables: the reference's 8-bit -> 13-bit
// linearization LUTs (frameblend.cpp:697-732)
void gamma_tables(double g, std::vector<int64_t> &dec,
                  std::vector<int64_t> &enc) {
  dec.resize(256);
  enc.resize(8193);
  for (int i = 0; i < 256; i++)
    dec[i] = (int64_t)(std::pow(i / 255.0, g) * 8192.0);
  for (int i = 0; i <= 8192; i++)
    enc[i] = (int64_t)(std::pow(i / 8192.0, 1.0 / g) * 255.0);
}

// The frameblend loop's time of source frame src_idx in output frames at
// the output rate or_num/or_den over the input rate fps_num/fps_den:
// float(src_idx * out_rate / fps) with exact Fractions, as
// cli/tools._run_frameblend_loop computes it, i.e. the quotient
// src_idx*or_num*fps_den / (or_den*fps_num) rounded once to the nearest
// double, ties to even. Both products are held exactly (256-bit unsigned
// magnitudes, so no int64 input overflows) and divided bit by bit. A zero
// denominator gives what the double division would (inf or nan).
namespace frame_time {

struct U256 {
  uint64_t w[4] = {0, 0, 0, 0};   // little-endian 64-bit limbs
};

// |a| * |b| * |c|
U256 mul3(uint64_t a, uint64_t b, uint64_t c) {
  const unsigned __int128 ab = (unsigned __int128)a * b;
  const unsigned __int128 lo = (unsigned __int128)(uint64_t)ab * c;
  const unsigned __int128 hi =
      (unsigned __int128)(uint64_t)(ab >> 64) * c + (uint64_t)(lo >> 64);
  U256 r;
  r.w[0] = (uint64_t)lo;
  r.w[1] = (uint64_t)hi;
  r.w[2] = (uint64_t)(hi >> 64);
  return r;
}

int bit_length(const U256 &x) {
  for (int k = 3; k >= 0; --k)
    if (x.w[k]) return 64 * k + 64 - __builtin_clzll(x.w[k]);
  return 0;
}

bool bit(const U256 &x, int i) { return (x.w[i / 64] >> (i % 64)) & 1; }

U256 shift_left(const U256 &x, int k) {   // 0 <= k < 256
  U256 r;
  const int limbs = k / 64, bits = k % 64;
  for (int i = 3; i >= limbs; --i) {
    r.w[i] = x.w[i - limbs] << bits;
    if (bits && i > limbs) r.w[i] |= x.w[i - limbs - 1] >> (64 - bits);
  }
  return r;
}

bool less(const U256 &a, const U256 &b) {
  for (int k = 3; k >= 0; --k)
    if (a.w[k] != b.w[k]) return a.w[k] < b.w[k];
  return false;
}

void subtract(U256 &a, const U256 &b) {   // a -= b, a >= b
  uint64_t borrow = 0;
  for (int k = 0; k < 4; ++k) {
    const uint64_t bk = b.w[k] + borrow;
    const uint64_t nb = (bk < borrow) || (a.w[k] < bk);
    a.w[k] -= bk;
    borrow = nb;
  }
}

uint64_t magnitude(int64_t v) { return v < 0 ? 0 - (uint64_t)v : (uint64_t)v; }

}  // namespace frame_time

double frameblend_time(int64_t src_idx, int64_t or_num, int64_t or_den,
                       int64_t fps_num, int64_t fps_den) {
  using namespace frame_time;
  const bool negative = (src_idx < 0) ^ (or_num < 0) ^ (fps_den < 0) ^
                        (or_den < 0) ^ (fps_num < 0);
  const U256 n = mul3(magnitude(src_idx), magnitude(or_num), magnitude(fps_den));
  const U256 d = mul3(magnitude(or_den), magnitude(fps_num), 1);
  const int bn = bit_length(n), bd = bit_length(d);
  if (bd == 0) return bn == 0 ? NAN : (negative ? -INFINITY : INFINITY);
  if (bn == 0) return 0.0;
  // q = floor(n * 2^s / d) in [2^54, 2^56): 53 bits, a rounding bit and
  // at least one more below it; the remainder is the sticky part
  const int s = 55 - (bn - bd);
  const U256 num = s > 0 ? shift_left(n, s) : n;
  const U256 den = s < 0 ? shift_left(d, -s) : d;
  U256 rem;
  uint64_t q = 0;
  for (int i = bit_length(num) - 1; i >= 0; --i) {
    rem = shift_left(rem, 1);
    if (bit(num, i)) rem.w[0] |= 1;
    q <<= 1;
    if (!less(rem, den)) {
      subtract(rem, den);
      q |= 1;
    }
  }
  const bool sticky = bit_length(rem) != 0;
  int drop = (64 - __builtin_clzll(q)) - 53;
  uint64_t mant = q >> drop;
  const uint64_t low = q & (((uint64_t)1 << drop) - 1);
  const uint64_t half = (uint64_t)1 << (drop - 1);
  if (low > half || (low == half && (sticky || (mant & 1)))) {
    if (++mant == (uint64_t)1 << 53) {
      mant >>= 1;
      ++drop;
    }
  }
  const double v = std::ldexp((double)mant, drop - s);
  return negative ? -v : v;
}

// models/restore.frameblend_weights (frameblend.cpp:929-1023), double
// arithmetic statement-for-statement with the Python implementation
long fb_weights(const std::deque<double> &frame_t, long long current,
                int framealt, bool ffa, bool squelch,
                std::vector<std::pair<long, int64_t>> &w16) {
  struct WEntry {
    long i;
    double w;
  };
  std::vector<WEntry> weights;
  long cutoff = 0;
  long n = (long)frame_t.size();
  double cur = (double)current;
  double span = ffa ? (double)framealt : 1.0;
  if (n > 1) {
    if (framealt > 1) {
      long i = (long)(current % framealt);
      while (i + framealt < n) {
        double bt = frame_t[i], et = frame_t[i + framealt];
        if (i != 0 && (et + 2.0) < cur) cutoff = i - (i % framealt);
        bt = std::min(std::max(bt, cur), cur + span);
        et = std::min(std::max(et, cur), cur + span);
        if (bt < et) weights.push_back({i, (et - bt) / span});
        i += framealt;
      }
    } else {
      for (long i = 0; i + 1 < n; i++) {
        double bt = frame_t[i], et = frame_t[i + 1];
        if (i != 0 && (et + 2.0) < cur) cutoff = i;
        bt = std::min(std::max(bt, cur), cur + 1.0);
        et = std::min(std::max(et, cur), cur + 1.0);
        if (bt < et) weights.push_back({i, et - bt});
      }
    }
  }
  if (weights.empty() && n > cutoff) weights.push_back({cutoff, 1.0});
  if (squelch && (weights.size() == 2 || weights.size() == 3)) {
    double bt = frame_t[weights[0].i];
    double et = frame_t[weights[1].i];
    double sq = std::fabs((et - bt) - 1.0) / 0.01;
    if (sq < 1.0) {
      sq = sq * sq;
      double w0 = weights[0].w;
      if (sq > 0.01) {
        w0 = std::min(w0, sq) / sq;
        weights[0].w = w0;
        weights[1].w = 1.0 - w0;
      } else {
        weights[0].w = 1.0;
        weights[1].w = 0.0;
      }
      if (weights.size() > 2) weights[2].w = 0.0;
    }
  }
  w16.clear();
  for (auto &e : weights)
    w16.emplace_back(e.i, (int64_t)std::floor(e.w * 65536.0 + 0.5));
  return cutoff;
}

int cmd_tool(const std::string &tool, const Args &a) {
  if (a.in.empty() || a.out.empty())
    die("%s needs -i and -o", tool.c_str());
  VDecoder dec;
  dec.open(a.in);
  long W = a.width > 0 ? a.width : dec.w;
  long H = a.height > 0 ? a.height : dec.h;
  bool is422 = a.pix == "422";
  AVRational out_fps = tool == "frameblend"
                           ? (AVRational){(int)a.or_num, (int)a.or_den}
                           : dec.fps;
  Sink sink;
  sink.open(a.out, W, H, out_fps, is422, a);

  std::vector<int64_t> gdec, genc;
  const int64_t *gd = nullptr, *ge = nullptr;
  // vhsled parses -gamma for flag parity but the reference's tables have
  // no callers there (cli/tools.run_vhsled)
  if (a.gamma > 1.0 && tool != "vhsled") {
    gamma_tables(a.gamma, gdec, genc);
    gd = gdec.data();
    ge = genc.data();
  }

  Scaler sc;
  std::vector<uint8_t> rgb((size_t)H * W * 3), out((size_t)H * W * 3);
  std::vector<uint8_t> uscr;

  if (tool == "vhsled") {
    PlaneView p;
    long n = 0;
    while (dec.next(&p)) {
      sc.run_underscan(p, W, H, a.underscan, rgb.data(), uscr);
      cvsim_vhsled_dejitter_u8(rgb.data(), H, W, out.data());
      sink.write_rgb(out.data());
      fprintf(stderr, "\x0dOutput frame %ld ", n);
      n++;
    }
    fprintf(stderr, "\n");
  } else if (tool == "filmac") {
    // per-frame block scan + asymmetric temporal level IIR
    // (filmac.cpp:886-1009 / models/restore.filmac_update_levels)
    bool init = false;
    int64_t sminv = 0, smaxv = 0;
    int64_t scaleto = (int64_t)0x10000 * (gd ? 8192 : 256);
    PlaneView p;
    long n = 0;
    while (dec.next(&p)) {
      sc.run_underscan(p, W, H, a.underscan, rgb.data(), uscr);
      int64_t minv, maxv;
      cvsim_filmac_measure_u8(rgb.data(), H, W, gd, &minv, &maxv);
      if (!init) {
        init = true;
        sminv = minv;
        smaxv = maxv;
      } else {
        smaxv = smaxv < maxv ? (smaxv + maxv) / 2 : (smaxv * 4 + maxv) / 5;
        sminv = sminv > minv ? (sminv + minv) / 2 : (sminv * 4 + minv) / 5;
      }
      cvsim_filmac_rescale_u8(rgb.data(), H, W, sminv, smaxv, scaleto, gd, ge,
                              out.data());
      sink.write_rgb(out.data());
      fprintf(stderr, "\x0dOutput frame %ld ", n);
      n++;
    }
    fprintf(stderr, "\n");
  } else {
    // frameblend: cli/tools._run_frameblend_loop.  frame_t entries are
    // float(src_idx * out_rate / fps) — exact rationals rounded once
    // (frameblend_time), at any input and output rate.
    int framealt = a.fa < 1 ? 1 : (a.fa > 8 ? 8 : a.fa);
    std::deque<std::unique_ptr<uint8_t[]>> frames;
    // recycle retired lookahead buffers: the deque holds ~40 frames and a
    // fresh multi-MB allocation per frame costs a page-fault pass
    std::vector<std::unique_ptr<uint8_t[]>> pool;
    std::deque<double> frame_t;
    long long src_idx = 0, current = 0;
    bool eof = false;
    while (true) {
      while (!eof &&
             (frame_t.empty() || frame_t.back() < (double)(current + 30))) {
        PlaneView p;
        if (!dec.next(&p)) {
          eof = true;
          break;
        }
        std::unique_ptr<uint8_t[]> buf;
        if (!pool.empty()) {
          buf = std::move(pool.back());
          pool.pop_back();
        } else {
          buf.reset(new uint8_t[(size_t)H * W * 3]);
        }
        sc.run_underscan(p, W, H, a.underscan, buf.get(), uscr);
        frames.push_back(std::move(buf));
        frame_t.push_back(frameblend_time(src_idx, a.or_num, a.or_den,
                                          dec.fps.num, dec.fps.den));
        src_idx++;
      }
      if (frames.empty() ||
          (eof && !frame_t.empty() &&
           (double)current > std::ceil(frame_t.back())))
        break;
      std::vector<std::pair<long, int64_t>> w16;
      long cutoff = fb_weights(frame_t, current, framealt, a.ffa, a.sqnr,
                               w16);
      std::vector<const uint8_t *> used;
      std::vector<int64_t> wv;
      for (auto &e : w16) {
        used.push_back(frames[e.first].get());
        wv.push_back(e.second);
      }
      cvsim_frameblend_mix_u8(used.data(), (long)used.size(), H, W,
                              wv.data(), gd, ge, out.data());
      sink.write_rgb(out.data());
      fprintf(stderr, "\x0dOutput frame %lld ", current);
      current++;
      if (cutoff > 0) {
        for (long j = 0; j < cutoff; j++)
          pool.push_back(std::move(frames[j]));
        frames.erase(frames.begin(), frames.begin() + cutoff);
        frame_t.erase(frame_t.begin(), frame_t.begin() + cutoff);
      }
      if (eof &&
          (double)current > (frame_t.empty() ? 0.0 : frame_t.back()) + 1.0)
        break;
    }
    fprintf(stderr, "\n");
  }
  sink.finish();
  dec.close();
  return 0;
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr,
            "usage: cvsim-av probe|decode|decode-audio|encode|"
            "vhsled|frameblend|filmac [flags]\n");
    return 2;
  }
  av_log_set_level(AV_LOG_ERROR);
  std::string cmd = argv[1];
  Args a = parse_args(argc - 2, argv + 2);
  if (cmd == "probe") return cmd_probe(a);
  if (cmd == "decode") return cmd_decode(a);
  if (cmd == "decode-audio") return cmd_decode_audio(a);
  if (cmd == "encode") return cmd_encode(a);
  if (cmd == "vhsled" || cmd == "frameblend" || cmd == "filmac")
    return cmd_tool(cmd, a);
  die("unknown command %s", cmd.c_str());
}
