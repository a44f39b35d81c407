// dmcnet_tpu_torch native codec front-end (the dmcnet_tpu decoder, built
// here as libcoviar_torch.so).
//
// CPU side of the codec layer: MPEG-4 (part 2) demux + entropy decode via
// FFmpeg libav*, exporting, per GOP, the decoded BGR frames and DENSE
// per-frame motion-vector maps.  Everything O(W*H*GOP) (back-tracing,
// residual accumulation) happens on the accelerator (ops/backtrace.py).
//
// Differences from the reference C extension
// (reference code/dmcnet/data_loader/coviar_data_loader.c), by design:
//   * the reference re-parses the file from byte 0 for EVERY load() call and
//     keeps the filename in a process-global (thread-unsafe); here a handle
//     owns all state (thread-safe by isolation), packets are demuxed once and
//     indexed by GOP, and a GOP is decoded exactly once for all its frames.
//   * demuxing goes through avformat (works for mp4/avi/raw), with a raw
//     elementary-stream parser fallback, instead of raw fopen only.
//   * also provides an MPEG-4 encoder entry point so tests can synthesize
//     real bitstreams without the ffmpeg CLI.
//
// Exposed as a plain C ABI consumed via ctypes (codec/mpeg4.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/motion_vector.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

namespace {

struct Packet {
  std::vector<uint8_t> data;
  int flags = 0;
};

struct Handle {
  // All demuxed video packets, in decode order, grouped by GOP.
  std::vector<Packet> packets;
  std::vector<int> gop_start;  // packet index of each GOP's keyframe
  std::vector<uint8_t> extradata;  // container-level decoder config (mp4)
  int width = 0;
  int height = 0;
  // Codec of the demuxed stream.  rgb/iframe decode works for ANY codec
  // libavcodec supports (matching the reference's cv2 `Video` class,
  // code/dmcnet_I3D/data/video_iterator.py:185-309); dense MV export is
  // only meaningful for codecs whose decoders export motion vectors
  // (MPEG-4 part 2 being the dmcnet contract).
  int codec_id = (int)AV_CODEC_ID_MPEG4;
  std::string error;
};

void set_error(Handle* h, const std::string& msg) { h->error = msg; }

// Demux every video packet into memory (videos here are ~1 MB re-encodes;
// trading memory for random GOP access is the whole point).
bool demux_all(Handle* h, const char* path) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) {
    set_error(h, std::string("avformat_open_input failed: ") + path);
    return false;
  }
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    set_error(h, "avformat_find_stream_info failed");
    return false;
  }
  int vstream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vstream < 0) {
    avformat_close_input(&fmt);
    set_error(h, "no video stream");
    return false;
  }
  AVCodecParameters* par = fmt->streams[vstream]->codecpar;
  h->width = par->width;
  h->height = par->height;
  if (par->codec_id != AV_CODEC_ID_NONE) h->codec_id = (int)par->codec_id;
  if (par->extradata && par->extradata_size > 0) {
    h->extradata.assign(par->extradata,
                        par->extradata + par->extradata_size);
  }

  AVPacket* pkt = av_packet_alloc();
  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == vstream && pkt->size > 0) {
      Packet p;
      p.data.assign(pkt->data, pkt->data + pkt->size);
      p.flags = pkt->flags;
      if (pkt->flags & AV_PKT_FLAG_KEY) h->gop_start.push_back((int)h->packets.size());
      h->packets.push_back(std::move(p));
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  avformat_close_input(&fmt);
  if (h->packets.empty()) {
    set_error(h, "no video packets");
    return false;
  }
  if (h->gop_start.empty()) h->gop_start.push_back(0);
  return true;
}

// Rasterize one frame's exported motion vectors into a dense (H, W, 2) int16
// map — the same per-block, boundary-clipped write the reference performs
// (coviar_data_loader.c:88-124), in the same iteration order so overlapping
// blocks resolve identically.
void rasterize(const AVMotionVector* mvs, int n, int width, int height,
               int16_t* out /* zeroed (H, W, 2) */) {
  for (int i = 0; i < n; ++i) {
    const AVMotionVector* mv = &mvs[i];
    int val_x = mv->dst_x - mv->src_x;
    int val_y = mv->dst_y - mv->src_y;
    if (val_x == 0 && val_y == 0) continue;
    for (int x_start = -mv->w / 2; x_start < mv->w / 2; ++x_start) {
      for (int y_start = -mv->h / 2; y_start < mv->h / 2; ++y_start) {
        int p_dst_x = mv->dst_x + x_start;
        int p_dst_y = mv->dst_y + y_start;
        int p_src_x = mv->src_x + x_start;
        int p_src_y = mv->src_y + y_start;
        if (p_dst_y >= 0 && p_dst_y < height && p_dst_x >= 0 && p_dst_x < width &&
            p_src_y >= 0 && p_src_y < height && p_src_x >= 0 && p_src_x < width) {
          out[(p_dst_y * width + p_dst_x) * 2 + 0] = (int16_t)val_x;
          out[(p_dst_y * width + p_dst_x) * 2 + 1] = (int16_t)val_y;
        }
      }
    }
  }
}

struct Decoder {
  AVCodecContext* ctx = nullptr;
  SwsContext* sws = nullptr;

  bool init(int export_mvs, int codec_id,
            const std::vector<uint8_t>& extradata = {}) {
    const AVCodec* codec = avcodec_find_decoder((AVCodecID)codec_id);
    if (!codec) return false;
    ctx = avcodec_alloc_context3(codec);
    if (!ctx) return false;
    if (!extradata.empty()) {
      // mp4-style containers carry the VOL header out of band.
      ctx->extradata = (uint8_t*)av_mallocz(
          extradata.size() + AV_INPUT_BUFFER_PADDING_SIZE);
      std::memcpy(ctx->extradata, extradata.data(), extradata.size());
      ctx->extradata_size = (int)extradata.size();
    }
    AVDictionary* opts = nullptr;
    if (export_mvs) av_dict_set(&opts, "flags2", "+export_mvs", 0);
    int ret = avcodec_open2(ctx, codec, &opts);
    av_dict_free(&opts);
    return ret >= 0;
  }

  ~Decoder() {
    if (sws) sws_freeContext(sws);
    if (ctx) avcodec_free_context(&ctx);
  }

  // Convert a decoded frame to tightly packed BGR24 into `dst`.
  void to_bgr(const AVFrame* frame, uint8_t* dst) {
    sws = sws_getCachedContext(sws, frame->width, frame->height,
                               (AVPixelFormat)frame->format, frame->width,
                               frame->height, AV_PIX_FMT_BGR24, SWS_BICUBIC,
                               nullptr, nullptr, nullptr);
    uint8_t* dst_data[4] = {dst, nullptr, nullptr, nullptr};
    int dst_linesize[4] = {frame->width * 3, 0, 0, 0};
    sws_scale(sws, frame->data, frame->linesize, 0, frame->height, dst_data,
              dst_linesize);
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Handle lifecycle
// ---------------------------------------------------------------------------

void* cv_open(const char* path) {
  auto* h = new Handle();
  if (!demux_all(h, path)) {
    // Keep the handle so the caller can read the error, but mark it bad by
    // leaving packets empty.
  }
  return h;
}

void cv_close(void* handle) { delete static_cast<Handle*>(handle); }

const char* cv_error(void* handle) {
  return static_cast<Handle*>(handle)->error.c_str();
}

int cv_ok(void* handle) {
  return static_cast<Handle*>(handle)->packets.empty() ? 0 : 1;
}

int cv_width(void* handle) { return static_cast<Handle*>(handle)->width; }
int cv_height(void* handle) { return static_cast<Handle*>(handle)->height; }

// libavcodec AVCodecID of the demuxed stream (rgb decode is codec-generic;
// callers gate MV semantics on this — AV_CODEC_ID_MPEG4 == 12).
int cv_codec_id(void* handle) {
  return static_cast<Handle*>(handle)->codec_id;
}

// Packet count == frame count for the no-B-frame MPEG-4 streams this targets,
// matching the reference's parser-packet counting (coviar_data_loader.c:486).
int cv_num_frames(void* handle) {
  return (int)static_cast<Handle*>(handle)->packets.size();
}

int cv_num_gops(void* handle) {
  return (int)static_cast<Handle*>(handle)->gop_start.size();
}

// Number of frames (packets) in one GOP.
int cv_gop_len(void* handle, int gop) {
  auto* h = static_cast<Handle*>(handle);
  if (gop < 0 || gop >= (int)h->gop_start.size()) return 0;
  int begin = h->gop_start[gop];
  int end = (gop + 1 < (int)h->gop_start.size()) ? h->gop_start[gop + 1]
                                                 : (int)h->packets.size();
  return end - begin;
}

// Decode one GOP: fills `frames_bgr` (max_frames, H, W, 3) uint8 and
// `mv_maps` (max_frames, H, W, 2) int16 (zero-filled by callee), returns the
// number of frames decoded (<= max_frames), or -1 on error.
// When `blocks` is non-null it also exports the raw motion-vector block
// list per frame: (max_frames, max_blocks, 6) int32 rows of
// [src_x, src_y, dst_x, dst_y, w, h] (block centres, like AVMotionVector),
// with per-frame counts in `n_blocks` — the input format of the GPU
// back-tracing kernel (ops/backtrace.py).
static int decode_gop_impl(void* handle, int gop, uint8_t* frames_bgr,
                           int16_t* mv_maps, int max_frames, int32_t* blocks,
                           int32_t* n_blocks, int max_blocks,
                           const uint8_t* keep);

int cv_decode_gop(void* handle, int gop, uint8_t* frames_bgr, int16_t* mv_maps,
                  int max_frames) {
  return decode_gop_impl(handle, gop, frames_bgr, mv_maps, max_frames,
                         nullptr, nullptr, 0, nullptr);
}

int cv_decode_gop_blocks(void* handle, int gop, uint8_t* frames_bgr,
                         int16_t* mv_maps, int max_frames, int32_t* blocks,
                         int32_t* n_blocks, int max_blocks) {
  return decode_gop_impl(handle, gop, frames_bgr, mv_maps, max_frames,
                         blocks, n_blocks, max_blocks, nullptr);
}

// Like cv_decode_gop_blocks, but converts only frames with keep[i] != 0 to
// BGR (others stay zero).  Every frame is still ENTROPY-decoded — P-frame
// reconstruction is sequential — but the YUV->BGR sws_scale, a material
// share of per-GOP host time, is skipped for frames the caller discards
// (the device back-trace path ships only the I-frame + picked frames).
// `keep` may be null (= keep all).  MV side data is exported for every
// frame regardless: motion drives the on-device accumulate recursion.
int cv_decode_gop_blocks_keep(void* handle, int gop, uint8_t* frames_bgr,
                              int16_t* mv_maps, int max_frames,
                              int32_t* blocks, int32_t* n_blocks,
                              int max_blocks, const uint8_t* keep) {
  return decode_gop_impl(handle, gop, frames_bgr, mv_maps, max_frames,
                         blocks, n_blocks, max_blocks, keep);
}

static int decode_gop_impl(void* handle, int gop, uint8_t* frames_bgr,
                           int16_t* mv_maps, int max_frames, int32_t* blocks,
                           int32_t* n_blocks, int max_blocks,
                           const uint8_t* keep) {
  auto* h = static_cast<Handle*>(handle);
  if (!cv_ok(handle) || gop < 0 || gop >= (int)h->gop_start.size()) return -1;
  int begin = h->gop_start[gop];
  int end = (gop + 1 < (int)h->gop_start.size()) ? h->gop_start[gop + 1]
                                                 : (int)h->packets.size();

  Decoder dec;
  if (!dec.init(/*export_mvs=*/1, h->codec_id, h->extradata)) {
    set_error(h, "decoder init failed");
    return -1;
  }

  const size_t frame_px = (size_t)h->width * h->height;
  std::memset(frames_bgr, 0, (size_t)max_frames * frame_px * 3);
  // mv_maps may be null: block-list consumers (device-side back-tracing)
  // skip the dense per-pixel rasterization entirely — it is pure host cost
  // they re-derive on the accelerator.
  if (mv_maps)
    std::memset(mv_maps, 0,
                (size_t)max_frames * frame_px * 2 * sizeof(int16_t));
  if (blocks) {
    std::memset(blocks, 0,
                (size_t)max_frames * max_blocks * 6 * sizeof(int32_t));
    std::memset(n_blocks, 0, (size_t)max_frames * sizeof(int32_t));
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int out_idx = 0;

  auto drain = [&](bool flush) -> bool {
    while (true) {
      int ret = avcodec_receive_frame(dec.ctx, frame);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return true;
      if (ret < 0) return false;
      if (out_idx < max_frames) {
        if (!keep || keep[out_idx])
          dec.to_bgr(frame, frames_bgr + (size_t)out_idx * frame_px * 3);
        AVFrameSideData* sd =
            av_frame_get_side_data(frame, AV_FRAME_DATA_MOTION_VECTORS);
        if (sd) {
          const AVMotionVector* mvs = (const AVMotionVector*)sd->data;
          int n = (int)(sd->size / sizeof(AVMotionVector));
          if (mv_maps)
            rasterize(mvs, n, h->width, h->height,
                      mv_maps + (size_t)out_idx * frame_px * 2);
          if (blocks) {
            int count = 0;
            int32_t* row = blocks + (size_t)out_idx * max_blocks * 6;
            for (int i = 0; i < n && count < max_blocks; ++i) {
              if (mvs[i].dst_x == mvs[i].src_x &&
                  mvs[i].dst_y == mvs[i].src_y)
                continue;  // zero motion: skipped by the reference (c:92)
              row[count * 6 + 0] = mvs[i].src_x;
              row[count * 6 + 1] = mvs[i].src_y;
              row[count * 6 + 2] = mvs[i].dst_x;
              row[count * 6 + 3] = mvs[i].dst_y;
              row[count * 6 + 4] = mvs[i].w;
              row[count * 6 + 5] = mvs[i].h;
              ++count;
            }
            n_blocks[out_idx] = count;
          }
        } else if (blocks) {
          n_blocks[out_idx] = 0;
        }
      }
      ++out_idx;
      av_frame_unref(frame);
      (void)flush;
    }
  };

  bool ok = true;
  for (int p = begin; p < end && ok; ++p) {
    pkt->data = h->packets[p].data.data();
    pkt->size = (int)h->packets[p].data.size();
    if (avcodec_send_packet(dec.ctx, pkt) < 0) ok = false;
    if (ok) ok = drain(false);
  }
  if (ok) {
    avcodec_send_packet(dec.ctx, nullptr);  // flush
    ok = drain(true);
  }

  av_frame_free(&frame);
  pkt->data = nullptr;
  pkt->size = 0;
  av_packet_free(&pkt);
  if (!ok) {
    set_error(h, "decode error");
    return -1;
  }
  return out_idx < max_frames ? out_idx : max_frames;
}

// ---------------------------------------------------------------------------
// Test-support encoder: raw BGR frames -> MPEG-4 (part 2) .avi
// ---------------------------------------------------------------------------

static int encode_impl(const char* path, const AVCodec* codec,
                       const uint8_t* frames_bgr, int num_frames, int height,
                       int width, int gop_size, int64_t bit_rate,
                       const char* container) {
  if (!codec) return -1;
  // Codec-native pixel format (e.g. mjpeg wants YUVJ420P).
  const AVPixelFormat pix =
      codec->pix_fmts ? codec->pix_fmts[0] : AV_PIX_FMT_YUV420P;

  AVFormatContext* fmt = nullptr;
  // container "m4v" writes the raw MPEG-4 elementary stream (what the
  // reference's bitstream-parsing loader expects, coviar_data_loader.c:235).
  if (avformat_alloc_output_context2(
          &fmt, nullptr, container ? container : "avi", path) < 0)
    return -2;
  AVStream* stream = avformat_new_stream(fmt, nullptr);

  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  ctx->width = width;
  ctx->height = height;
  ctx->pix_fmt = pix;
  ctx->time_base = AVRational{1, 25};
  ctx->gop_size = gop_size;
  ctx->max_b_frames = 0;
  ctx->bit_rate = bit_rate;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(ctx, codec, nullptr) < 0) return -3;
  avcodec_parameters_from_context(stream->codecpar, ctx);
  stream->time_base = ctx->time_base;

  if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  }
  if (avformat_write_header(fmt, nullptr) < 0) return -5;

  SwsContext* sws = sws_getContext(width, height, AV_PIX_FMT_BGR24, width,
                                   height, pix, SWS_BICUBIC,
                                   nullptr, nullptr, nullptr);
  AVFrame* frame = av_frame_alloc();
  frame->format = pix;
  frame->width = width;
  frame->height = height;
  av_frame_get_buffer(frame, 0);
  AVPacket* pkt = av_packet_alloc();

  auto write_out = [&]() -> bool {
    while (true) {
      int ret = avcodec_receive_packet(ctx, pkt);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return true;
      if (ret < 0) return false;
      av_packet_rescale_ts(pkt, ctx->time_base, stream->time_base);
      pkt->stream_index = stream->index;
      if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
    }
  };

  int rc = 0;
  for (int t = 0; t < num_frames && rc == 0; ++t) {
    av_frame_make_writable(frame);
    const uint8_t* src_data[4] = {
        frames_bgr + (size_t)t * width * height * 3, nullptr, nullptr, nullptr};
    int src_linesize[4] = {width * 3, 0, 0, 0};
    sws_scale(sws, src_data, src_linesize, 0, height, frame->data,
              frame->linesize);
    frame->pts = t;
    if (avcodec_send_frame(ctx, frame) < 0 || !write_out()) rc = -6;
  }
  if (rc == 0) {
    avcodec_send_frame(ctx, nullptr);
    if (!write_out()) rc = -7;
  }
  av_write_trailer(fmt);

  av_packet_free(&pkt);
  av_frame_free(&frame);
  sws_freeContext(sws);
  avcodec_free_context(&ctx);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}

int cv_encode_mpeg4_fmt(const char* path, const uint8_t* frames_bgr,
                        int num_frames, int height, int width, int gop_size,
                        int64_t bit_rate, const char* container) {
  return encode_impl(path, avcodec_find_encoder(AV_CODEC_ID_MPEG4),
                     frames_bgr, num_frames, height, width, gop_size,
                     bit_rate, container);
}

// Encode with any named libavcodec encoder (e.g. "mpeg2video", "mjpeg",
// "libx264" where present) — used by tests to synthesize non-MPEG4 clips so
// the codec-generic rgb decode path is exercised without the ffmpeg CLI.
int cv_encode_named(const char* path, const char* codec_name,
                    const uint8_t* frames_bgr, int num_frames, int height,
                    int width, int gop_size, int64_t bit_rate,
                    const char* container) {
  return encode_impl(path, avcodec_find_encoder_by_name(codec_name),
                     frames_bgr, num_frames, height, width, gop_size,
                     bit_rate, container);
}

int cv_encode_mpeg4(const char* path, const uint8_t* frames_bgr,
                    int num_frames, int height, int width, int gop_size,
                    int64_t bit_rate) {
  return cv_encode_mpeg4_fmt(path, frames_bgr, num_frames, height, width,
                             gop_size, bit_rate, nullptr);
}

// ---------------------------------------------------------------------------
// Validate one GOP's MV block lists against the GPU back-trace kernel's
// cell-uniform contract and scatter them into a per-cell grid — the native
// twin of ops/backtrace.cell_mv_from_blocks's per-frame loop (the
// numpy version remains the executable spec + fallback and the two are
// A/B'd in tests).  Returns 1 when every block is cell-aligned, in-bounds
// and |mv| <= max_mv (grid filled), 0 to disqualify (caller retries at a
// smaller cell or falls back to the dense host path).
// `grid` is a zeroed (t, height/cell, width/cell, 2) int32 buffer.
int cv_cells_from_blocks(const int32_t* blocks /* (t,max_blocks,6) */,
                         const int32_t* n_blocks /* (t,) */, int t_len,
                         int max_blocks, int height, int width, int cell,
                         int max_mv, int32_t* grid) {
  if (cell <= 0 || height % cell || width % cell) return 0;
  const int ncx = width / cell;
  const int ncy = height / cell;
  for (int t = 0; t < t_len; ++t) {
    const int32_t* rows = blocks + (size_t)t * max_blocks * 6;
    int32_t* g = grid + (size_t)t * ncy * ncx * 2;
    const int n = n_blocks[t];
    if (n > max_blocks) return 0;  // out-of-contract caller: disqualify,
                                   // never read past the row buffer
    for (int i = 0; i < n; ++i) {
      const int32_t* b = rows + (size_t)i * 6;
      const int bw = b[4], bh = b[5];
      const int x0 = b[2] - bw / 2, y0 = b[3] - bh / 2;
      const int vx = b[2] - b[0], vy = b[3] - b[1];
      if (vx > max_mv || vx < -max_mv || vy > max_mv || vy < -max_mv ||
          bw % cell || bh % cell || x0 % cell || y0 % cell || x0 < 0 ||
          y0 < 0 || x0 + bw > width || y0 + bh > height)
        return 0;
      const int cx = x0 / cell, cy = y0 / cell;
      for (int dy = 0; dy < bh / cell; ++dy)
        for (int dx = 0; dx < bw / cell; ++dx) {
          int32_t* cellp = g + (((size_t)(cy + dy) * ncx) + (cx + dx)) * 2;
          cellp[0] = vx;
          cellp[1] = vy;
        }
    }
  }
  return 1;
}

// Host-side fused accumulation (data-loader workers).
// Same semantics as the device kernels (dense-map formulation of
// coviar_data_loader.c:88-175): per frame, accu_src[p] = accu_src_old[p-mv]
// where valid, then mv_out = identity - accu_src and residual =
// frame - iframe[accu_src].  ~10-20x the vectorized NumPy fallback.
// ---------------------------------------------------------------------------

void cv_accumulate_gop(const int16_t* mv_maps /* (T,H,W,2) */,
                       const uint8_t* frames /* (T,H,W,3) */, int t_len,
                       int height, int width, int accumulate,
                       int32_t* mv_out /* (T,H,W,2) */,
                       int32_t* res_out /* (T,H,W,3) */) {
  const size_t px = (size_t)height * width;
  std::vector<int32_t> cur(px * 2), prev(px * 2);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      prev[(y * (size_t)width + x) * 2 + 0] = x;
      prev[(y * (size_t)width + x) * 2 + 1] = y;
    }
  std::memset(mv_out, 0, px * 2 * sizeof(int32_t));
  std::memset(res_out, 0, px * 3 * sizeof(int32_t));
  const uint8_t* base = frames;  // I-frame
  for (int t = 1; t < t_len; ++t) {
    const int16_t* mv_t = mv_maps + (size_t)t * px * 2;
    int32_t* mv_o = mv_out + (size_t)t * px * 2;
    int32_t* res_o = res_out + (size_t)t * px * 3;
    const uint8_t* frame_t = frames + (size_t)t * px * 3;
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        size_t i = (size_t)y * width + x;
        int sx = x - mv_t[i * 2 + 0];
        int sy = y - mv_t[i * 2 + 1];
        if (sx < 0) sx = 0; else if (sx >= width) sx = width - 1;
        if (sy < 0) sy = 0; else if (sy >= height) sy = height - 1;
        size_t si = (size_t)sy * width + sx;
        int ax, ay;
        if (accumulate) {
          ax = prev[si * 2 + 0];
          ay = prev[si * 2 + 1];
          cur[i * 2 + 0] = ax;
          cur[i * 2 + 1] = ay;
          mv_o[i * 2 + 0] = x - ax;
          mv_o[i * 2 + 1] = y - ay;
        } else {
          ax = sx;
          ay = sy;
          mv_o[i * 2 + 0] = mv_t[i * 2 + 0];
          mv_o[i * 2 + 1] = mv_t[i * 2 + 1];
        }
        const uint8_t* ref_frame =
            accumulate ? base : frames + (size_t)(t - 1) * px * 3;
        size_t ri = ((size_t)ay * width + ax) * 3;
        res_o[i * 3 + 0] = (int32_t)frame_t[i * 3 + 0] - ref_frame[ri + 0];
        res_o[i * 3 + 1] = (int32_t)frame_t[i * 3 + 1] - ref_frame[ri + 1];
        res_o[i * 3 + 2] = (int32_t)frame_t[i * 3 + 2] - ref_frame[ri + 2];
      }
    }
    if (accumulate) std::swap(cur, prev);
  }
}

// uint8-encoded variant for the data loader: emits the reference's encoded
// representation directly (mv: optional min-max scale (trunc toward zero,
// matching numpy astype) then +128 clip; residual: +128 clip;
// dataset.py:195-213), eliminating all GIL-bound NumPy post-processing and
// shrinking GOP caches 4x.  minmax_scale <= 0 disables the mv scaling.
void cv_accumulate_gop_u8(const int16_t* mv_maps, const uint8_t* frames,
                          int t_len, int height, int width, int accumulate,
                          double minmax_scale, uint8_t* mv_u8 /* (T,H,W,2) */,
                          uint8_t* res_u8 /* (T,H,W,3) */) {
  const size_t px = (size_t)height * width;
  std::vector<int32_t> cur(px * 2), prev(px * 2);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      prev[(y * (size_t)width + x) * 2 + 0] = x;
      prev[(y * (size_t)width + x) * 2 + 1] = y;
    }
  auto clip_u8 = [](int v) -> uint8_t {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  std::memset(mv_u8, 128, px * 2);
  std::memset(res_u8, 128, px * 3);
  const uint8_t* base = frames;
  for (int t = 1; t < t_len; ++t) {
    const int16_t* mv_t = mv_maps + (size_t)t * px * 2;
    uint8_t* mv_o = mv_u8 + (size_t)t * px * 2;
    uint8_t* res_o = res_u8 + (size_t)t * px * 3;
    const uint8_t* frame_t = frames + (size_t)t * px * 3;
    const uint8_t* ref_frame =
        accumulate ? base : frames + (size_t)(t - 1) * px * 3;
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        size_t i = (size_t)y * width + x;
        int sx = x - mv_t[i * 2 + 0];
        int sy = y - mv_t[i * 2 + 1];
        if (sx < 0) sx = 0; else if (sx >= width) sx = width - 1;
        if (sy < 0) sy = 0; else if (sy >= height) sy = height - 1;
        size_t si = (size_t)sy * width + sx;
        int ax, ay, vx, vy;
        if (accumulate) {
          ax = prev[si * 2 + 0];
          ay = prev[si * 2 + 1];
          cur[i * 2 + 0] = ax;
          cur[i * 2 + 1] = ay;
          vx = x - ax;
          vy = y - ay;
        } else {
          ax = sx;
          ay = sy;
          vx = mv_t[i * 2 + 0];
          vy = mv_t[i * 2 + 1];
        }
        if (minmax_scale > 0) {
          vx = (int)(vx * minmax_scale);  // trunc toward zero = np astype
          vy = (int)(vy * minmax_scale);
        }
        mv_o[i * 2 + 0] = clip_u8(vx + 128);
        mv_o[i * 2 + 1] = clip_u8(vy + 128);
        size_t ri = ((size_t)ay * width + ax) * 3;
        res_o[i * 3 + 0] = clip_u8((int)frame_t[i * 3 + 0] - ref_frame[ri + 0] + 128);
        res_o[i * 3 + 1] = clip_u8((int)frame_t[i * 3 + 1] - ref_frame[ri + 1] + 128);
        res_o[i * 3 + 2] = clip_u8((int)frame_t[i * 3 + 2] - ref_frame[ri + 2] + 128);
      }
    }
    if (accumulate) std::swap(cur, prev);
  }
}

// ---------------------------------------------------------------------------
// Dataset-prep transcoder: any input -> MPEG-4 part 2, scaled, fixed GOP.
// Replaces the reference's ffmpeg-CLI re-encode step
// (code/dmcnet_I3D/dataset/HMDB51/scripts/convert_videos.py:55 —
//  `-c:v mpeg4 -filter:v scale=...:360 -b:v 640k -an`).
// ---------------------------------------------------------------------------

int cv_transcode(const char* in_path, const char* out_path, int target_height,
                 int gop_size, int64_t bit_rate) {
  AVFormatContext* infmt = nullptr;
  if (avformat_open_input(&infmt, in_path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(infmt, nullptr) < 0) {
    avformat_close_input(&infmt);
    return -1;
  }
  int vstream = av_find_best_stream(infmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                    nullptr, 0);
  if (vstream < 0) {
    avformat_close_input(&infmt);
    return -1;
  }
  AVCodecParameters* par = infmt->streams[vstream]->codecpar;
  const AVCodec* dec_codec = avcodec_find_decoder(par->codec_id);
  AVCodecContext* dec = avcodec_alloc_context3(dec_codec);
  avcodec_parameters_to_context(dec, par);
  if (avcodec_open2(dec, dec_codec, nullptr) < 0) {
    avcodec_free_context(&dec);
    avformat_close_input(&infmt);
    return -2;
  }

  int out_h = target_height > 0 ? target_height : par->height;
  int out_w = (int)((int64_t)par->width * out_h / par->height) / 2 * 2;

  // Output: reuse the encoder configuration of cv_encode_mpeg4, streaming.
  const AVCodec* enc_codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  AVFormatContext* outfmt = nullptr;
  avformat_alloc_output_context2(&outfmt, nullptr, nullptr, out_path);
  if (!outfmt)
    avformat_alloc_output_context2(&outfmt, nullptr, "avi", out_path);
  AVStream* stream = avformat_new_stream(outfmt, nullptr);
  AVCodecContext* enc = avcodec_alloc_context3(enc_codec);
  enc->width = out_w;
  enc->height = out_h;
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  enc->time_base = AVRational{1, 25};
  enc->gop_size = gop_size;
  enc->max_b_frames = 0;
  enc->bit_rate = bit_rate;
  if (outfmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, enc_codec, nullptr) < 0) return -3;
  avcodec_parameters_from_context(stream->codecpar, enc);
  stream->time_base = enc->time_base;
  if (!(outfmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&outfmt->pb, out_path, AVIO_FLAG_WRITE) < 0) return -4;
  }
  if (avformat_write_header(outfmt, nullptr) < 0) return -5;

  SwsContext* sws = nullptr;
  AVFrame* dframe = av_frame_alloc();
  AVFrame* eframe = av_frame_alloc();
  eframe->format = AV_PIX_FMT_YUV420P;
  eframe->width = out_w;
  eframe->height = out_h;
  av_frame_get_buffer(eframe, 0);
  AVPacket* pkt = av_packet_alloc();
  AVPacket* opkt = av_packet_alloc();
  int64_t pts = 0;
  int rc = 0;

  auto flush_enc = [&]() -> bool {
    while (true) {
      int ret = avcodec_receive_packet(enc, opkt);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return true;
      if (ret < 0) return false;
      av_packet_rescale_ts(opkt, enc->time_base, stream->time_base);
      opkt->stream_index = stream->index;
      if (av_interleaved_write_frame(outfmt, opkt) < 0) return false;
    }
  };

  auto consume_decoded = [&]() -> bool {
    while (true) {
      int ret = avcodec_receive_frame(dec, dframe);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return true;
      if (ret < 0) return false;
      sws = sws_getCachedContext(sws, dframe->width, dframe->height,
                                 (AVPixelFormat)dframe->format, out_w, out_h,
                                 AV_PIX_FMT_YUV420P, SWS_BICUBIC, nullptr,
                                 nullptr, nullptr);
      av_frame_make_writable(eframe);
      sws_scale(sws, dframe->data, dframe->linesize, 0, dframe->height,
                eframe->data, eframe->linesize);
      eframe->pts = pts++;
      if (avcodec_send_frame(enc, eframe) < 0 || !flush_enc()) return false;
      av_frame_unref(dframe);
    }
  };

  while (rc == 0 && av_read_frame(infmt, pkt) >= 0) {
    if (pkt->stream_index == vstream) {
      if (avcodec_send_packet(dec, pkt) >= 0) {
        if (!consume_decoded()) rc = -6;
      }
    }
    av_packet_unref(pkt);
  }
  if (rc == 0) {
    avcodec_send_packet(dec, nullptr);
    if (!consume_decoded()) rc = -6;
    avcodec_send_frame(enc, nullptr);
    if (!flush_enc()) rc = -7;
  }
  av_write_trailer(outfmt);

  av_packet_free(&pkt);
  av_packet_free(&opkt);
  av_frame_free(&dframe);
  av_frame_free(&eframe);
  if (sws) sws_freeContext(sws);
  avcodec_free_context(&dec);
  avcodec_free_context(&enc);
  if (!(outfmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&outfmt->pb);
  avformat_free_context(outfmt);
  avformat_close_input(&infmt);
  return rc;
}

}  // extern "C"
