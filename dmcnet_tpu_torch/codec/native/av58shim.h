/* av58shim.h — maps the avcodec-58-era API surface used by the REFERENCE
 * CoViAR loader (compiled straight from the reference sources at test time; the
 * reference source is never copied into this repository) onto the libav 59
 * headers present here, so `tests/test_reference_ab.py` can A/B the
 * original decoder against codec/coviar_compat on real encoded clips.
 *
 * Shimmed symbols (all removed in libavcodec 59):
 *   avcodec_register_all()            -> no-op (registration is implicit)
 *   AVPicture / avpicture_get_size /  -> av_image_* equivalents with the
 *   avpicture_fill                       historical align=1
 *   avcodec_decode_video2             -> send_packet/receive_frame pair
 */
#ifndef DMCNET_AV58_SHIM_H
#define DMCNET_AV58_SHIM_H

#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/error.h>

#define avcodec_register_all() ((void)0)

/* Old AVPicture layout == the leading members of AVFrame, which is how the
 * reference uses it (casting AVFrame* to AVPicture*). */
typedef struct AVPicture {
    uint8_t *data[AV_NUM_DATA_POINTERS];
    int linesize[AV_NUM_DATA_POINTERS];
} AVPicture;

static inline int avpicture_get_size(enum AVPixelFormat pix_fmt,
                                     int width, int height) {
    return av_image_get_buffer_size(pix_fmt, width, height, 1);
}

static inline int avpicture_fill(AVPicture *picture, const uint8_t *ptr,
                                 enum AVPixelFormat pix_fmt,
                                 int width, int height) {
    return av_image_fill_arrays(picture->data, picture->linesize, ptr,
                                pix_fmt, width, height, 1);
}

/* One-in/one-out decode emulation.  MPEG-4 part 2 without B-frames has no
 * decoder delay, so each sent packet yields at most one frame, matching the
 * old API's behaviour for this codec.  A zero-size packet drains (the
 * reference's flush loop sends empty packets until !got_picture). */
static inline int avcodec_decode_video2(AVCodecContext *avctx, AVFrame *frame,
                                        int *got_picture_ptr,
                                        const AVPacket *avpkt) {
    int ret;
    *got_picture_ptr = 0;
    ret = avcodec_send_packet(avctx,
                              (avpkt && avpkt->size) ? avpkt : NULL);
    if (ret == AVERROR(EAGAIN)) {
        if (avpkt && avpkt->size)
            /* Decoder buffered a frame without consuming our packet —
             * the no-delay assumption above is violated.  Fail loudly
             * rather than report the packet consumed and silently skip
             * it (that would desynchronize the A/B parity harness by
             * one frame). */
            return ret;
        /* EAGAIN on a flush send just means frames are pending. */
    } else if (ret < 0 && ret != AVERROR_EOF) {
        return ret;
    }
    ret = avcodec_receive_frame(avctx, frame);
    if (ret == 0) {
        *got_picture_ptr = 1;
        return avpkt ? avpkt->size : 0;
    }
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF)
        return avpkt ? avpkt->size : 0;
    return ret;
}

#endif /* DMCNET_AV58_SHIM_H */
