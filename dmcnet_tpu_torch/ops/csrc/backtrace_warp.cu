// GOP motion back-trace + warped I-frame for a batch of GOPs (CUDA, sm_90a).
//
// Replaces the TPU kernel `backtrace_warp_batch` of
// dmcnet_tpu/ops/pallas_backtrace.py (kernel body `_kernel_warp`, loop
// `_shift_cells_multi`).  Same inputs, same int32 outputs, bit for bit.
//
// What it computes.  For GOP g and frame t the accumulated source map is
//   accu_0 = identity,  accu_t[p] = accu_{t-1}[p - m_t(p)]
// where m_t(p) is the motion of the cell holding p, set to zero when
// p - m_t(p) falls outside the frame (the reference's boundary clipping,
// coviar_data_loader.c:105-108).  Frame 0's motion is ignored.  The warped
// I-frame is warped_t[p] = iframe[accu_t[p]].
//
// Design.  The TPU kernel carries accu_{t-1} from frame to frame in VMEM,
// because its grid runs in order on one core.  Here the recursion is
// unrolled per pixel instead: accu_t = accu_0 o src_1 o ... o src_t, so
// one thread follows its pixel back through the motion of frames t..1:
//   q = p;  for s = t..1: m = cell_mv[g, s, cell(q)]; if q - m in frame: q -= m
// and writes accu[g, t, :, p] = q and warped[g, t, :, p] = iframe[g, :, q].
// It reads only the small per-cell grids (T * H/c * W/c * 2 int32 per GOP,
// 30 KB at 256x320, c = 16, which stay in L1/L2), so no frame waits for the
// previous frame's output and every (g, t) plane is an independent block
// column.  Threads of a warp cover 32 neighbouring pixels of one row, so the
// five int32 planes it writes are coalesced.
//
// Bound.  The kernel writes 5 int32 planes per frame and reads one I-frame
// per GOP: at G = 64, T = 12, 256x320 that is ~1.26 GB of writes, so it is
// bound by device-memory write bandwidth.  The per-pixel walk costs
// ~t cell reads and ~10 integer operations per step, well under that bound.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by ops/_build.py): `backtrace_warp_launch` launches on the given
// stream and returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
backtrace_warp_kernel(const int32_t* __restrict__ cell_mv,   // (G,T,ncy,ncx,2)
                      const int32_t* __restrict__ iframes,   // (G,3,H,W)
                      int32_t* __restrict__ accu,            // (G,T,2,H,W)
                      int32_t* __restrict__ warped,          // (G,T,3,H,W)
                      int T, int H, int W, int ncy, int ncx, int cell_shift) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int gt = blockIdx.z;  // g * T + t
  const int g = gt / T;
  const int t = gt - g * T;

  const int2* grid = reinterpret_cast<const int2*>(cell_mv);
  const size_t frame_cells = static_cast<size_t>(ncy) * ncx;
  int qx = x, qy = y;
  for (int s = t; s >= 1; --s) {
    const size_t cidx = (static_cast<size_t>(g) * T + s) * frame_cells
                        + static_cast<size_t>(qy >> cell_shift) * ncx
                        + (qx >> cell_shift);
    const int2 m = __ldg(grid + cidx);
    const int sx = qx - m.x;
    const int sy = qy - m.y;
    if (sx >= 0 && sx < W && sy >= 0 && sy < H) {
      qx = sx;
      qy = sy;
    }
  }

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t pix = static_cast<size_t>(y) * W + x;
  int32_t* a = accu + static_cast<size_t>(gt) * 2 * plane + pix;
  a[0] = qx;
  a[plane] = qy;
  const int32_t* src = iframes + static_cast<size_t>(g) * 3 * plane
                       + static_cast<size_t>(qy) * W + qx;
  int32_t* wp = warped + static_cast<size_t>(gt) * 3 * plane + pix;
  wp[0] = __ldg(src);
  wp[plane] = __ldg(src + plane);
  wp[2 * plane] = __ldg(src + 2 * plane);
}

}  // namespace

extern "C" {

// Launch the back-trace on `stream` (a cudaStream_t, 0 = legacy default).
// The caller has checked shapes, types, contiguity and that cell is 8 or 16
// and divides H and W.  Returns cudaGetLastError() after the launch.
int backtrace_warp_launch(const void* cell_mv, const void* iframes,
                          void* accu, void* warped, int G, int T, int H,
                          int W, int cell, void* stream) {
  if (G <= 0 || T <= 0 || H <= 0 || W <= 0) return 0;
  const int cell_shift = cell == 16 ? 4 : 3;
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY,
                  static_cast<unsigned>(G) * T);
  backtrace_warp_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell_mv),
      static_cast<const int32_t*>(iframes), static_cast<int32_t*>(accu),
      static_cast<int32_t*>(warped), T, H, W, H / cell, W / cell, cell_shift);
  return static_cast<int>(cudaGetLastError());
}

const char* backtrace_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
