// GOP motion back-trace (CUDA, sm_90a): one walk, two kernels.
//
// Replaces both TPU kernels of dmcnet_tpu/ops/pallas_backtrace.py, which
// share the loop `_shift_cells_multi`:
//   * B1 `backtrace_warp_batch` (kernel body `_kernel_warp`): G GOPs, the
//     accumulated source map AND the warped I-frame  -> kWarp = true;
//   * B2 `backtrace_gop_cells` (kernel body `_kernel`): one GOP, the
//     accumulated source map only                    -> kWarp = false.
// Same inputs, same int32 outputs, bit for bit.  Both instantiations run
// the same walk below, so the two cannot drift apart.
//
// What it computes.  For GOP g and frame t the accumulated source map is
//   accu_0 = identity,  accu_t[p] = accu_{t-1}[p - m_t(p)]
// where m_t(p) is the motion of the cell holding p, set to zero when
// p - m_t(p) falls outside the frame (the reference's boundary clipping,
// coviar_data_loader.c:105-108).  Frame 0's motion is ignored.  The warped
// I-frame is warped_t[p] = iframe[accu_t[p]].  The TPU kernel carries
// accu_{t-1} from frame to frame in VMEM; CUDA blocks run in no order, so
// the recursion is unrolled per pixel instead (accu_t = accu_0 o src_1 o
// ... o src_t): a pixel is followed back through the motion of frames t..1,
//   q = p;  for s = t..1: m = cell_mv[g, s, cell(q)]; if q - m in frame: q -= m
// reading only the small per-cell grids (T * H/c * W/c int2 per GOP, 30 KB
// at 256x320, c = 16), so every output is independent of every other.
//
// What bounds each on an H100.  B1 at the serving shape (G = 64, T = 12,
// 256x320) writes 5 int32 planes per frame, 1.26 GB, against ~0.25 ms of
// walk: it is bound by device-memory write bandwidth, and the walk has to
// hide under the writes.  B2 (one GOP, 2 planes per frame, 7.9 MB) is
// bound by its integer operations, t walk steps for frame t, and in
// practice by latency: one GOP is a few microseconds of work.
//
// What held the first design back (one thread per pixel per frame, one
// 4-byte store per plane, ordinary stores; B1 at ~50% of its bound, B2 at
// ~29%): a warp stored 128 bytes per instruction, a thread had one chain
// of up to T-1 dependent loads and nothing to overlap it with, the output
// streamed through L2 with write-back stores and evicted the cell grids
// and I-frames that the walks and gathers re-read, and in B2 the blocks of
// frame T-1 walked T-1 steps while those of frame 0 walked none, so the
// last wave set the time.
//
// This design:
//   * a thread owns kPix consecutive pixels of one row (W is a multiple of
//     8, so a run never crosses a row and its first pixel is 16-byte
//     aligned in every plane) and walks them as kPix independent chains,
//     interleaved, so their loads overlap;
//   * each plane is written with 16-byte streaming stores (`__stcs`,
//     st.global.cs), so the output is marked evict-first in L2 (with
//     write-back stores B1 takes 1.8x as long);
//   * a thread walks frame k and then frame T-1-k, so every thread walks
//     T-1 steps (the middle frame of an odd T alone, frame 0 none): the
//     work is balanced, and one 256x320, T = 12 GOP of B2 is 240 blocks
//     of 512 threads, one wave;
//   * one flat grid: block b serves (g, k) = b / nchunk and a chunk of 512
//     of that pair's pixel runs; divisions by runtime sizes are
//     multiply-shift (`FastDiv`).  No grid axis is bounded by G or T, and
//     the only ragged edge, the last chunk of a plane, is masked by
//     `v < nvec`;
//   * the cell grids are read through L1 (`__ldg`).  Staging a GOP's grids
//     in shared memory was measured against it (PERF.md, PR 3): slower for
//     B1 and for B2 at cell 8, faster for B2 at cell 16 by about a
//     microsecond, and unable to hold the grids of large frames (227 KB a
//     block), so L1 stays, with no size limit.
//
// 4 pixels a thread, 512 threads a block and streaming stores won a sweep
// against 1, 2 and 8 pixels, 256 threads, write-back stores and staged
// grids; PERF.md keeps the times, and tools/bench_torch_backtrace.py times
// this file against any other source with the same C interface (such as
// a variant taken from git history).
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by ops/_build.py): each `*_launch` launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPix = 4;  // pixels a thread: one int4 per plane
constexpr int kThreads = 512;

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31, as (umulhi(n, mul) + n) >> shr
// (round-up multiply-shift division).
struct FastDiv {
  uint32_t d, mul, shr;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t shr = 0;
  while ((uint64_t{1} << shr) < d) ++shr;
  const uint64_t mul = ((uint64_t{1} << 32) * ((uint64_t{1} << shr) - d)) / d + 1;
  return {d, static_cast<uint32_t>(mul), shr};
}

__device__ __forceinline__ uint32_t fdiv(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.mul) + n) >> f.shr;
}

// p + i as one wide multiply-add (IMAD.WIDE.U32).  Left to itself the
// compiler folds the frame offset into a 64-bit index and spends four
// instructions on each address of the walk.
template <typename T>
__device__ __forceinline__ const T* wide_index(const T* p, unsigned i) {
  const T* r;
  asm("mad.wide.u32 %0, %1, %2, %3;"
      : "=l"(r)
      : "r"(i), "n"(static_cast<int>(sizeof(T))), "l"(p));
  return r;
}

struct Params {
  const int2* cells;        // (G, T, ncy, ncx) motion per cell
  const int32_t* iframes;   // (G, 3, H, W) | null
  int32_t* accu;            // (G, T, 2, H, W)
  int32_t* warped;          // (G, T, 3, H, W) | null
  int T, H, W, shift;
  unsigned ncx;
  int frame_cells;          // ncy * ncx
  int plane;                // H * W
  int nvec;                 // pixel runs per plane: H * W / kPix
  FastDiv nchunk;           // blocks per (g, k)
  FastDiv npair;            // K = ceil(T / 2) frame pairs per GOP
  FastDiv row_runs;         // W / kPix
};

// Follow kPix pixels (y, x0 + j) back from frame t to the I-frame through
// `cells`, the GOP's grids.
__device__ __forceinline__ void walk(const Params& p, const int2* cells,
                                     int t, int y, int x0, int (&qx)[kPix],
                                     int (&qy)[kPix]) {
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    qx[j] = x0 + j;
    qy[j] = y;
  }
  for (int s = t; s >= 1; --s) {
    // frame s's grid.  q stays in the frame, so the cell index is an
    // unsigned 32-bit offset from it.
    const int2* f = cells + static_cast<size_t>(s) * p.frame_cells;
    int2 m[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const unsigned idx =
          static_cast<unsigned>(qy[j] >> p.shift) * p.ncx +
          static_cast<unsigned>(qx[j] >> p.shift);
      m[j] = __ldg(wide_index(f, idx));
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int sx = qx[j] - m[j].x;
      const int sy = qy[j] - m[j].y;
      if (static_cast<unsigned>(sx) < static_cast<unsigned>(p.W) &&
          static_cast<unsigned>(sy) < static_cast<unsigned>(p.H)) {
        qx[j] = sx;
        qy[j] = sy;
      }
    }
  }
}

// One run of kPix pixels into one plane: one 16-byte streaming store
// (st.global.cs, evict-first in L2).
__device__ __forceinline__ void store_run(int32_t* dst,
                                          const int (&v)[kPix]) {
  __stcs(reinterpret_cast<int4*>(dst), make_int4(v[0], v[1], v[2], v[3]));
}

// Write frame t of GOP g at pixel offset `pix`: accu, and with kWarp the
// I-frame gathered at the traced sources.
template <bool kWarp>
__device__ __forceinline__ void emit(const Params& p, uint32_t g, int t,
                                     size_t pix, const int (&qx)[kPix],
                                     const int (&qy)[kPix]) {
  const size_t gt = static_cast<size_t>(g) * p.T + t;
  int32_t* a = p.accu + gt * 2 * p.plane + pix;
  store_run(a, qx);
  store_run(a + p.plane, qy);
  if constexpr (kWarp) {
    const int32_t* src = p.iframes + static_cast<size_t>(g) * 3 * p.plane;
    int32_t* w = p.warped + gt * 3 * p.plane + pix;
    unsigned idx[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) idx[j] = qy[j] * p.W + qx[j];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      int v[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        v[j] = __ldg(wide_index(src + c * p.plane, idx[j]));
      store_run(w + c * p.plane, v);
    }
  }
}

template <bool kWarp>
__global__ void __launch_bounds__(kThreads)
backtrace_kernel(const Params p) {
  const uint32_t gk = fdiv(blockIdx.x, p.nchunk);
  const int chunk = blockIdx.x - gk * p.nchunk.d;
  const uint32_t g = fdiv(gk, p.npair);
  const int k = gk - g * p.npair.d;  // frames k and T-1-k
  const int t2 = p.T - 1 - k;
  const int2* cells = p.cells + static_cast<size_t>(g) * p.T * p.frame_cells;
  const int v = chunk * kThreads + threadIdx.x;
  if (v < p.nvec) {
    const int y = fdiv(v, p.row_runs);
    const int x0 = (v - y * static_cast<int>(p.row_runs.d)) * kPix;
    const size_t pix = static_cast<size_t>(y) * p.W + x0;
    int qx[kPix], qy[kPix];
    walk(p, cells, k, y, x0, qx, qy);
    emit<kWarp>(p, g, k, pix, qx, qy);
    if (t2 != k) {
      walk(p, cells, t2, y, x0, qx, qy);
      emit<kWarp>(p, g, t2, pix, qx, qy);
    }
  }
}

template <bool kWarp>
int launch(const void* cell_mv, const void* iframes, void* accu,
           void* warped, int G, int T, int H, int W, int cell,
           void* stream) {
  if (G <= 0 || T <= 0 || H <= 0 || W <= 0) return 0;
  if (W % kPix != 0 || static_cast<int64_t>(H) * W > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.cells = static_cast<const int2*>(cell_mv);
  p.iframes = static_cast<const int32_t*>(iframes);
  p.accu = static_cast<int32_t*>(accu);
  p.warped = static_cast<int32_t*>(warped);
  p.T = T;
  p.H = H;
  p.W = W;
  p.ncx = W / cell;
  p.shift = cell == 16 ? 4 : 3;
  p.frame_cells = (H / cell) * p.ncx;
  p.plane = H * W;
  p.nvec = H * (W / kPix);
  const int nchunk = (p.nvec + kThreads - 1) / kThreads;
  const int K = (T + 1) / 2;
  const int64_t blocks = static_cast<int64_t>(nchunk) * K * G;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  p.nchunk = make_fastdiv(nchunk);
  p.npair = make_fastdiv(K);
  p.row_runs = make_fastdiv(W / kPix);
  backtrace_kernel<kWarp><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Back-trace + warped I-frame of G GOPs on `stream` (a cudaStream_t, 0 =
// legacy default).  The caller has checked shapes, types, contiguity and
// that cell is 8 or 16 and divides H and W; accu and warped come from
// torch.empty, so every row of every plane starts 16-byte aligned.
// Returns cudaGetLastError().
int backtrace_warp_launch(const void* cell_mv, const void* iframes,
                          void* accu, void* warped, int G, int T, int H,
                          int W, int cell, void* stream) {
  return launch<true>(cell_mv, iframes, accu, warped, G, T, H, W, cell,
                      stream);
}

// Back-trace only, one GOP: cell_mv (T,ncy,ncx,2) -> accu (T,2,H,W).  Same
// checks and return as above.
int backtrace_gop_launch(const void* cell_mv, void* accu, int T, int H,
                         int W, int cell, void* stream) {
  return launch<false>(cell_mv, nullptr, accu, nullptr, 1, T, H, W, cell,
                       stream);
}

const char* backtrace_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
