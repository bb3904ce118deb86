// Kernel A: multi-sweep smoothing (RB-GS / SOR / weighted Jacobi) with a
// constant-coefficient 5-point stencil on an all-Dirichlet rectangle: every
// sweep of a call in one launch, out of place.
//
// Replaces the Pallas kernels multisweep (whole level in VMEM) and
// multisweep_strips (double-buffered row strips with a redundant halo) of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py
// (:290 and :507). On Hopper one kernel covers both: the whole-grid/strip
// split existed only because of the TPU's VMEM budget.
//
// What bounds it: device memory bandwidth. A call must read u and f and
// write u once (12 bytes per node, 3.76 us at 1025^2 at 3.35 TB/s). One
// launch per colour phase (this kernel's first design) moved that much per
// phase and paid a launch for each; a row wavefront with one ring of rows
// per block or per warp (kernel E's pattern in 2D) paid more per row step
// than it saved (PERF.md).
//
// Design, in the image of kernel H (csrc/smooth_var.cu) with no planes:
// - Each block owns a tile of the interior (plus the ring next to it at the
//   field's edge) and loads a window of u and f into shared memory: the tile
//   plus a halo of P nodes per side, clamped to the field, where P is the
//   number of phases of the launch: 2 per RB-GS sweep (one per colour), 1
//   per Jacobi sweep. The loads are 4-byte cp.async (rows of unpadded
//   levels are not 16-byte aligned), all in flight at once.
// - Storage: u, f and out are each fp32 or bf16 (the storage flags of
//   mg_smooth), in every pairing of u and f the Pallas kernel takes: it
//   casts each on its own (smooth.py:213, :224) and its output keeps u's
//   dtype. The window is fp32 whatever the storage. A bf16 array's window
//   rows come in as aligned 4-byte words (common.cuh load_windows, as
//   kernel L's: two nodes a load, every load of a thread in flight before
//   it widens any, with no division per node), widened into the same
//   halves of the fp32 window; Jacobi's second buffer is copied from the
//   widened window. The tile is rounded to bf16 once, where it is stored.
//   A call of more sweeps than one launch takes keeps its passes before the
//   last in fp32 (the wrapper's scratch fields), so a bf16 call rounds
//   once, as the Pallas kernel's one call does.
// - The tile's size is the level's (tile_of): the largest of kTiles whose
//   grid holds at least kMinBlocks blocks, about one per SM, else the
//   smallest. This geometry is in smooth_tiles.cuh, shared with K and L.
// - The block runs every sweep in shared memory, with __syncthreads()
//   between colour phases (between sweeps for Jacobi, which ping-pongs
//   between two u buffers). A node is updated only if it is off the
//   window's border. A stale border value travels one node per phase, so
//   after the call the tile, P nodes in, is exact; where the window is
//   clamped its border is the field's fixed ring, which is exact too.
// - Each window row keeps its even and odd columns in two halves, so the
//   nodes of one colour in a row, and each of their four neighbour sets, are
//   consecutive words. A thread computes all its items of a phase before it
//   stores any (a phase reads only the other colour and each node's own old
//   value), so their loads overlap.
// - The tile goes to a separate output: neighbouring blocks load this
//   block's nodes as their halo, so writing u in place would race. The
//   wrapper returns that output (ops/cuda_kernels/smooth.py); u is left as
//   it was.
// - A launch takes at most kMaxSweeps sweeps; the wrapper splits longer
//   runs.
//
// Arithmetic: the Pallas sweep bodies' per-node updates, dividing by c, with
// every operation rounded explicitly (common.cuh: rbgs_scalar_update,
// jacobi_scalar_update), as kernels K and L do, so the direct and the parity
// layouts and the plain twin agree bit for bit.
#include "common.cuh"
#include "smooth_tiles.cuh"

namespace {

__host__ __device__ constexpr int halo_of(int sweeps, bool jacobi) {
  return jacobi ? sweeps : 2 * sweeps;
}

// Items (node pairs of a window row) a thread takes in an RB-GS phase, at
// most: (TX + 2 halo - 2) rows of (TY / 2 + halo).
__host__ __device__ constexpr int rb_items(int tx, int ty, int halo) {
  return ((tx + 2 * halo - 2) * (ty / 2 + halo) + kThreads - 1) / kThreads;
}

// Floats of one window array (rows x row stride) at `halo`.
__host__ __device__ constexpr int window_floats(int tx, int ty, int halo) {
  return (tx + 2 * halo) * (ty + 2 * halo);
}

// u and f (and Jacobi's second u buffer).
__host__ __device__ constexpr int smem_bytes(int tx, int ty, int sweeps,
                                             bool jacobi) {
  return (jacobi ? 3 : 2) * window_floats(tx, ty, halo_of(sweeps, jacobi)) *
         (int)sizeof(float);
}

// Every geometry value is a compile-time constant of the instantiation, so
// a thread's index arithmetic is shifts and multiplies.
template <int kTileX, int kTileY, int kSweeps, bool kJacobi, class TU,
          class TF, class TO>
__global__ void __launch_bounds__(kThreads)
    smooth_kernel(const TU* __restrict__ u, const TF* __restrict__ f,
                  TO* __restrict__ out, int nx, int ny, Stencil5 st,
                  float omega, int c0) {
  extern __shared__ float sm[];
  constexpr int halo = halo_of(kSweeps, kJacobi);
  constexpr int RS = kTileY + 2 * halo;  // row stride: two halves of HP
  constexpr int HP = RS / 2;
  constexpr int PL = window_floats(kTileX, kTileY, halo);
  float* us = sm;
  float* fs = sm + PL;
  float* vs = sm + 2 * PL;  // Jacobi only

  const int ai = 1 + blockIdx.y * kTileX, bi = min(ai + kTileX, nx - 1);
  const int aj = 1 + blockIdx.x * kTileY, bj = min(aj + kTileY, ny - 1);
  const int wi0 = max(ai - halo, 0), wx = min(bi + halo, nx) - wi0;
  const int wj0 = max(aj - halo, 0), wy = min(bj + halo, ny) - wj0;
  auto at = [&](int li, int lj) { return li * RS + (lj & 1) * HP + (lj >> 1); };

  // fp32 arrays node by node, as 4-byte cp.async
  constexpr bool kBu = std::is_same_v<TU, bf16>;
  constexpr bool kBf = std::is_same_v<TF, bf16>;
  if constexpr (!kBu || !kBf) {
    for (int t = threadIdx.x; t < wx * wy; t += kThreads) {
      const int li = t / wy, lj = t - li * wy;
      const long g = (long)(wi0 + li) * ny + (wj0 + lj);
      const int s = at(li, lj);
      if constexpr (!kBu) {
        load_shared(us + s, u + g);
        if (kJacobi) load_shared(vs + s, u + g);
      }
      if constexpr (!kBf) load_shared(fs + s, f + g);
    }
  }
  // bf16 arrays as aligned 4-byte words (common.cuh load_windows), u's
  // then f's (PL apart): window row li's columns 2m and 2m + 1 at
  // li * RS + m and li * RS + HP + m, A's own halves
  if constexpr (kBu || kBf) {
    constexpr int K = kBu + kBf, WR = HP + 1;  // the widest row's words
    constexpr int kPer = ((kTileX + 2 * halo) * WR + kThreads - 1) / kThreads;
    const bf16* src[K];
    src[K - 1] = reinterpret_cast<const bf16*>(f);
    if constexpr (kBu) src[0] = reinterpret_cast<const bf16*>(u);
    load_windows<K, kPer, WR, kThreads>(src, kBu ? us : fs, PL, wi0, wj0, wx,
                                        wy, nx, ny, HP,
                                        [&](int li) { return li * RS; });
  }
  cp_async_commit();
  cp_async_wait<0>();
  if constexpr (kJacobi && kBu) {
    // Jacobi's second buffer from the widened window
    __syncthreads();
    for (int t = threadIdx.x; t < PL; t += kThreads) vs[t] = us[t];
  }

  const float* fin = us;
  const bool p2 = is_pow2(st.c);  // the same for every thread
  if (!kJacobi) {
    // phase ph updates colour (c0 + ph) & 1; item (row li, m) is the node
    // of that colour among columns 2m, 2m + 1 of the row
    for (int ph = 0; ph < 2 * kSweeps; ++ph) {
      const int color = (c0 + ph) & 1;
      __syncthreads();
      constexpr int kItems = rb_items(kTileX, kTileY, halo);
      float nv[kItems];
      int at_self[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int t = threadIdx.x + r * kThreads;
        const int li = 1 + t / HP, m = t - (li - 1) * HP;
        const int b = (color + wi0 + wj0 + li) & 1;
        const int lj = 2 * m + b;
        at_self[r] = -1;
        if (t >= (wx - 2) * HP || lj < 1 || lj > wy - 2) continue;
        const int self = li * RS + b * HP + m;
        const int sj = b ? self - HP : self + HP - 1;  // (li, lj - 1)
        const int nj = b ? self - HP + 1 : self + HP;  // (li, lj + 1)
        nv[r] = p2 ? rbgs_scalar_update<true>(us[self], fs[self],
                                              us[self - RS], us[self + RS],
                                              us[sj], us[nj], st, omega)
                   : rbgs_scalar_update<false>(us[self], fs[self],
                                               us[self - RS], us[self + RS],
                                               us[sj], us[nj], st, omega);
        at_self[r] = self;
      }
#pragma unroll
      for (int r = 0; r < kItems; ++r)
        if (at_self[r] >= 0) us[at_self[r]] = nv[r];
    }
  } else {
    float* src = us;
    float* dst = vs;
    for (int sw = 0; sw < kSweeps; ++sw) {
      __syncthreads();
      for (int t = threadIdx.x; t < (wx - 2) * RS; t += kThreads) {
        const int li = 1 + t / RS, rem = t - (li - 1) * RS;
        const int b = rem >= HP, m = rem - b * HP;
        const int lj = 2 * m + b;
        if (lj < 1 || lj > wy - 2) continue;
        const int self = li * RS + rem;
        const int sj = b ? self - HP : self + HP - 1;
        const int nj = b ? self - HP + 1 : self + HP;
        dst[self] =
            p2 ? jacobi_scalar_update<true>(src[self], fs[self],
                                            src[self - RS], src[self + RS],
                                            src[sj], src[nj], st, omega)
               : jacobi_scalar_update<false>(src[self], fs[self],
                                             src[self - RS], src[self + RS],
                                             src[sj], src[nj], st, omega);
      }
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    fin = src;
  }
  __syncthreads();

  // the tile (with the ring next to it at the field's edge) -> out
  int lo_i, hi_i, lo_j, hi_j;
  tile_span(blockIdx.y, kTileX, nx, &lo_i, &hi_i);
  tile_span(blockIdx.x, kTileY, ny, &lo_j, &hi_j);
  const int ty = hi_j - lo_j;
  for (int t = threadIdx.x; t < (hi_i - lo_i) * ty; t += kThreads) {
    const int i = t / ty, j = t - i * ty;
    store_f(out + (long)(lo_i + i) * ny + lo_j + j,
            fin[at(lo_i + i - wi0, lo_j + j - wj0)]);
  }
}

template <int kTileX, int kTileY, int kSweeps, bool kJacobi, class TU,
          class TF, class TO>
cudaError_t launch(const TU* u, const TF* f, TO* out, int nx, int ny,
                   const Stencil5& st, float omega, int c0, int device,
                   cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const auto kernel =
      smooth_kernel<kTileX, kTileY, kSweeps, kJacobi, TU, TF, TO>;
  constexpr int bytes = smem_bytes(kTileX, kTileY, kSweeps, kJacobi);
  const cudaError_t err = allow_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((ny - 2 + kTileY - 1) / kTileY,
                  (nx - 2 + kTileX - 1) / kTileX);
  kernel<<<grid, kThreads, bytes, stream>>>(u, f, out, nx, ny, st, omega,
                                            c0);
  return cudaGetLastError();
}

// The storage of one launch: the input u, f and the output, as the
// wrapper's passes need them (bit 0: u is bf16, bit 1: f, bit 2: out). u
// and f are each fp32 or bf16: a call on a bf16 u runs its passes before
// the last on fp32, so an fp32 f over a bf16 u takes codes 5 (one launch),
// 1 (the first of several) and 4 (the last), and a bf16 f over an fp32 u
// takes code 2 in every launch (kernel E's codes, csrc/smooth3d.cu).
enum Storage : int {
  kFp32 = 0,        // an fp32 level
  kBf16 = 7,        // a bf16 level's call in one launch
  kBf16First = 3,   // the first launch of a longer bf16 call: out fp32
  kBf16Mid = 2,     // u and out fp32, f bf16: between, or an fp32 u's call
  kBf16Last = 6,    // the last: u fp32, out bf16
  kBf16U = 5,       // a bf16 u over an fp32 f, in one launch
  kBf16UFirst = 1,  // the first launch of such a call: out fp32
  kFp32FLast = 4,   // its last: u and f fp32, out bf16
};

// A longer call's launches before the last take kMaxSweeps sweeps each
// (plan_passes in ops/cuda_kernels/smooth.py), so the first launches of a
// bf16 u (kBf16First, kBf16UFirst) are compiled for that count only
// (kAnySweeps false) and refuse any other; every other storage is
// compiled for every sweep count.
template <class TU, class TF, class TO, bool kAnySweeps>
cudaError_t smooth_typed(const void* u, const void* f, void* out, int nx,
                         int ny, const Stencil5& st, float omega, int sweeps,
                         int jacobi, int c0, int device, cudaStream_t t) {
  const TU* tu = static_cast<const TU*>(u);
  const TF* tf = static_cast<const TF*>(f);
  TO* to = static_cast<TO*>(out);
  return with_tile_and_sweeps(nx, ny, sweeps, [&](auto ti, auto sw) {
    constexpr Tile tile = kTiles[decltype(ti)::value];
    constexpr int kSweeps = decltype(sw)::value;
    if constexpr (!kAnySweeps && kSweeps != kMaxSweeps) {
      return cudaErrorInvalidValue;
    } else {
      return jacobi ? launch<tile.x, tile.y, kSweeps, true>(
                          tu, tf, to, nx, ny, st, omega, 0, device, t)
                    : launch<tile.x, tile.y, kSweeps, false>(
                          tu, tf, to, nx, ny, st, omega, c0, device, t);
    }
  });
}

}  // namespace

extern "C" {

// Text of a CUDA error code returned by any entry point of the library.
const char* mg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// `sweeps` (1 .. kMaxSweeps) sweeps of u, written to out (every node of out
// is written; u and f are only read, and out must not alias them): weighted
// Jacobi when `jacobi`, else RB-GS/SOR, red first, black first when
// `reverse`. `storage` says which of u, f and out are bf16 (Storage); the
// others are fp32.
int mg_smooth(const void* u, const void* f, void* out, int nx, int ny,
              float c, float w, float e, float s, float n, float omega,
              int sweeps, int jacobi, int reverse, int storage, int device,
              void* stream) {
  if (sweeps < 1 || sweeps > kMaxSweeps || nx < 3 || ny < 3)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const Stencil5 st{c, w, e, s, n};
  const cudaStream_t t = (cudaStream_t)stream;
  const int c0 = reverse ? 1 : 0;
  switch (storage) {
    case kFp32:
      return (int)smooth_typed<float, float, float, true>(
          u, f, out, nx, ny, st, omega, sweeps, jacobi, c0, device, t);
    case kBf16:
      return (int)smooth_typed<bf16, bf16, bf16, true>(
          u, f, out, nx, ny, st, omega, sweeps, jacobi, c0, device, t);
    case kBf16First:
      return (int)smooth_typed<bf16, bf16, float, false>(
          u, f, out, nx, ny, st, omega, sweeps, jacobi, c0, device, t);
    case kBf16Mid:
      return (int)smooth_typed<float, bf16, float, true>(
          u, f, out, nx, ny, st, omega, sweeps, jacobi, c0, device, t);
    case kBf16Last:
      return (int)smooth_typed<float, bf16, bf16, true>(
          u, f, out, nx, ny, st, omega, sweeps, jacobi, c0, device, t);
    case kBf16U:
      return (int)smooth_typed<bf16, float, bf16, true>(
          u, f, out, nx, ny, st, omega, sweeps, jacobi, c0, device, t);
    case kBf16UFirst:
      return (int)smooth_typed<bf16, float, float, false>(
          u, f, out, nx, ny, st, omega, sweeps, jacobi, c0, device, t);
    case kFp32FLast:
      return (int)smooth_typed<float, float, bf16, true>(
          u, f, out, nx, ny, st, omega, sweeps, jacobi, c0, device, t);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// A's geometry for an (nx, ny) level into out[6]: its tile's rows (i) and
// columns (j), threads per block, kMaxSweeps, kMinBlocks, and the number of
// tiles a level may take.
int mg_smooth_geometry(int nx, int ny, int* out) {
  const Tile t = kTiles[tile_of(nx, ny)];
  const int g[6] = {t.x, t.y, kThreads, kMaxSweeps, kMinBlocks, kNumTiles};
  for (int i = 0; i < 6; ++i) out[i] = g[i];
  return 0;
}

}  // extern "C"
