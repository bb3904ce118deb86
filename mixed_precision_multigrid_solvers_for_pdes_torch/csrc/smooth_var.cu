// Kernel H: multi-sweep smoothing (RB-GS / SOR / weighted Jacobi) with a
// variable-coefficient 5-point stencil, its five coefficient planes c, w, e,
// s, n, on an all-Dirichlet rectangle, on fp32 or bf16 storage: every sweep
// of a call in one launch, out of place.
//
// Replaces the variable-coefficient branches of the Pallas kernels
// multisweep (whole level in VMEM, _smooth_kernel_var :231) and
// multisweep_strips (row strips streaming seven windows with a 2 * sweeps
// halo, _strips_kernel with n_in = 7 :353) of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py
// (:290 and :507). As for kernel A, the whole-grid/strip split existed only
// because of the TPU's VMEM budget; the strips' halo is kept, at tile size.
//
// Design, in the image of kernel L (csrc/smooth_parity.cu):
// - Each block owns a tile of the interior (plus the ring next to it at the
//   field's edge) and loads a window of u, f and the five planes into shared
//   memory: the tile plus a halo of 2 * sweeps nodes per side for RB-GS/SOR,
//   sweeps nodes for Jacobi, clamped to the field. The loads are 4-byte
//   cp.async (rows of unpadded levels are not 16-byte aligned), all in
//   flight at once.
// - Storage: u, f, the planes (the level's dtype) and out are each fp32 or
//   bf16 (the storage flags of mg_smooth_var), f in either dtype whatever
//   the level's, as the Pallas kernel casts each input on its own. The
//   windows are fp32 whatever the storage: bf16 nodes are loaded with 2-byte
//   loads and widened (cp.async has no 2-byte copy), and the tile is
//   rounded to bf16 once, where it is stored. A call of more sweeps than
//   one launch takes keeps its passes before the last in fp32 (the
//   wrapper's scratch fields), so a bf16 call rounds once, as the Pallas
//   kernel's one call does.
// - The tile's size is the level's (tile_of): the largest of kTiles whose
//   grid holds at least kMinBlocks blocks, about one per SM, else the
//   smallest. A block's life (loads, 2 * sweeps phases, store) is a chain of
//   latencies, so a level of far fewer blocks than SMs takes one such life
//   whatever its size: smaller tiles give it more, shorter lives (257^2:
//   8 x 64 tiles ~35% faster than 32 x 64). Once a level fills the SMs,
//   smaller tiles only add halo (513^2 and 1025^2: 32 x 64 fastest; PERF.md).
// - The block runs every sweep in shared memory, with __syncthreads()
//   between colour phases (between sweeps for Jacobi, which ping-pongs
//   between two u buffers). A node is updated only if it is an unknown of
//   the field and not on the window's border. A stale border value travels
//   one node per colour phase (per Jacobi sweep), so after the call the tile,
//   halo nodes in, is exact; where the window is clamped its border is the
//   field's fixed ring, which is exact too.
// - Each window row keeps its even and odd columns in two halves, so the
//   nodes of one colour in a row, and each of their four neighbour sets, are
//   consecutive words: a warp's phase reads are free of bank conflicts
//   within a row.
// - The tile goes to a separate output: neighbouring blocks load this
//   block's nodes as their halo, so writing u in place would race. The
//   wrapper gives each launch of a call a new output and copies the last
//   one back into u once (ops/cuda_kernels/smooth_var.py).
// - A launch takes at most kMaxSweeps sweeps; the wrapper splits longer runs.
//
// Arithmetic: the twins' order with every operation rounded explicitly and
// the update divided by c (common.cuh: nbsum_values, rbgs_var_update,
// jacobi_var_update), so H matches multisweep_plain bit for bit.
//
// Bound: device memory bandwidth. A call must read u, f and the five planes
// once and write u once (32 bytes per node in fp32, 16 in bf16). H reads the windows (1.41x the
// tile at 2 sweeps with 32 x 64 tiles), writes the tile, and the wrapper's
// copy adds 8 bytes per node; the 1025^2 level's 29 MB of inputs fit the
// 50 MB L2, so repeated calls may read them from L2. What bounds it on the
// H100 is latency: a block's life is ~7 us at 32 x 64 (PERF.md).
#include "common.cuh"

namespace {

// The geometry below is this file's own: mg_smooth_var_geometry reports it,
// ops/cuda_kernels/smooth_var.py checks its launch planning against that
// report before a level's first launch, and the CPU schedule test reads it
// from this file.
struct Tile {
  int x, y;  // interior rows (i) and columns (j, contiguous; even)
};
constexpr Tile kTiles[] = {{32, 64}, {16, 64}, {8, 64}};
constexpr int kNumTiles = 3;
static_assert(sizeof(kTiles) / sizeof(Tile) == kNumTiles);
constexpr int kMinBlocks = 128;  // about one per SM of the H100's 132
constexpr int kThreads = 512;
constexpr int kMaxSweeps = 4;  // sweeps per launch

__host__ __device__ constexpr int blocks_of(int nx, int ny, Tile t) {
  return ((nx - 2 + t.x - 1) / t.x) * ((ny - 2 + t.y - 1) / t.y);
}

// The tile of an (nx, ny) level: an index into kTiles.
int tile_of(int nx, int ny) {
  for (int k = 0; k < kNumTiles - 1; ++k)
    if (blocks_of(nx, ny, kTiles[k]) >= kMinBlocks) return k;
  return kNumTiles - 1;
}

// Items (node pairs of a window row) a thread takes in an RB-GS phase, at
// most: (TX + 4 kMaxSweeps - 2) rows of (TY / 2 + 2 kMaxSweeps).
__host__ __device__ constexpr int rb_items(int tx, int ty) {
  return ((tx + 4 * kMaxSweeps - 2) * (ty / 2 + 2 * kMaxSweeps) + kThreads -
          1) /
         kThreads;
}

__host__ __device__ __forceinline__ int halo_of(int sweeps, bool jacobi) {
  return jacobi ? sweeps : 2 * sweeps;
}

// Floats of one window array (rows x row stride) at `halo`.
__host__ __device__ __forceinline__ int window_floats(int tx, int ty,
                                                     int halo) {
  return (tx + 2 * halo) * (ty + 2 * halo);
}

// u, f, c, w, e, s, n (and Jacobi's second u buffer).
__host__ __forceinline__ int smem_bytes(int tx, int ty, int sweeps,
                                        bool jacobi) {
  return (jacobi ? 8 : 7) * window_floats(tx, ty, halo_of(sweeps, jacobi)) *
         (int)sizeof(float);
}

template <int kTileX, int kTileY, bool kJacobi, class TU, class TF, class TP,
          class TO>
__global__ void __launch_bounds__(kThreads)
    smooth_var_kernel(const TU* __restrict__ u, const TF* __restrict__ f,
                      PlanesOf<TP> p, TO* __restrict__ out, int nx, int ny,
                      float omega, int sweeps, int c0) {
  extern __shared__ float sm[];
  const int halo = halo_of(sweeps, kJacobi);
  const int RS = kTileY + 2 * halo;  // row stride: two halves of HP
  const int HP = RS / 2;
  const int PL = window_floats(kTileX, kTileY, halo);
  float* us = sm;
  float* fs = sm + PL;
  float* cs = sm + 2 * PL;
  float* ws = sm + 3 * PL;
  float* es = sm + 4 * PL;
  float* ss = sm + 5 * PL;
  float* ns = sm + 6 * PL;
  float* vs = sm + 7 * PL;  // Jacobi only

  const int ai = 1 + blockIdx.y * kTileX, bi = min(ai + kTileX, nx - 1);
  const int aj = 1 + blockIdx.x * kTileY, bj = min(aj + kTileY, ny - 1);
  const int wi0 = max(ai - halo, 0), wx = min(bi + halo, nx) - wi0;
  const int wj0 = max(aj - halo, 0), wy = min(bj + halo, ny) - wj0;
  auto at = [&](int li, int lj) { return li * RS + (lj & 1) * HP + (lj >> 1); };

  for (int t = threadIdx.x; t < wx * wy; t += kThreads) {
    const int li = t / wy, lj = t - li * wy;
    const long g = (long)(wi0 + li) * ny + (wj0 + lj);
    const int s = at(li, lj);
    load_shared(us + s, u + g);
    if (kJacobi) load_shared(vs + s, u + g);
    load_shared(fs + s, f + g);
    load_shared(cs + s, p.c + g);
    load_shared(ws + s, p.w + g);
    load_shared(es + s, p.e + g);
    load_shared(ss + s, p.s + g);
    load_shared(ns + s, p.n + g);
  }
  cp_async_commit();
  cp_async_wait<0>();

  const float* fin = us;
  if (!kJacobi) {
    // phase ph updates colour (c0 + ph) & 1; item (row li, m) is the node
    // of that colour among columns 2m, 2m + 1 of the row. A thread computes
    // all its items before it stores any (a phase reads only the other
    // colour and each node's own old value), so their loads and divisions
    // overlap.
    for (int ph = 0; ph < 2 * sweeps; ++ph) {
      const int color = (c0 + ph) & 1;
      __syncthreads();
      constexpr int kItems = rb_items(kTileX, kTileY);
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
        const float nb = nbsum_values(ws[self], es[self], ss[self], ns[self],
                                      us[self - RS], us[self + RS], us[sj],
                                      us[nj]);
        nv[r] = rbgs_var_update(us[self], fs[self], cs[self], nb, omega);
        at_self[r] = self;
      }
#pragma unroll
      for (int r = 0; r < kItems; ++r)
        if (at_self[r] >= 0) us[at_self[r]] = nv[r];
    }
  } else {
    float* src = us;
    float* dst = vs;
    for (int sw = 0; sw < sweeps; ++sw) {
      __syncthreads();
      for (int t = threadIdx.x; t < (wx - 2) * RS; t += kThreads) {
        const int li = 1 + t / RS, rem = t - (li - 1) * RS;
        const int b = rem >= HP, m = rem - b * HP;
        const int lj = 2 * m + b;
        if (lj < 1 || lj > wy - 2) continue;
        const int self = li * RS + rem;
        const int sj = b ? self - HP : self + HP - 1;
        const int nj = b ? self - HP + 1 : self + HP;
        const float nb = nbsum_values(ws[self], es[self], ss[self], ns[self],
                                      src[self - RS], src[self + RS],
                                      src[sj], src[nj]);
        dst[self] = jacobi_var_update(src[self], fs[self], cs[self], nb,
                                      omega);
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

template <int kTileX, int kTileY, bool kJacobi, class TU, class TF, class TP,
          class TO>
cudaError_t launch(const TU* u, const TF* f, const PlanesOf<TP>& p, TO* out,
                   int nx, int ny, float omega, int sweeps, int c0,
                   int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const auto kernel =
      smooth_var_kernel<kTileX, kTileY, kJacobi, TU, TF, TP, TO>;
  const cudaError_t err = allow_smem(
      kernel, smem_bytes(kTileX, kTileY, kMaxSweeps, kJacobi), device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((ny - 2 + kTileY - 1) / kTileY,
                  (nx - 2 + kTileX - 1) / kTileX);
  kernel<<<grid, kThreads, smem_bytes(kTileX, kTileY, sweeps, kJacobi),
           stream>>>(u, f, p, out, nx, ny, omega, sweeps, c0);
  return cudaGetLastError();
}

template <int k, class TU, class TF, class TP, class TO>
cudaError_t launch_tile(const TU* u, const TF* f, const PlanesOf<TP>& p,
                        TO* out, int nx, int ny, float omega, int sweeps,
                        bool jacobi, int c0, int device, cudaStream_t st) {
  constexpr Tile t = kTiles[k];
  return jacobi ? launch<t.x, t.y, true>(u, f, p, out, nx, ny, omega, sweeps,
                                         0, device, st)
                : launch<t.x, t.y, false>(u, f, p, out, nx, ny, omega,
                                          sweeps, c0, device, st);
}

// The storage of one launch: bit 0 the input u is bf16, bit 1 f, bit 2 out
// (kernel A's bits, csrc/smooth.cu), bit 3 the planes. The planes are in
// the level's dtype, which is the call's u's (ops/dispatch.kernel_smooth_ok),
// and f is fp32 or bf16 on its own, as the Pallas kernel casts each input
// on its own (smooth.py:243). A call on a bf16 level runs its passes before
// the last on fp32 u, so it takes bits 0 and 2 as A's passes do.
enum Storage : int {
  kFp32 = 0,          // an fp32 level
  kFp32BfF = 2,       // an fp32 level with a bf16 f
  kBf16 = 15,         // a bf16 level's call in one launch
  kBf16First = 11,    // the first launch of a longer bf16 call: out fp32
  kBf16Mid = 10,      // a launch between: u and out fp32
  kBf16Last = 14,     // the last: u fp32, out bf16
  kBf16U = 13,        // a bf16 level with an fp32 f, in one launch
  kBf16UFirst = 9,    // the first launch of such a call: out fp32
  kBf16UMid = 8,      // a launch between: u, f and out fp32
  kBf16ULast = 12,    // the last: out bf16
};

template <class TU, class TF, class TP, class TO>
cudaError_t smooth_var_typed(const void* u, const void* f,
                             const void* const* planes, void* out, int nx,
                             int ny, float omega, int sweeps, bool jacobi,
                             int c0, int device, cudaStream_t st) {
  const TU* tu = static_cast<const TU*>(u);
  const TF* tf = static_cast<const TF*>(f);
  TO* to = static_cast<TO*>(out);
  const PlanesOf<TP> p{static_cast<const TP*>(planes[0]),
                       static_cast<const TP*>(planes[1]),
                       static_cast<const TP*>(planes[2]),
                       static_cast<const TP*>(planes[3]),
                       static_cast<const TP*>(planes[4])};
  static_assert(kNumTiles == 3, "one case per tile");
  switch (tile_of(nx, ny)) {
    case 0:
      return launch_tile<0>(tu, tf, p, to, nx, ny, omega, sweeps, jacobi, c0,
                            device, st);
    case 1:
      return launch_tile<1>(tu, tf, p, to, nx, ny, omega, sweeps, jacobi, c0,
                            device, st);
    default:
      return launch_tile<2>(tu, tf, p, to, nx, ny, omega, sweeps, jacobi, c0,
                            device, st);
  }
}

}  // namespace

extern "C" {

// `sweeps` (1 .. kMaxSweeps) sweeps of u, written to out (every node of out
// is written; u, f and the planes are only read, and out must not alias
// them): weighted Jacobi when `jacobi`, else RB-GS/SOR, red first, black
// first when `reverse`. `storage` says which of u, f, out and the planes
// are bf16 (Storage); the others are fp32.
int mg_smooth_var(const void* u, const void* f, const void* c, const void* w,
                  const void* e, const void* s, const void* n, void* out,
                  int nx, int ny, float omega, int sweeps, int jacobi,
                  int reverse, int storage, int device, void* stream) {
  if (sweeps < 1 || sweeps > kMaxSweeps || nx < 3 || ny < 3)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const void* planes[5] = {c, w, e, s, n};
  const cudaStream_t st = (cudaStream_t)stream;
  const int c0 = reverse ? 1 : 0;
  const bool jac = jacobi != 0;
  switch (storage) {
    case kFp32:
      return (int)smooth_var_typed<float, float, float, float>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kFp32BfF:
      return (int)smooth_var_typed<float, bf16, float, float>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kBf16:
      return (int)smooth_var_typed<bf16, bf16, bf16, bf16>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kBf16First:
      return (int)smooth_var_typed<bf16, bf16, bf16, float>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kBf16Mid:
      return (int)smooth_var_typed<float, bf16, bf16, float>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kBf16Last:
      return (int)smooth_var_typed<float, bf16, bf16, bf16>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kBf16U:
      return (int)smooth_var_typed<bf16, float, bf16, bf16>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kBf16UFirst:
      return (int)smooth_var_typed<bf16, float, bf16, float>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kBf16UMid:
      return (int)smooth_var_typed<float, float, bf16, float>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    case kBf16ULast:
      return (int)smooth_var_typed<float, float, bf16, bf16>(
          u, f, planes, out, nx, ny, omega, sweeps, jac, c0, device, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// H's geometry for an (nx, ny) level into out[6]: its tile's rows (i) and
// columns (j), threads per block, kMaxSweeps, kMinBlocks, and the number of
// tiles a level may take.
int mg_smooth_var_geometry(int nx, int ny, int* out) {
  const Tile t = kTiles[tile_of(nx, ny)];
  const int g[6] = {t.x, t.y, kThreads, kMaxSweeps, kMinBlocks, kNumTiles};
  for (int i = 0; i < 6; ++i) out[i] = g[i];
  return 0;
}

}  // extern "C"
