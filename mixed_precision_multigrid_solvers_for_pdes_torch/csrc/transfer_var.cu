// Kernel I: fused residual + full-weighting restriction with a
// variable-coefficient 5-point stencil and per-side boundary kinds.
//
// Replaces the variable-coefficient and Neumann/Robin branches of the Pallas
// residual_restrict of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/transfer.py
// (:262; kernel _rr_kernel :140 with n_in = 7, window body _rr_window :85,
// mask _unknown_at :67): fc = R_fw(f - A u), where A's five coefficient
// planes are read from device memory and a 4-bit side mask says which sides
// are Dirichlet. On a Neumann/Robin side the fine ring nodes are unknowns
// (their ghost elimination is in the planes), the window rows and columns
// that leave the domain fold back onto the interior (row -1 reads row 1, row
// nx reads row nx-2; _rr_window :106-118), and the coarse ring is written.
// Coarse nodes off the coarse unknowns are written as 0.
//
// Storage: u, f and the planes (the fine level's dtype) and fc (the coarse
// level's) are each fp32 or bf16, as the Pallas kernel takes them: loads are
// widened to fp32, the residual and its restriction run in fp32, and fc is
// rounded once where it is stored.
//
// Design: a block owns a TX x TY tile of coarse nodes, whose fine window is
// the (2TX + 1) x (2TY + 1) fine nodes from (2 I0 - 1, 2 J0 - 1). Phase 1
// forms every fine residual of the window once, into a shared fp32 tile
// (zero off the fine unknowns): u, which five residuals read, is staged
// once with its one-node halo (zero outside the field, as the twin's zero
// halo reads it); f and the five planes, each read by one residual, come
// straight from device memory into registers, a thread taking pairs of
// adjacent window columns of a row, coalesced along j. Each thread issues
// all its loads (u's copies included) before it uses any. One barrier;
// phase 2 sums each coarse node of the tile from the shared tile as the
// twin sums it (4 centre + 2 edges + corners, over 16), reading the window
// at the 'reflect' fold of its fine rows and columns, and writes 0 off the
// coarse unknowns. Every operation is rounded explicitly in the plain
// twin's order (common.cuh residual_var, restrict_residual_var_at), so I
// equals its twin bit for bit. The windows of neighbouring tiles share one
// fine row and column, so a fine residual is formed a little over once,
// where the direct plan below forms it 2.25 times.
//
// Loads: a bf16 node is one 2-byte load, widened on the spot. On the H100,
// aligned 4-byte word pairs (common.cuh load_word) were 5-20% slower at
// every level (their parity and edge logic cost registers, so fewer blocks
// fit an SM), and 16-byte chunks of all seven arrays staged in shared
// memory about 2x slower (PERF.md, row K7).
//
// Plans: the tile is chosen per level (ops/cuda_kernels/transfer.py
// var_plan, from kVarTiles and the card's SM count): the largest tile
// whose grid gives every SM kVarMinBlocksPerSm blocks, so that the small
// levels still fill the card. On bf16 storage the largest levels (at least
// kVarDirectMinNodesPerSm coarse nodes per SM: 1025 -> 513) take the
// direct plan instead, one thread per coarse node with its nine residuals
// in registers (common.cuh restrict_residual_var_at), whose 2-byte loads
// the neighbouring threads share through L1: there it measured 2-6%
// faster than the best tile.
//
// Bound: device memory bandwidth. Each fine node's u, f and planes are read
// about once from device memory (28 bytes per fine node in fp32, 14 in
// bf16; the halo's re-reads come from L2); 4 (or 2) bytes per coarse node
// are written. The small levels are bound by latency, not bytes (PERF.md,
// row K7).
#include <type_traits>
#include <utility>

#include "common.cuh"

namespace {

// The geometry below is this file's own: mg_residual_restrict_var_geometry
// reports it, ops/cuda_kernels/transfer.py plans with a copy that it checks
// against that report before the first launch, and the CPU schedule test
// reads it from this file.
struct VarTile {
  int tx, ty;   // coarse rows and columns a block owns
  int threads;  // threads a block
};
constexpr VarTile kVarTiles[] = {{8, 16, 128}, {4, 16, 128}, {4, 8, 128}};
constexpr int kVarTileCount = 3;
static_assert(sizeof(kVarTiles) / sizeof(VarTile) == kVarTileCount,
              "kVarTileCount counts kVarTiles");
// A level takes the largest tile whose grid gives every SM at least
// kVarMinBlocksPerSm blocks (else the smallest), and a bf16 level whose
// coarse grid holds at least kVarDirectMinNodesPerSm nodes per SM the
// direct plan (plan kVarTileCount): one thread per coarse node, its nine
// fine residuals in registers, in kDirectX x kDirectY blocks.
constexpr int kVarMinBlocksPerSm = 8;
constexpr int kVarDirectMinNodesPerSm = 1024;
constexpr int kDirectX = 32;
constexpr int kDirectY = 8;

template <int K>
struct VarWin {
  static constexpr int TX = kVarTiles[K].tx, TY = kVarTiles[K].ty;
  static constexpr int NT = kVarTiles[K].threads;
  static constexpr int WX = 2 * TX + 1;  // residual window rows
  static constexpr int WY = 2 * TY + 1;  // residual window columns
  static constexpr int UX = WX + 2;      // u tile: the window and its halo
  static constexpr int UY = WY + 2;
  static constexpr int PAIRS = TY + 1;   // column pairs of a window row
  static constexpr int ITEMS = (WX * PAIRS + NT - 1) / NT;
  static constexpr int ULOADS = (UX * UY + NT - 1) / NT;
  static constexpr int NODES = (TX * TY + NT - 1) / NT;
  static constexpr int BYTES = (UX * UY + WX * WY) * (int)sizeof(float);
  static_assert(BYTES <= 48 * 1024, "a tile's static shared memory");
};

// f and the five planes of a window node, in the order a residual reads
// them.
constexpr int kArrays = 6;

template <int K, class TI, class TO>
__global__ void __launch_bounds__(kVarTiles[K].threads)
    residual_restrict_var_kernel(const TI* __restrict__ u,
                                 const TI* __restrict__ f, PlanesOf<TI> p,
                                 TO* __restrict__ fc, int nx, int ny,
                                 int ncx, int ncy, int sides) {
  using G = VarWin<K>;
  constexpr int TX = G::TX, TY = G::TY, NT = G::NT;
  constexpr bool kBf = std::is_same_v<TI, bf16>;
  __shared__ float us[G::UX * G::UY];  // u, rows wi0 - 1 .., cols wj0 - 1 ..
  __shared__ float rs[G::WX * G::WY];  // residuals, rows wi0 .., cols wj0 ..
  const int I0 = blockIdx.y * TX, J0 = blockIdx.x * TY;
  const int wi0 = 2 * I0 - 1, wj0 = 2 * J0 - 1;
  const Rect fine = unknown_rect(nx, ny, sides);
  const TI* arr[kArrays] = {f, p.c, p.w, p.e, p.s, p.n};

  // phase 0, loads, every one issued before any is used: this thread's u
  // nodes of the tile (fp32: 4-byte cp.async into the tile, zero-filled
  // outside the field; bf16: into registers, widened into the tile after
  // the other loads are issued) and f and the planes at its column pairs
  // (pair w of window row a: columns 2w and 2w + 1), each where its
  // column's residual is formed
  float uv[kBf ? G::ULOADS : 1];
#pragma unroll
  for (int r = 0; r < G::ULOADS; ++r) {
    const int t = threadIdx.x + r * NT;
    const int ua = t / G::UY, uc = t - ua * G::UY;
    const int i = wi0 - 1 + ua, j = wj0 - 1 + uc;
    const bool in = i >= 0 && i < nx && j >= 0 && j < ny;
    if constexpr (kBf)
      uv[r] = t < G::UX * G::UY && in ? load_f(u + (long)i * ny + j) : 0.0f;
    else if (t < G::UX * G::UY)
      cp_async4(us + t, u + (in ? (long)i * ny + j : 0), in);
  }
  if constexpr (!kBf) cp_async_commit();
  int it_a[G::ITEMS];
  float v[G::ITEMS][kArrays][2];
#pragma unroll
  for (int r = 0; r < G::ITEMS; ++r) {
    const int t = threadIdx.x + r * NT;
    const int a = t / G::PAIRS, b0 = 2 * (t - a * G::PAIRS);
    const int i = wi0 + a, j0 = wj0 + b0;
    const bool ok = t < G::WX * G::PAIRS;
    const bool m0 = ok && fine.contains(i, j0);
    const bool m1 = ok && b0 + 1 < G::WY && fine.contains(i, j0 + 1);
    it_a[r] = ok ? a : -1;
    const long x = (long)i * ny + j0;
#pragma unroll
    for (int k = 0; k < kArrays; ++k) {
      v[r][k][0] = m0 ? load_f(arr[k] + x) : 0.0f;
      v[r][k][1] = m1 ? load_f(arr[k] + x + 1) : 0.0f;
    }
  }
  if constexpr (kBf) {
#pragma unroll
    for (int r = 0; r < G::ULOADS; ++r) {
      const int t = threadIdx.x + r * NT;
      if (t < G::UX * G::UY) us[t] = uv[r];
    }
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // phase 1: each window residual once, f - (c u - (w W + e E + s S + n N))
#pragma unroll
  for (int r = 0; r < G::ITEMS; ++r) {
    const int a = it_a[r];
    if (a < 0) continue;
    const int t = threadIdx.x + r * NT;
    const int i = wi0 + a, b0 = 2 * (t - a * G::PAIRS);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + h;
      if (b >= G::WY) continue;
      float res = 0.0f;
      if (fine.contains(i, wj0 + b)) {
        const float* uc = us + (a + 1) * G::UY + b + 1;
        const float nb = nbsum_values(v[r][2][h], v[r][3][h], v[r][4][h],
                                      v[r][5][h], uc[-G::UY], uc[G::UY],
                                      uc[-1], uc[1]);
        res = __fsub_rn(v[r][0][h],
                        __fsub_rn(__fmul_rn(v[r][1][h], uc[0]), nb));
      }
      rs[a * G::WY + b] = res;
    }
  }
  __syncthreads();

  // phase 2: each coarse node of the tile from the window, folded at the
  // field's edges, in the twin's order
  const Rect coarse = unknown_rect(ncx, ncy, sides);
#pragma unroll
  for (int r = 0; r < G::NODES; ++r) {
    const int t = threadIdx.x + r * NT;
    const int x = t / TY, y = t - x * TY;
    const int I = I0 + x, J = J0 + y;
    if (t >= TX * TY || I >= ncx || J >= ncy) continue;
    float out = 0.0f;
    if (coarse.contains(I, J)) {
      int la[3], lb[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        la[d] = (fold(2 * I + d - 1, nx) - wi0) * G::WY;
        lb[d] = fold(2 * J + d - 1, ny) - wj0;
      }
      auto R = [&](int da, int db) { return rs[la[da] + lb[db]]; };
      const float edges =
          __fadd_rn(__fadd_rn(__fadd_rn(R(2, 1), R(0, 1)), R(1, 2)), R(1, 0));
      const float corners =
          __fadd_rn(__fadd_rn(__fadd_rn(R(2, 2), R(0, 2)), R(2, 0)), R(0, 0));
      const float sum = __fadd_rn(
          __fadd_rn(__fmul_rn(4.0f, R(1, 1)), __fmul_rn(2.0f, edges)),
          corners);
      out = __fdiv_rn(sum, 16.0f);
    }
    store_f(fc + (long)I * ncy + J, out);
  }
}

// The direct plan: one thread per coarse node, whose nine fine residuals
// (common.cuh restrict_residual_var_at) are formed in registers from loads
// that the neighbouring threads' windows share through L1.
template <class TI, class TO>
__global__ void residual_restrict_var_direct_kernel(
    const TI* __restrict__ u, const TI* __restrict__ f, PlanesOf<TI> p,
    TO* __restrict__ fc, int nxf, int nyf, int ncx, int ncy, int sides) {
  const int J = blockIdx.x * kDirectX + threadIdx.x;
  const int I = blockIdx.y * kDirectY + threadIdx.y;
  if (I >= ncx || J >= ncy) return;
  float out = 0.0f;
  if (unknown_rect(ncx, ncy, sides).contains(I, J))
    out = restrict_residual_var_at(u, f, p, I, J, nxf, nyf,
                                   unknown_rect(nxf, nyf, sides));
  store_f(fc + (long)I * ncy + J, out);
}

template <int K, class TI, class TO>
cudaError_t launch_plan(const TI* u, const TI* f, const PlanesOf<TI>& p,
                        TO* fc, int nxf, int nyf, int ncx, int ncy,
                        int sides, cudaStream_t t) {
  if constexpr (K == kVarTileCount) {
    const dim3 grid((ncy + kDirectX - 1) / kDirectX,
                    (ncx + kDirectY - 1) / kDirectY);
    residual_restrict_var_direct_kernel<<<grid, dim3(kDirectX, kDirectY), 0,
                                          t>>>(u, f, p, fc, nxf, nyf, ncx,
                                               ncy, sides);
  } else {
    constexpr VarTile tile = kVarTiles[K];
    const dim3 grid((ncy + tile.ty - 1) / tile.ty,
                    (ncx + tile.tx - 1) / tile.tx);
    residual_restrict_var_kernel<K><<<grid, tile.threads, 0, t>>>(
        u, f, p, fc, nxf, nyf, ncx, ncy, sides);
  }
  return cudaGetLastError();
}

// Plan `plan` (a kVarTiles index, or kVarTileCount: the direct plan).
template <class TI, class TO, int... K>
cudaError_t launch_any(int plan, std::integer_sequence<int, K...>,
                       const void* u, const void* f,
                       const void* const* planes, void* fc, int nxf, int nyf,
                       int ncx, int ncy, int sides, cudaStream_t t) {
  const PlanesOf<TI> p{static_cast<const TI*>(planes[0]),
                       static_cast<const TI*>(planes[1]),
                       static_cast<const TI*>(planes[2]),
                       static_cast<const TI*>(planes[3]),
                       static_cast<const TI*>(planes[4])};
  cudaError_t err = cudaErrorInvalidValue;
  ((plan == K ? (err = launch_plan<K>(static_cast<const TI*>(u),
                                       static_cast<const TI*>(f), p,
                                       static_cast<TO*>(fc), nxf, nyf, ncx,
                                       ncy, sides, t),
                 0)
              : 0),
   ...);
  return err;
}

template <class TI, class TO>
cudaError_t residual_restrict_var_typed(const void* u, const void* f,
                                        const void* const* planes, void* fc,
                                        int nxf, int nyf, int ncx, int ncy,
                                        int sides, int plan, cudaStream_t t) {
  return launch_any<TI, TO>(
      plan, std::make_integer_sequence<int, kVarTileCount + 1>{}, u, f,
      planes, fc, nxf, nyf, ncx, ncy, sides, t);
}

}  // namespace

extern "C" {

// fc (ncx, ncy) = R_fw(f - A u) from fine (nxf, nyf) fields and planes; bit
// k of `sides` set means side k of (west, east, south, north) is Dirichlet.
// u, f and the planes are bf16 when `in_bf16`, fc when `out_bf16`, else
// fp32. `plan` indexes kVarTiles, or is kVarTileCount: the direct plan.
int mg_residual_restrict_var(const void* u, const void* f, const void* c,
                             const void* w, const void* e, const void* s,
                             const void* n, void* fc, int nxf, int nyf,
                             int ncx, int ncy, int sides, int in_bf16,
                             int out_bf16, int plan, int device,
                             void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (nxf != 2 * ncx - 1 || nyf != 2 * ncy - 1 || ncx < 3 || ncy < 3)
    return (int)cudaErrorInvalidValue;
  const void* planes[5] = {c, w, e, s, n};
  const cudaStream_t t = (cudaStream_t)stream;
  if (in_bf16)
    return (int)(out_bf16 ? residual_restrict_var_typed<bf16, bf16>(
                                u, f, planes, fc, nxf, nyf, ncx, ncy, sides,
                                plan, t)
                          : residual_restrict_var_typed<bf16, float>(
                                u, f, planes, fc, nxf, nyf, ncx, ncy, sides,
                                plan, t));
  return (int)(out_bf16 ? residual_restrict_var_typed<float, bf16>(
                              u, f, planes, fc, nxf, nyf, ncx, ncy, sides,
                              plan, t)
                        : residual_restrict_var_typed<float, float>(
                              u, f, planes, fc, nxf, nyf, ncx, ncy, sides,
                              plan, t));
}

// The plans, into out[3 + 3 * kVarTileCount]: kVarTileCount,
// kVarMinBlocksPerSm, kVarDirectMinNodesPerSm, then each tile's coarse
// rows, coarse columns and threads.
int mg_residual_restrict_var_geometry(int* out) {
  out[0] = kVarTileCount;
  out[1] = kVarMinBlocksPerSm;
  out[2] = kVarDirectMinNodesPerSm;
  for (int k = 0; k < kVarTileCount; ++k) {
    out[3 + 3 * k] = kVarTiles[k].tx;
    out[4 + 3 * k] = kVarTiles[k].ty;
    out[5 + 3 * k] = kVarTiles[k].threads;
  }
  return 0;
}

}  // extern "C"
