// Launch geometry shared by the constant-coefficient 2D smoothers: kernel A
// (csrc/smooth.cu) and kernels K and L (csrc/smooth_parity.cu).
//
// Each block owns a tile of a level's interior and sweeps a window around
// it in shared memory. A level takes the largest of kTiles whose grid holds
// at least kMinBlocks blocks (about one per SM), else the smallest, and a
// launch takes 1 .. kMaxSweeps sweeps, compiled in. mg_smooth_geometry
// (csrc/smooth.cu) reports these values; ops/cuda_kernels/smooth.py checks
// its launch planning against that report before a level's first launch,
// and the CPU schedule tests read them from this file.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>

struct Tile {
  int x, y;  // interior rows (i) and columns (j, contiguous); both even
};
constexpr Tile kTiles[] = {{64, 64}, {32, 64}, {8, 64}};
constexpr int kNumTiles = 3;
static_assert(sizeof(kTiles) / sizeof(Tile) == kNumTiles);
constexpr int kMinBlocks = 128;  // about one per SM of the H100's 132
constexpr int kThreads = 512;
constexpr int kMaxSweeps = 4;  // sweeps per launch

__host__ __device__ constexpr int blocks_of(int nx, int ny, Tile t) {
  return ((nx - 2 + t.x - 1) / t.x) * ((ny - 2 + t.y - 1) / t.y);
}

// The tile of an (nx, ny) level: an index into kTiles.
inline int tile_of(int nx, int ny) {
  for (int k = 0; k < kNumTiles - 1; ++k)
    if (blocks_of(nx, ny, kTiles[k]) >= kMinBlocks) return k;
  return kNumTiles - 1;
}

template <int k>
using TileIndex = std::integral_constant<int, k>;
template <int s>
using Sweeps = std::integral_constant<int, s>;

template <int k, class F>
cudaError_t with_sweeps(int sweeps, F&& f) {
  static_assert(kMaxSweeps == 4, "one case per sweep count");
  switch (sweeps) {
    case 1:
      return f(TileIndex<k>{}, Sweeps<1>{});
    case 2:
      return f(TileIndex<k>{}, Sweeps<2>{});
    case 3:
      return f(TileIndex<k>{}, Sweeps<3>{});
    default:
      return f(TileIndex<k>{}, Sweeps<4>{});
  }
}

// f(TileIndex<k>{}, Sweeps<s>{}) for the (nx, ny) level's tile k and
// s = sweeps (1 .. kMaxSweeps), so a launcher instantiates its kernel with
// both compiled in.
template <class F>
cudaError_t with_tile_and_sweeps(int nx, int ny, int sweeps, F&& f) {
  static_assert(kNumTiles == 3, "one case per tile");
  switch (tile_of(nx, ny)) {
    case 0:
      return with_sweeps<0>(sweeps, f);
    case 1:
      return with_sweeps<1>(sweeps, f);
    default:
      return with_sweeps<2>(sweeps, f);
  }
}
