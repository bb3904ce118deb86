// Shared pieces of the hand-written Hopper multigrid kernels.
//
// 2D fields are row-major (nx, ny) arrays with the boundary ring included:
// node (i, j) lives at i * ny + j. Only interior nodes 1..nx-2 x 1..ny-2 are
// ever updated, so no access wraps around. Kernels A-J and L take fp32 or
// bf16 storage: they widen what they load to fp32 (load_f), compute in fp32
// and round once per call where they store (store_f, round to nearest even,
// as torch's Tensor.to(torch.bfloat16)). K takes fp32. The 3D layout is
// given with the 3D helpers below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Make `device` current, skipping cudaSetDevice when it already is.
inline cudaError_t use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) == cudaSuccess && cur == device) return cudaSuccess;
  return cudaSetDevice(device);
}

struct Stencil5 {
  float c, w, e, s, n;
};

// w*u[i-1,j] + e*u[i+1,j] + s*u[i,j-1] + n*u[i,j+1], summed left to right as
// the plain PyTorch twin sums it.
template <class T>
__device__ __forceinline__ float neighbor_sum(const T* u, long idx, int ny,
                                              const Stencil5& st) {
  return st.w * load_f(u + idx - ny) + st.e * load_f(u + idx + ny) +
         st.s * load_f(u + idx - 1) + st.n * load_f(u + idx + 1);
}

// True when c > 0 is a normal power of two, so that 1/c is exact in fp32:
// every level of the 2D Poisson paths (c = 4/h^2 on the unit square), no
// shifted heat diagonal (c = 4/h^2 + lam).
__host__ __device__ __forceinline__ bool is_pow2(float c) {
  unsigned b;
  memcpy(&b, &c, sizeof b);
  const unsigned exponent = b >> 23;  // c > 0: no sign bit
  return (b & 0x7FFFFFu) == 0u && exponent >= 1u && exponent <= 253u;
}

// x / c, correctly rounded. With kPow2 (is_pow2(c)) it multiplies by the
// exact 1/c = 2^-e, which equals the quotient bit for bit and costs a
// multiply; without, it divides. Kernels A, D, K and L choose kPow2 per
// launch, so the 2D Poisson paths pay no division.
template <bool kPow2>
__device__ __forceinline__ float div_c(float x, float c) {
  if constexpr (kPow2)
    return __fmul_rn(x, __uint_as_float(0x7F000000u - __float_as_uint(c)));
  else
    return __fdiv_rn(x, c);
}

// Red-black Gauss-Seidel / SOR value of a node from its own value p, its
// right-hand side f and its neighbours W, E, S, N (the nodes at i-1, i+1,
// j-1, j+1): p + omega*((f + (w*W + e*E + s*S + n*N))/c - p), every
// operation rounded explicitly in the Pallas sweep bodies' operand order
// (kernels A, D, K and L). It divides by c (div_c) where the Pallas bodies
// multiply by 1/c rounded to fp32: that reciprocal is inexact unless c is a
// power of two, and its error, one sign for every node, biases the
// converged solution (ops/stencil.divide).
template <bool kPow2>
__device__ __forceinline__ float rbgs_scalar_update(float p, float f, float W,
                                                    float E, float S, float N,
                                                    const Stencil5& st,
                                                    float omega) {
  float acc = __fmul_rn(st.w, W);
  acc = __fadd_rn(acc, __fmul_rn(st.e, E));
  acc = __fadd_rn(acc, __fmul_rn(st.s, S));
  acc = __fadd_rn(acc, __fmul_rn(st.n, N));
  const float gs = div_c<kPow2>(__fadd_rn(f, acc), st.c);
  return __fadd_rn(p, __fmul_rn(omega, __fsub_rn(gs, p)));
}

// Weighted-Jacobi value of a node from the same operands:
// p + (omega*(f - (c*p - (w*W + e*E + s*S + n*N))))/c, every operation
// rounded explicitly in the plain twin's order (kernels A and D).
template <bool kPow2>
__device__ __forceinline__ float jacobi_scalar_update(float p, float f,
                                                      float W, float E,
                                                      float S, float N,
                                                      const Stencil5& st,
                                                      float omega) {
  float acc = __fmul_rn(st.w, W);
  acc = __fadd_rn(acc, __fmul_rn(st.e, E));
  acc = __fadd_rn(acc, __fmul_rn(st.s, S));
  acc = __fadd_rn(acc, __fmul_rn(st.n, N));
  const float r = __fsub_rn(f, __fsub_rn(__fmul_rn(st.c, p), acc));
  return __fadd_rn(p, div_c<kPow2>(__fmul_rn(omega, r), st.c));
}

// f - A u at an interior node.
template <class T>
__device__ __forceinline__ float residual_at(const T* u, const T* f, long idx,
                                             int ny, const Stencil5& st) {
  return load_f(f + idx) -
         (st.c * load_f(u + idx) - neighbor_sum(u, idx, ny, st));
}

// Full-weighting restriction of the residual onto coarse interior node
// (I, J): [1 2 1; 2 4 2; 1 2 1]/16 over the nine fine residuals around
// (2I, 2J), each computed in registers. Same summation order as the plain
// twin (centre, edges, corners).
template <class T>
__device__ __forceinline__ float restrict_residual_at(const T* u, const T* f,
                                                      int I, int J, int nyf,
                                                      const Stencil5& st) {
  const long c = (long)(2 * I) * nyf + 2 * J;
  const float r00 = residual_at(u, f, c, nyf, st);
  const float rp0 = residual_at(u, f, c + nyf, nyf, st);
  const float rm0 = residual_at(u, f, c - nyf, nyf, st);
  const float r0p = residual_at(u, f, c + 1, nyf, st);
  const float r0m = residual_at(u, f, c - 1, nyf, st);
  const float rpp = residual_at(u, f, c + nyf + 1, nyf, st);
  const float rmp = residual_at(u, f, c - nyf + 1, nyf, st);
  const float rpm = residual_at(u, f, c + nyf - 1, nyf, st);
  const float rmm = residual_at(u, f, c - nyf - 1, nyf, st);
  return (4.0f * r00 + 2.0f * (rp0 + rm0 + r0p + r0m) +
          (rpp + rmp + rpm + rmm)) /
         16.0f;
}

// Bilinear interpolant of the coarse field ec (ncx, ncy) at fine node (i, j):
// coincident nodes copy, edge nodes average two, centre nodes average four.
template <class T>
__device__ __forceinline__ float prolong_at(const T* ec, int i, int j,
                                            int ncy) {
  const T* c = ec + (long)(i >> 1) * ncy + (j >> 1);
  const bool oi = i & 1, oj = j & 1;
  if (!oi && !oj) return load_f(c);
  if (!oi) return 0.5f * (load_f(c) + load_f(c + 1));
  if (!oj) return 0.5f * (load_f(c) + load_f(c + ncy));
  return 0.25f *
         (load_f(c) + load_f(c + ncy) + load_f(c + 1) + load_f(c + ncy + 1));
}

// ---------------------------------------------------------------------------
// 3D: fields are row-major (nx, ny, nz) arrays, shell included: node
// (i, j, k) lives at (i * ny + j) * nz + k, z contiguous. Offsets are 64-bit
// (a 513^3 field holds 1.35e8 nodes). The 3D helpers round every product and
// sum explicitly (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never
// contracts into FMAs, in the order the plain PyTorch twins use.

struct Stencil7 {
  float c, w, e, s, n, b, t;
};

// w*u[i-1] + e*u[i+1] + s*u[j-1] + n*u[j+1] + b*u[k-1] + t*u[k+1], left to
// right; sx = ny * nz is the stride of i.
__device__ __forceinline__ float neighbor_sum7(const float* u, long idx,
                                               long sx, int nz,
                                               const Stencil7& st) {
  float acc = __fmul_rn(st.w, u[idx - sx]);
  acc = __fadd_rn(acc, __fmul_rn(st.e, u[idx + sx]));
  acc = __fadd_rn(acc, __fmul_rn(st.s, u[idx - nz]));
  acc = __fadd_rn(acc, __fmul_rn(st.n, u[idx + nz]));
  acc = __fadd_rn(acc, __fmul_rn(st.b, u[idx - 1]));
  return __fadd_rn(acc, __fmul_rn(st.t, u[idx + 1]));
}

// f - (c*u - neighbour sum) at an interior node.
__device__ __forceinline__ float residual7(const float* u, const float* f,
                                           long idx, long sx, int nz,
                                           const Stencil7& st) {
  return __fsub_rn(f[idx], __fsub_rn(__fmul_rn(st.c, u[idx]),
                                     neighbor_sum7(u, idx, sx, nz, st)));
}

// 0.5 * (a + b): one linear-interpolation step of the trilinear prolongation.
__device__ __forceinline__ float half_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// The 3D fields are unpadded (a 513-node row is 2052 bytes), so neither TMA
// nor 16-byte copies can address their rows: the streaming kernels E and F
// bring planes into shared memory with 4-byte cp.async, zero-filled where
// `valid` is false, in commit groups.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One node into a shared fp32 window (kernels A, D, H, J and L): a 4-byte
// cp.async from fp32 storage; from bf16 storage (D, H and J) a load
// widened to fp32 (cp.async copies 4, 8 or 16 bytes, so a 2-byte node
// cannot go that way; A and L load bf16 rows as words, load_windows
// below).
// Either is visible to the block after cp_async_wait and a barrier.
__device__ __forceinline__ void load_shared(float* dst, const float* src) {
  cp_async4(dst, src, true);
}
__device__ __forceinline__ void load_shared(float* dst, const bf16* src) {
  *dst = load_f(src);
}

// bf16 rows of the 3D fields as 4-byte words (kernels E and F). cp.async
// has no 2-byte copy, and a bf16 row of an unpadded field may start in
// either half of a 4-byte word: node k of a row sits at element address
// a + k, whose parity sh, read from the tensor's address (its storage
// offset included), alternates from row to row when nz is odd. So a window
// row (window column c is field column k0 + c) comes in as pairs of aligned
// words: pair m holds columns 4m - sh .. 4m + 3 - sh, and the row's PR
// pairs cover its columns [0, hi) in either case (PR = (hi + 4) / 4). Each
// word is copied by a 4-byte cp.async into a staging ring in shared memory,
// planes ahead of the compute, and the thread that issued a pair widens it
// into the fp32 ring (cp.async.wait_group makes a thread's own copies
// visible to it, so no barrier is needed between): the pair's even columns
// 4m and 4m + 2 are words 2m and 2m + 1 of the row's even half (one 8-byte
// store), its odd columns 4m + 1 - 2sh and 4m + 3 - 2sh words 2m - sh and
// 2m + 1 - sh of the odd half. A node outside the field (a row outside it,
// or a column that reaches into the next row or the previous one) is 0:
// the kernel zeroes its rings once (zero_rings), and a pair writes such a
// word 0 or not at all, the same in every plane. No word is read outside
// the tensor.

// One pair of a thread: fixed for the launch, the same in every plane.
struct BfPair {
  int g;   // in-plane element offset of the row's column 4m (kNoRow: none)
  int fl;  // kPair* bits, ring word (bits 8..19), staging word (20..30);
           // bit 31 free (F marks an odd m there)
};
// Its nodes in the field: columns 4m, 4m + 2 (E0, E1; a node outside the
// field widens to 0); its even ring words 2m, 2m + 1 in the window (WE);
// the odd ring words it writes, each a window word whose node lies in the
// field: 2m - sh (A0 << sh) and 2m + 1 - sh (B0 << sh); and kPairEnd: the
// pair may reach outside the tensor in its first or last plane.
enum : int {
  kPairE0 = 1, kPairE1 = 2, kPairWE = 4, kPairA0 = 8, kPairA1 = 16,
  kPairB0 = 32, kPairB1 = 64, kPairEnd = 128,
};

// In-plane element offset of a window row that lies outside the field.
constexpr int kNoRow = -0x40000000;

// Pair m of a window row: `row` when the row lies in the field, g_row the
// in-plane element offset of its window column 0 (field column k0 of n; sx
// elements to a plane), `half` the words of a ring half-row, ring and stage
// the pair's first words in a ring plane and a staging plane. `valid`
// false: no pair.
__device__ __forceinline__ BfPair bf_pair(bool valid, bool row, int g_row,
                                          int k0, int n, long sx, int m,
                                          int half, int ring, int stage) {
  if (!valid || !row) return {kNoRow, 0};
  // window column c (in the field) lands in ring word `word` of a half
  auto in = [&](int c, int word) {
    return k0 + c >= 0 && k0 + c < n && word >= 0 && word < half;
  };
  const int g = g_row + 4 * m;
  const int fl = (in(4 * m, 2 * m) ? kPairE0 : 0) |
                 (in(4 * m + 2, 2 * m + 1) ? kPairE1 : 0) |
                 (2 * m + 1 < half ? kPairWE : 0) |
                 (in(4 * m + 1, 2 * m) ? kPairA0 | kPairB1 : 0) |
                 (in(4 * m - 1, 2 * m - 1) ? kPairA1 : 0) |
                 (in(4 * m + 3, 2 * m + 1) ? kPairB0 : 0) |
                 (g <= 0 || g + 3 >= sx ? kPairEnd : 0);
  return {g, fl | ring << 8 | stage << 20};
}

// Zero `words` words of shared memory at `p` (16-byte aligned, words a
// multiple of 4), by `threads` threads.
__device__ __forceinline__ void zero_rings(float* p, int words, int threads) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < words / 4; i += threads)
    q[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The word of a bf16 field whose low half is element e (a 4-byte aligned
// address) into the shared word dst: a cp.async where the word lies in the
// field's n elements; where it reaches outside them (e = -1 on a view at an
// odd address, e = n - 1 with the last element in a low half) the node
// inside it by a 2-byte load into its half; nothing where it lies outside.
__device__ __forceinline__ void stage_word(unsigned* dst, const bf16* field,
                                           long e, long n) {
  if (e >= 0 && e + 1 < n) {
    cp_async4(dst, field + e);
  } else if (e == -1 || e == n - 1) {
    unsigned short v;
    asm volatile("ld.global.nc.u16 %0, [%1];\n"
                 : "=h"(v)
                 : "l"(field + (e < 0 ? 0 : e)));
    reinterpret_cast<unsigned short*>(dst)[e < 0 ? 1 : 0] = v;
  }
}

// The two words at element e of a pair that may reach outside the field's
// n elements (kPairEnd), out of line: it runs in a pair's first or last
// plane at most.
static __device__ __noinline__ void stage_pair_ends(unsigned* d,
                                                    const bf16* field,
                                                    long e, long n) {
  stage_word(d, field, e, n);
  stage_word(d + 1, field, e + 2, n);
}

// Pair p of a bf16 plane (element offset pe in the field of n elements; pq
// the parity of the plane's first element address) into staging plane st.
__device__ __forceinline__ void bf_pair_issue(BfPair p,
                                              const bf16* field, long pe,
                                              int pq, long n, unsigned* st) {
  if (p.g == kNoRow) return;
  const long e = pe + p.g - ((pq ^ p.g) & 1);
  unsigned* d = st + ((p.fl >> 20) & 0x7FF);
  if (p.fl & kPairEnd) {
    stage_pair_ends(d, field, e, n);
  } else {
    cp_async4(d, field + e);
    cp_async4(d + 1, field + e + 2);
  }
}

// Pair p of a staged plane st widened into fp32 ring plane `ring` (half:
// the odd half's offset in a ring row; kAligned8 false: st may sit at an
// odd word): its even words (0 outside the field) and its odd words in the
// field. A byte permute moves a word's low (selector 0x1044) or high
// (0x3244) half into the upper half of an fp32 word, zeros below.
template <bool kAligned8 = true>
__device__ __forceinline__ void bf_pair_widen(BfPair p, int pq,
                                              const unsigned* st,
                                              float* ring, int half) {
  const int fl = p.fl, sh = (pq ^ p.g) & 1;
  const unsigned* ws = st + ((fl >> 20) & 0x7FF);
  uint2 w;
  if constexpr (kAligned8) {
    w = *reinterpret_cast<const uint2*>(ws);
  } else {
    w.x = ws[0];
    w.y = ws[1];
  }
  const unsigned se = 0x1044u + sh * 0x2200u, so = 0x3244u - sh * 0x2200u;
  float* r = ring + ((fl >> 8) & 0xFFF);
  if (fl & kPairWE)
    *reinterpret_cast<float2*>(r) = make_float2(
        __uint_as_float(fl & kPairE0 ? __byte_perm(w.x, 0, se) : 0u),
        __uint_as_float(fl & kPairE1 ? __byte_perm(w.y, 0, se) : 0u));
  if (fl & (kPairA0 << sh))
    r[half - sh] = __uint_as_float(__byte_perm(w.x, 0, so));
  if (fl & (kPairB0 << sh))
    r[half + 1 - sh] = __uint_as_float(__byte_perm(w.y, 0, so));
}

// 16-byte rows (kernel F): a window row comes in as the aligned 16-byte
// chunks that hold it, by cp.async.cg (L1 bypassed, a quarter of the
// copies), and its pairs are read from the staged row at a word offset
// taken from the row's address. The thread that copies a chunk is not the
// one that widens its pairs, so a barrier lies between.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Chunk c of a window row whose column 0 is element pe + g of a bf16 field
// (g = kNoRow: a row outside the field): the 16 bytes at 16c past the
// row's column 0 rounded down to 16 bytes, into staging words dst[0..3];
// word by word (stage_word) where `end` says the chunk may reach outside
// the field's n elements.
__device__ __forceinline__ void bf_chunk_issue(int g, int c, bool end,
                                               const bf16* field, long pe,
                                               long n, unsigned* dst) {
  if (g == kNoRow) return;
  const uintptr_t row = reinterpret_cast<uintptr_t>(field + (pe + g));
  const bf16* src = reinterpret_cast<const bf16*>((row & ~uintptr_t(15)) +
                                                  16 * c);
  if (!end) {
    cp_async16(dst, src);
  } else {
    const long e = src - field;
    for (int w = 0; w < 4; ++w) stage_word(dst + w, field, e + 2 * w, n);
  }
}

// 2D bf16 windows (kernels A and L): a block's window row li holds columns
// wj0 .. wj0 + wy - 1 of field row wi0 + li, whose first element e =
// (wi0 + li) * ny + wj0 sits at a byte address a + 2e (a: the tensor's,
// storage offset included). ny is odd on every multigrid level and wj0 is
// odd unless the window is clamped, so a row starts in either half of a
// 4-byte word: its shift sh = ((a / 2) + e) & 1 alternates from row to row.
// A row comes in as the aligned words from element e - sh: word w holds
// columns 2w - sh and 2w + 1 - sh, and (wy + sh + 1) / 2 words hold the
// row. Each thread loads all its words of all its arrays into registers
// before it widens any (load_word: a 4-byte load, or at the tensor's first
// or last element the half inside it, so nothing is read outside the
// tensor), so every load of the window is in flight at once, and widens
// each word into the fp32 window itself (load_windows), which no other
// thread reads before the next barrier. Widening bf16 -> fp32 is exact (the
// bits move up 16), so the window is the one the fp32 path loads.

// Parity of the element address of a bf16 tensor's element 0.
__device__ __forceinline__ int bf_parity(const bf16* field) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(field) >> 1) & 1;
}

// The word of a bf16 tensor of n elements whose low half is element e (a
// 4-byte aligned address), through the read-only cache: a 4-byte load where
// it lies in the tensor; where it reaches outside (e = -1 on a view at an
// odd address, e = n - 1 with the last element in a low half) the element
// inside it by a 2-byte load into its half; 0 where it lies outside.
__device__ __forceinline__ unsigned load_word(const bf16* field, long e,
                                              long n) {
  if (e >= 0 && e + 1 < n)
    return __ldg(reinterpret_cast<const unsigned*>(field + e));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(field);
  if (e == -1) return static_cast<unsigned>(__ldg(h)) << 16;
  if (e == n - 1) return __ldg(h + e);
  return 0u;
}

// The fp32 values of a word's low and high halves.
__device__ __forceinline__ float bf_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(unsigned v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// v to the shared-memory address a (a 32-bit shared-window address, as
// __cvta_generic_to_shared gives) where `pred` holds: a predicated store,
// with no branch and no generic-to-shared conversion per store.
__device__ __forceinline__ void st_shared_if(unsigned a, float v, bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n"
      " @p st.shared.f32 [%0], %1;\n}\n" ::"r"(a),
      "f"(v), "r"(static_cast<unsigned>(pred))
      : "memory");
}

// The window rows of K bf16 arrays src[k] (each an (nx, ny) tensor of n
// elements) into fp32 windows that keep even and odd columns apart, array
// k's at win = dst + k * stride (one shared-memory base, converted once to
// a shared-window address for st_shared_if): column 2m of row li at
// win[row(li) + m], column 2m + 1 at win[row(li) + odd + m]. Item
// r of a thread is word w of window row li, t = threadIdx.x + r * kThreads
// = li * WR + w, WR words a row (at least wy / 2 + 1); the items cover the
// window's rows when kPer * kThreads >= wx * WR. Each word is widened by the
// thread that loaded it, after all of that thread's loads have been
// issued; the windows are the block's to read after its next barrier. A
// block whose words all lie in the tensors loads them with no edge test
// (load_word takes the others).
template <int K, int kPer, int WR, int kThreads, class Row>
__device__ __forceinline__ void load_windows(const bf16* const (&src)[K],
                                             float* dst, int stride, int wi0,
                                             int wj0, int wx, int wy, int nx,
                                             int ny, int odd, Row row) {
  const long n = (long)nx * ny, e0 = (long)wi0 * ny + wj0;
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int pq[K];
  const bf16* org[K];  // the window's first element
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pq[k] = bf_parity(src[k]);
    org[k] = src[k] + e0;
  }
  // the window's words, elements e0 - 1 .. e0 + (wx - 1) ny + 2 WR - 2, lie
  // in the tensors: no edge test
  const bool inside = e0 >= 1 && e0 + (long)(wx - 1) * ny + 2 * WR <= n;
  auto run = [&](auto checked) {
    unsigned v[K][kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int t = threadIdx.x + r * kThreads, li = t / WR, w = t - li * WR;
      if (li >= wx) continue;
      // word w of row li: element e0 + x of the tensor, x = li ny - sh + 2w
      const int ep = (((wi0 + li) & ny) ^ wj0) & 1, x0 = li * ny + 2 * w;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int x = x0 - (pq[k] ^ ep);
        if constexpr (decltype(checked)::value)
          v[k][r] = load_word(src[k], e0 + x, n);
        else
          v[k][r] = __ldg(reinterpret_cast<const unsigned*>(org[k] + x));
      }
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int t = threadIdx.x + r * kThreads, li = t / WR, w = t - li * WR;
      if (li >= wx) continue;
      const int ep = (((wi0 + li) & ny) ^ wj0) & 1, base = row(li) + w;
      const bool even = 2 * w < wy;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // word w holds columns 2w - sh and 2w + 1 - sh: h, the even one low
        const int sh = pq[k] ^ ep, c = 2 * w + 1 - 2 * sh;
        const unsigned h = __funnelshift_l(v[k][r], v[k][r], 16 * sh);
        const unsigned a = s0 + 4 * (k * stride + base);
        st_shared_if(a, bf_lo(h), even);
        st_shared_if(a + 4 * (odd - sh), bf_hi(h), c >= 0 && c < wy);
      }
    }
  };
  if (inside)
    run(std::false_type{});
  else
    run(std::true_type{});
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// First and one-past-last node a tile t of `tile` interior nodes stores
// along an axis of n nodes: its interior nodes, plus the shell node next to
// it at either end.
__device__ __forceinline__ void tile_span(int t, int tile, int n, int* lo,
                                          int* hi) {
  *lo = t == 0 ? 0 : 1 + t * tile;
  *hi = min(1 + (t + 1) * tile, n - 1);
  if (*hi == n - 1) *hi = n;
}

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int device, bool* done) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// ---------------------------------------------------------------------------
// 2D coefficient planes (kernels H, I and J): the five (nx, ny) planes of a
// variable-coefficient or Neumann/Robin stencil, laid out as the fields.
// Every product, sum and quotient is rounded explicitly (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn) in the plain twins' order, so nvcc
// contracts nothing into FMAs and the updates divide by c as the twins do.
// Division happens on unknown nodes only: c may be 0 on a fixed corner.

template <class T>
struct PlanesOf {
  const T *c, *w, *e, *s, *n;
};
using Planes5 = PlanesOf<float>;

// The unknowns of a level are the rectangle [i0, i1) x [j0, j1): a Dirichlet
// side's ring is fixed, a Neumann/Robin side's ring is unknown.
struct Rect {
  int i0, i1, j0, j1;
  __device__ __forceinline__ bool contains(int i, int j) const {
    return i >= i0 && i < i1 && j >= j0 && j < j1;
  }
};

// Bit k of `sides` set: side k of (west, east, south, north) is Dirichlet.
__host__ __device__ __forceinline__ Rect unknown_rect(int nx, int ny,
                                                      int sides) {
  return Rect{sides & 1, nx - ((sides >> 1) & 1), (sides >> 2) & 1,
              ny - ((sides >> 3) & 1)};
}

// w*W + e*E + s*S + n*N, left to right, for the neighbour values W, E, S, N
// at (i-1, j), (i+1, j), (i, j-1), (i, j+1).
__device__ __forceinline__ float nbsum_values(float w, float e, float s,
                                              float n, float W, float E,
                                              float S, float N) {
  float acc = __fmul_rn(w, W);
  acc = __fadd_rn(acc, __fmul_rn(e, E));
  acc = __fadd_rn(acc, __fmul_rn(s, S));
  return __fadd_rn(acc, __fmul_rn(n, N));
}

// Red-black Gauss-Seidel / SOR value of an unknown node from its value uc,
// right-hand side fv, centre coefficient c and neighbour sum nb:
// u + omega*((f + nb)/c - u).
__device__ __forceinline__ float rbgs_var_update(float uc, float fv, float c,
                                                 float nb, float omega) {
  const float gs = __fdiv_rn(__fadd_rn(fv, nb), c);
  return __fadd_rn(uc, __fmul_rn(omega, __fsub_rn(gs, uc)));
}

// Weighted-Jacobi value of an unknown node: u + (omega*(f - (c*u - nb)))/c.
__device__ __forceinline__ float jacobi_var_update(float uc, float fv,
                                                   float c, float nb,
                                                   float omega) {
  const float r = __fsub_rn(fv, __fsub_rn(__fmul_rn(c, uc), nb));
  return __fadd_rn(uc, __fdiv_rn(__fmul_rn(omega, r), c));
}

// w*u[i-1,j] + e*u[i+1,j] + s*u[i,j-1] + n*u[i,j+1], left to right, reading
// zero outside the (nx, ny) array as the twins' zero halo does; u and the
// planes in fp32 or bf16 storage, widened on load.
template <class T>
__device__ __forceinline__ float neighbor_sum_var(const T* u,
                                                  const PlanesOf<T>& p, int i,
                                                  int j, int nx, int ny) {
  const long idx = (long)i * ny + j;
  return nbsum_values(load_f(p.w + idx), load_f(p.e + idx),
                      load_f(p.s + idx), load_f(p.n + idx),
                      i > 0 ? load_f(u + idx - ny) : 0.0f,
                      i < nx - 1 ? load_f(u + idx + ny) : 0.0f,
                      j > 0 ? load_f(u + idx - 1) : 0.0f,
                      j < ny - 1 ? load_f(u + idx + 1) : 0.0f);
}

// f - (c*u - neighbour sum) at node (i, j).
template <class T>
__device__ __forceinline__ float residual_var(const T* u, const T* f,
                                              const PlanesOf<T>& p, int i,
                                              int j, int nx, int ny) {
  const long idx = (long)i * ny + j;
  return __fsub_rn(load_f(f + idx),
                   __fsub_rn(__fmul_rn(load_f(p.c + idx), load_f(u + idx)),
                             neighbor_sum_var(u, p, i, j, nx, ny)));
}

// Fine index k of a restriction window, folded back into the domain where it
// leaves it (row -1 reads row 1, row n reads row n-2): the 'reflect' fold of
// Neumann/Robin rings.
__device__ __forceinline__ int fold(int k, int n) {
  return k < 0 ? -k : (k >= n ? 2 * (n - 1) - k : k);
}

// Full-weighting restriction of the residual onto coarse node (I, J) of a
// fine (nx, ny) level whose unknowns are `fine`: the nine fine residuals of
// the window around (2I, 2J) (zero off the unknowns, folded at the ring) in
// registers, summed as the twin sums them: 4*centre + 2*(edges) + corners,
// over 16.
template <class T>
__device__ __forceinline__ float restrict_residual_var_at(
    const T* u, const T* f, const PlanesOf<T>& p, int I, int J, int nx,
    int ny, const Rect& fine) {
  int ri[3], rj[3];
  float r[3][3];
  for (int d = 0; d < 3; ++d) {
    ri[d] = fold(2 * I + d - 1, nx);
    rj[d] = fold(2 * J + d - 1, ny);
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      r[a][b] = fine.contains(ri[a], rj[b])
                    ? residual_var(u, f, p, ri[a], rj[b], nx, ny)
                    : 0.0f;
  const float edges = __fadd_rn(
      __fadd_rn(__fadd_rn(r[2][1], r[0][1]), r[1][2]), r[1][0]);
  const float corners = __fadd_rn(
      __fadd_rn(__fadd_rn(r[2][2], r[0][2]), r[2][0]), r[0][0]);
  const float sum = __fadd_rn(
      __fadd_rn(__fmul_rn(4.0f, r[1][1]), __fmul_rn(2.0f, edges)), corners);
  return __fdiv_rn(sum, 16.0f);
}
