// Connected-component labelling of a trinary map on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel aprilslam_tpu/ops/ccl_pallas.py:_ccl_kernel
// (launched by connected_components_pallas). Contract, per frame of a
// (B, H, W) int8 map with 0 black, 1 white, -1 unknown: every known pixel
// gets the MINIMUM linear index (y * W + x) of its 4-connected same-colour
// component; unknown pixels never merge and get the sentinel H * W. These
// are the converged labels of the reference's min-propagation, bit for bit.
//
// Bound: memory. The least traffic is one int8 read and one int32 write per
// pixel; at the main path's 8 x 500 x 500 that is 10 MB, 0.00299 ms at
// 3.35 TB/s. The TPU kernel kept a whole frame's labels in VMEM for its
// entire relaxation. Here the same idea takes Hopper's form: each tile's
// union-find runs in shared memory, and only pairs of pixels across tile
// borders meet in device memory.
//
// Method: union-find in which a link always points from the larger index to
// the smaller, so each tree's root is its component's minimum index and no
// relabelling pass is needed. Three launches on the caller's stream, no
// scratch buffer (the labels tensor is the global forest):
//   1. ccl_local: one block of 256 threads per 32 x 32 tile, init fused in.
//      Each thread loads one char4 (4 pixels of a row; bytes where W % 4 != 0
//      or a pointer is not aligned; no TMA, since a 500-byte row is not a
//      16-byte stride). Runs of one colour along the tile row are found in
//      registers and by a warp scan over the row's 8 lanes, so every pixel
//      starts out pointing at its run's first pixel. Runs then unite with the
//      row above in a shared-memory forest (shared atomicMin); a link is
//      skipped where the left pixel and the one above it have the colour too,
//      since the left pixel's link joins them already. After a barrier each
//      pixel's label is written once, as the global index of its tile root:
//      inside a tile, local and global indices are both row-major, so the
//      minimum pixel is the same under both. An int4 store when W % 4 == 0.
//   2. ccl_border: one thread per pair of pixels across a tile border (about
//      6 % of the pixels at 500 x 500), uniting the pair's roots in the
//      global forest with atomicMin. A pair is skipped where the pair beside
//      it along the border, inside the same two tiles, has the colour on both
//      sides. Every read of the forest goes to L2 (ld.relaxed.gpu): L1 is not
//      coherent across SMs, and a find walks both chains at once so that
//      their loads overlap.
//   3. ccl_resolve: one thread per 4 pixels reads an int4 of labels, follows
//      each to its root and writes back only where a root moved. It is a
//      launch of its own, so every SM's L1 starts clean; from then on the
//      forest only gains final roots, so the walk goes through L1.
// Finds halve paths with atomicMin, so parent values only ever decrease and
// long chains (serpentine components) shorten as threads walk them. A frame
// of at most 4096 pixels (a single row or column of tiles, say) runs whole in
// one block instead (ccl_small): its union-find lives in shared memory, and
// one launch replaces three whose fixed costs dominate at that size.
//
// What the tiling does about the earlier whole-frame union-find's costs:
// the merge no longer walks a global forest from L2 for every pixel (each
// step a dependent load of hundreds of cycles, each link a global atomic) but
// walks shared memory, and only border pairs touch the global forest; the
// int8 map is read once as char4 instead of three times a byte; and the init
// pass is gone. What is left is latency, not bytes: a tile's unions form
// chains of dependent shared-memory steps, and the border unions and the
// resolve walk chains of dependent L2 or L1 loads.
//
// Tile size: 32 x 32 (kTileH, kTileW below; kTileW a multiple of 4 and at
// most 128, kTileH * kTileW / 4 threads a block). Candidates were timed as
// copies of this file with other constants, side by side with
// tools/ccl_ab.py (NVIDIA H100 80GB HBM3, 700 W; device time per call from a
// replayed CUDA graph, median of 4 turns), on the rendered main-path input
// 8 x 500 x 500, block-random 8 x 500 x 500, serpentine 1 x 500 x 500 and
// all-white 8 x 500 x 500:
//   32 x 32: 22.5 / 21.2 / 23.2 / 23.6 us (sum 90.4)
//   16 x 64: 22.2 / 21.6 / 25.9 / 21.6 us (sum 91.2)
//   64 x 64: 23.8 / 23.4 / 29.8 / 25.9 us (sum 102.8)
// 32 x 32 won on the sum, by 1 % over 16 x 64 and by 12 % over 64 x 64:
// larger tiles shorten the border and resolve launches but lengthen the
// local one more. On the rendered input its launches took 12.6 (ccl_local),
// 5.5 (ccl_border) and 4.6 us (ccl_resolve); a resolve that read through L2
// as the border unions do took 7.7 us.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kTilePixels = kTileH * kTileW;
constexpr int kTileThreads = kTilePixels / 4;
constexpr int kRowLanes = kTileW / 4;  // threads of one tile row: neighbouring lanes of a warp
constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTileW % 4 == 0, "a thread holds 4 pixels of one tile row");
static_assert(kRowLanes <= 32 && (kRowLanes & (kRowLanes - 1)) == 0,
              "a tile row is a power-of-two group of lanes inside one warp");
static_assert(kTileThreads >= 32 && kTileThreads <= 1024, "threads per tile block");

// ---- union-find on a forest in shared or global memory --------------------

// The forest of one tile lives in shared memory; another thread may change it
// at any time, so every read is volatile.
struct SharedLoad {
  __device__ int operator()(const int* p) const { return *static_cast<const volatile int*>(p); }
};

// The global forest: every read goes to L2, since L1 is not coherent across
// SMs.
struct L2Load {
  __device__ int operator()(const int* p) const {
    int v;
    asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
  }
};

// Finds the roots of a and b at once, so that the two chains' loads overlap.
// Finds halve paths with atomicMin: parent values only ever decrease.
template <class Load>
__device__ __forceinline__ void find_pair(int* parent, int& a, int& b, Load load) {
  while (true) {
    const int ua = load(parent + a), ub = load(parent + b);
    if (ua == a && ub == b) return;
    const int ga = ua == a ? a : load(parent + ua);
    const int gb = ub == b ? b : load(parent + ub);
    if (ga != ua) atomicMin(parent + a, ga);
    if (gb != ub) atomicMin(parent + b, gb);
    a = ga, b = gb;
  }
}

template <class Load>
__device__ __forceinline__ void unite(int* parent, int a, int b, Load load) {
  while (true) {
    find_pair(parent, a, b, load);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // a > b: hang root a under b. If a stopped being a root meanwhile,
    // old < a is its new parent; merge that with b instead.
    const int old = atomicMin(parent + a, b);
    if (old == a) return;
    a = old;
  }
}

// Read-only walk, once the forest's unions are complete.
__device__ __forceinline__ int root_of(const int* parent, int x) {
  int up = parent[x];
  while (up != x) {
    x = up;
    up = parent[x];
  }
  return x;
}

// ---- 1. local union-find per tile -----------------------------------------

template <bool kVec>
__global__ void __launch_bounds__(kTileThreads)
    ccl_local(const int8_t* __restrict__ trin, int* __restrict__ labels, int H, int W) {
  __shared__ __align__(16) int parent[kTilePixels];
  __shared__ __align__(16) int8_t colour[kTilePixels];  // -1 outside the frame too
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int lane = threadIdx.x % kRowLanes, ly = threadIdx.x / kRowLanes;
  const int x = x0 + lane * 4, y = y0 + ly, l = ly * kTileW + lane * 4;
  const size_t frame = static_cast<size_t>(blockIdx.z) * H * W;

  int8_t c[4] = {-1, -1, -1, -1};
  if (y < H && x < W) {
    const int8_t* row = trin + frame + static_cast<size_t>(y) * W + x;
    if (kVec) {
      const char4 v = *reinterpret_cast<const char4*>(row);
      c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x + k < W) c[k] = row[k];
    }
  }
  // Every pixel points at the first pixel of its run of one colour along the
  // tile row: in registers among the thread's 4 pixels, then by a scan over
  // the row's lanes. A lane passes its left neighbour's run start through
  // when its 4 pixels are one run that continues from the left.
  int p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = (k > 0 && c[k] >= 0 && c[k] == c[k - 1]) ? p[k - 1] : l + k;
  const int left_c = __shfl_up_sync(kAll, c[3], 1, kRowLanes);  // every lane takes part
  const bool left_same = lane > 0 && c[0] >= 0 && left_c == c[0];
  int pass = left_same && p[3] == l, start = p[3];
#pragma unroll
  for (int d = 1; d < kRowLanes; d *= 2) {
    const int s = __shfl_up_sync(kAll, start, d, kRowLanes);
    const int ps = __shfl_up_sync(kAll, pass, d, kRowLanes);
    if (pass && lane >= d) start = s, pass = ps;
  }
  const int left_start = __shfl_up_sync(kAll, start, 1, kRowLanes);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (left_same && p[k] == l) p[k] = left_start;
  *reinterpret_cast<int4*>(&parent[l]) = make_int4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<char4*>(&colour[l]) = make_char4(c[0], c[1], c[2], c[3]);
  __syncthreads();

  // Runs meet the row above in shared memory.
  if (ly > 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = l + k;
      if (c[k] < 0 || colour[i - kTileW] != c[k]) continue;
      const bool same_left = k > 0 ? c[k - 1] == c[k] : left_same;
      if (same_left && colour[i - 1 - kTileW] == c[k]) continue;  // joined through the left pixel
      unite(parent, i - kTileW, i, SharedLoad());
    }
  }
  __syncthreads();

  if (y >= H || x >= W) return;
  const int n = H * W;
  int g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c[k] < 0) {
      g[k] = n;
    } else if (k > 0 && c[k] == c[k - 1]) {
      g[k] = g[k - 1];
    } else {
      const int root = root_of(parent, l + k);
      g[k] = (y0 + root / kTileW) * W + x0 + root % kTileW;
    }
  }
  int* out = labels + frame + static_cast<size_t>(y) * W + x;
  if (kVec) {
    *reinterpret_cast<int4*>(out) = make_int4(g[0], g[1], g[2], g[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x + k < W) out[k] = g[k];
  }
}

// ---- 2. unions across tile borders ----------------------------------------

// Pairs [0, row_pairs): a tile's top row with the row above it, W per border.
// Pairs [row_pairs, pairs): a tile's left column with the column to its left,
// H per border.
__global__ void __launch_bounds__(kThreads)
    ccl_border(const int8_t* __restrict__ trin, int* labels, int H, int W, int row_pairs,
               int pairs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const size_t frame = static_cast<size_t>(blockIdx.y) * H * W;
  const int8_t* t = trin + frame;
  int a, b;
  if (i < row_pairs) {
    const int x = i % W;
    b = (i / W + 1) * kTileH * W + x;
    a = b - W;
    const int8_t c = t[b];
    if (c < 0 || t[a] != c) return;
    // The pair to the left, in the same tiles, joins these two already.
    if (x % kTileW != 0 && t[b - 1] == c && t[a - 1] == c) return;
  } else {
    const int j = i - row_pairs, y = j % H;
    b = y * W + (j / H + 1) * kTileW;
    a = b - 1;
    const int8_t c = t[b];
    if (c < 0 || t[a] != c) return;
    // The pair above, in the same tiles, joins these two already.
    if (y % kTileH != 0 && t[b - W] == c && t[a - W] == c) return;
  }
  unite(labels + frame, a, b, L2Load());
}

// ---- 3. every pixel to its root -------------------------------------------

// The unions are complete, and the only writes left are of final roots, so a
// stale line can only hold an older ancestor: walking through L1 is safe, and
// threads of one SM that walk the same chain hit L1 instead of L2.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ccl_resolve(int* labels, int n) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  int* parent = labels + static_cast<size_t>(blockIdx.y) * n;
  int v[4];
  if (kVec) {
    const int4 q = __ldcg(reinterpret_cast<const int4*>(parent + i));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < n ? __ldcg(parent + i + k) : n;
  }
  int r[4];
  bool moved = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (v[k] == n) {
      r[k] = n;
    } else if (k > 0 && v[k] == v[k - 1]) {
      r[k] = r[k - 1];
    } else {
      r[k] = root_of(parent, v[k]);
    }
    moved |= r[k] != v[k];
  }
  if (!moved) return;
  if (kVec) {
    *reinterpret_cast<int4*>(parent + i) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n && r[k] != v[k]) parent[i + k] = r[k];
  }
}

// ---- small frames: one launch ---------------------------------------------

// A frame of at most kSmallFrame pixels (a few tiles, such as a single row
// or column) runs whole in one block: its union-find lives in shared memory,
// and one launch replaces the three, whose fixed costs dominate there.
constexpr int kSmallFrame = 4096;
constexpr int kSmallThreads = 1024;

__global__ void __launch_bounds__(kSmallThreads)
    ccl_small(const int8_t* __restrict__ trin, int* __restrict__ labels, int H, int W) {
  __shared__ int parent[kSmallFrame];
  __shared__ int8_t colour[kSmallFrame];
  const int n = H * W;
  const size_t frame = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kSmallThreads) {
    colour[i] = trin[frame + i];
    parent[i] = i;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSmallThreads) {
    const int8_t c = colour[i];
    if (c < 0) continue;
    if (i % W > 0 && colour[i - 1] == c) unite(parent, i - 1, i, SharedLoad());
    if (i >= W && colour[i - W] == c) unite(parent, i - W, i, SharedLoad());
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSmallThreads)
    labels[frame + i] = colour[i] < 0 ? n : root_of(parent, i);
}

}  // namespace

// trinary: (B, H, W) int8 contiguous; labels: (B, H, W) int32 contiguous.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int aprilslam_ccl(const void* trinary, void* labels, int B, int H, int W,
                             void* stream) {
  const int n = H * W;
  if (B <= 0 || n <= 0) return 0;
  const auto* t = static_cast<const int8_t*>(trinary);
  auto* l = static_cast<int*>(labels);
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= kSmallFrame) {
    ccl_small<<<B, kSmallThreads, 0, s>>>(t, l, H, W);
    return static_cast<int>(cudaGetLastError());
  }
  const bool labels16 = reinterpret_cast<uintptr_t>(l) % 16 == 0;
  const dim3 tiles((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 4 == 0 && labels16)
    ccl_local<true><<<tiles, kTileThreads, 0, s>>>(t, l, H, W);
  else
    ccl_local<false><<<tiles, kTileThreads, 0, s>>>(t, l, H, W);
  const int row_pairs = (tiles.y - 1) * W;
  const int pairs = row_pairs + (tiles.x - 1) * H;
  if (pairs > 0) {
    ccl_border<<<dim3((pairs + kThreads - 1) / kThreads, B), kThreads, 0, s>>>(t, l, H, W,
                                                                                row_pairs, pairs);
    const dim3 grid(((n + 3) / 4 + kThreads - 1) / kThreads, B);
    if (n % 4 == 0 && labels16)
      ccl_resolve<true><<<grid, kThreads, 0, s>>>(l, n);
    else
      ccl_resolve<false><<<grid, kThreads, 0, s>>>(l, n);
  }
  return static_cast<int>(cudaGetLastError());
}
