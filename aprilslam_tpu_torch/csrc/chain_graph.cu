// The chaining graph's per-chunk scan on Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package runs the graph update
// (aprilslam_tpu/slam/graph.py update_graph, estimate_pose_average,
// average_distance_to_nodes) as a lax.scan over a frame's detection slots
// inside the step's scan over frames, and XLA compiles both into the step's
// one program. Eager PyTorch ran the same scan as a Python loop of about 100
// small ops and 21 reads back to the host per slot. This kernel runs a whole
// chunk, B frames of D slots, in one launch, with the semantics of
// aprilslam_tpu_torch/slam/graph.py update_graph and estimate_pose_average
// step for step (that loop stays as the plain version and the reference):
// anchoring at the lowest id seen, re-anchoring (every stored world
// conjugated into the new anchor's frame), the direct, keep and hop cases in
// slot order, the rigid inverse, and at each frame's end the weighted pose
// average before its rotation is projected to SO(3). The projection runs
// after the launch, batched over the B frames, in torch.
//
// Bound: latency. The bytes are a few tens of KB (the inputs, the state and a
// snapshot of it per frame), a few microseconds at 3.35 TB/s; the work is a
// chain of B * D slot updates, each of which reads what the one before it
// wrote. So the design keeps every step on chip and short: one block of one
// warp; the whole graph (local and world, M x 16 floats each, weight,
// present, updated, reference) lives in shared memory for the whole chunk
// (139 * M + 128 bytes: 9,024 at M = 64); lanes 0-15 hold the 16 entries of
// a 4x4 product and the re-anchoring conjugation takes two slots per pass;
// every branch is uniform across the warp (each lane reads the same shared
// scalars), so a slot that is empty or unhandled costs a few loads; the
// state goes to device memory only as each frame's snapshot.
//
// Floats differ from the plain version's in the last bits: the kernel's
// products are fused multiply-adds in its own order, and its sums over slots
// run in two halves across the warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNoAnchor = 1 << 30;  // graph.py NO_ANCHOR
constexpr int kLanes = 32;
constexpr unsigned kAll = 0xffffffffu;

struct Inputs {
  const int* ids;        // (B, D) int32
  const float* T;        // (B, D, 4, 4) camera->tag
  const bool* ok;        // (B, D)
  const float* local;    // (M, 4, 4)
  const float* world;    // (M, 4, 4)
  const float* weight;   // (M,)
  const bool* present;   // (M,)
  const bool* updated;   // (M,)
  const int* reference;  // (M,) int32
  const int* coord;      // () int32 anchor id
  const bool* has_estimate;  // ()
};

struct Outputs {
  float* avg_T;          // (B, 4, 4) weighted average, rotation not projected
  bool* valid;           // (B,)
  bool* visible;         // (B, M)
  bool* present;         // (B, M)
  float* weight;         // (B, M)
  float* local;          // (B, M, 4, 4)
  float* world;          // (B, M, 4, 4)
  int* coord;            // (B,) int32
  long long* n_visible;  // (B,) int64
  long long* n_nodes;    // (B,) int64
  float* dist;           // (B,) mean node distance
  bool* updated;         // (M,) after the last frame
  int* reference;        // (M,) int32 after the last frame
  bool* has_estimate;    // () after the last frame
};

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// Entry (i, j) of A @ B, row-major 4x4s.
__device__ __forceinline__ float mm(const float* A, const float* B, int i, int j) {
  return A[4 * i] * B[j] + A[4 * i + 1] * B[4 + j] + A[4 * i + 2] * B[8 + j] +
         A[4 * i + 3] * B[12 + j];
}

// Entry (i, j) of the rigid inverse [R^T, -R^T t; 0 0 0 1] (se3_inverse).
__device__ __forceinline__ float inv_entry(const float* A, int i, int j) {
  if (i == 3) return j == 3 ? 1.f : 0.f;
  if (j < 3) return A[4 * j + i];
  return -(A[i] * A[3] + A[4 + i] * A[7] + A[8 + i] * A[11]);
}

// The first slot whose (ok) id is x, else 0: argmax(ids == x) in graph.py.
__device__ __forceinline__ int first_slot(const int* ids, const bool* ok, int D, int x, int lane) {
  int f = D;
  for (int d = lane; d < D; d += kLanes)
    if (ok[d] && ids[d] == x) f = min(f, d);
  f = warp_min(f);
  return f == D ? 0 : f;
}

__global__ void __launch_bounds__(kLanes) chain_graph(Inputs in, Outputs out, int B, int D, int M) {
  extern __shared__ float smem[];
  float* local = smem;               // M x 16
  float* world = local + M * 16;     // M x 16
  float* weight = world + M * 16;    // M
  float* S0 = weight + M;            // 4x4 scratch
  float* S1 = S0 + 16;               // 4x4 scratch
  int* reference = reinterpret_cast<int*>(S1 + 16);  // M
  bool* present = reinterpret_cast<bool*>(reference + M);
  bool* updated = present + M;
  bool* seen = updated + M;          // the frame's in-range ids

  const int lane = threadIdx.x;
  const int e = lane & 15, i = e >> 2, j = e & 3;
  const bool mat = lane < 16;

  for (int k = lane; k < M * 16; k += kLanes) {
    local[k] = in.local[k];
    world[k] = in.world[k];
  }
  for (int m = lane; m < M; m += kLanes) {
    weight[m] = in.weight[m];
    reference[m] = in.reference[m];
    present[m] = in.present[m];
    updated[m] = in.updated[m];
  }
  int anchor = *in.coord;
  bool has_estimate = *in.has_estimate;
  __syncwarp();

  for (int b = 0; b < B; ++b) {
    const int* ids = in.ids + static_cast<size_t>(b) * D;
    const bool* ok = in.ok + static_cast<size_t>(b) * D;
    const float* T = in.T + static_cast<size_t>(b) * D * 16;

    // --- the frame's visible ids and their minimum
    for (int m = lane; m < M; m += kLanes) seen[m] = false;
    __syncwarp();
    int min_visible = kNoAnchor;
    for (int d = lane; d < D; d += kLanes) {
      const int id = ids[d];
      if (ok[d] && id >= 0 && id < M) {
        seen[id] = true;
        min_visible = min(min_visible, id);
      }
    }
    min_visible = warp_min(min_visible);
    __syncwarp();

    // --- anchor, and re-anchoring when a strictly lower id is seen: chain
    // the new anchor through the lowest known visible tag r (its detection
    // in this frame) and conjugate every stored world into the new frame.
    // Without such an r the conjugation is by the identity.
    const int old_anchor = anchor;
    anchor = min(old_anchor, min_visible);
    if (old_anchor < kNoAnchor && min_visible < old_anchor) {
      int r = kNoAnchor;
      for (int m = lane; m < M; m += kLanes)
        if (seen[m] && present[m]) r = min(r, m);
      r = warp_min(r);
      if (r < kNoAnchor) {
        const float* T_a = T + 16 * first_slot(ids, ok, D, anchor, lane);
        const float* T_r = T + 16 * first_slot(ids, ok, D, r, lane);
        if (mat) S0[e] = inv_entry(T_r, i, j);
        __syncwarp();
        if (mat) S1[e] = mm(S0, T_a, i, j);  // inv(T_r) @ T_a
        __syncwarp();
        const float w = mm(world + 16 * r, S1, i, j);  // world_a_old
        __syncwarp();
        if (mat) S0[e] = w;
        __syncwarp();
        if (mat) S1[e] = inv_entry(S0, i, j);
        __syncwarp();
        for (int base = 0; base < M; base += 2) {
          const int m = base + (lane >> 4);
          const bool act = m < M && present[m];
          const float v = act ? mm(S1, world + 16 * m, i, j) : 0.f;
          __syncwarp();
          if (act) world[16 * m + e] = v;
          __syncwarp();
        }
      }
    }

    // --- per-detection insert/update in slot order
    const int ref = min_visible;
    const int ref_slot = min(max(ref, 0), M - 1);
    const bool ref_is_anchor = ref == anchor;
    for (int d = 0; d < D; ++d) {
      const int tag = ids[d];
      if (!ok[d] || tag < 0 || tag >= M) continue;
      const bool is_anchor = tag == anchor;
      const bool ref_known = present[ref_slot] && ref != tag;
      const bool direct = !is_anchor && ref_is_anchor && ref_known;
      const bool keep = !is_anchor && !direct && present[tag] && reference[tag] == anchor;
      const bool hop = !is_anchor && !direct && !keep && ref_known;
      if (!(is_anchor || direct || keep || hop)) continue;
      const float* Td = T + 16 * d;
      float w_new;
      if (is_anchor) {
        w_new = i == j ? 1.f : 0.f;
      } else if (keep) {
        w_new = world[16 * tag + e];
      } else {
        w_new = mm(local + 16 * ref_slot, Td, i, j);  // w_direct
        if (hop) {
          if (mat) S0[e] = w_new;
          __syncwarp();
          w_new = mm(world + 16 * ref_slot, S0, i, j);
        }
      }
      const float l_new = inv_entry(Td, i, j);
      const float wt = (is_anchor || direct) ? 1.f : keep ? weight[tag] : weight[ref_slot] + 1.f;
      const int rf = is_anchor ? tag : (direct || keep) ? anchor : reference[ref_slot];
      __syncwarp();
      if (mat) {
        local[16 * tag + e] = l_new;
        world[16 * tag + e] = w_new;
      }
      if (lane == 0) {
        weight[tag] = wt;
        present[tag] = true;
        updated[tag] = !keep;
        reference[tag] = rf;
      }
      __syncwarp();
    }

    // --- the frame's pose average and node statistics, and its snapshot
    float sum = 0.f;
    for (int base = 0; base < M; base += 2) {
      const int m = base + (lane >> 4);
      if (m < M && seen[m] && present[m])
        sum += (1.f / weight[m]) * mm(world + 16 * m, local + 16 * m, i, j);
    }
    sum += __shfl_xor_sync(kAll, sum, 16);
    float count = 0.f, dist = 0.f;
    int n_visible = 0, n_nodes = 0;
    const size_t bm = static_cast<size_t>(b) * M;
    for (int m = lane; m < M; m += kLanes) {
      const bool vis = seen[m] && present[m];
      if (vis) {
        count += 1.f / weight[m];
        ++n_visible;
      }
      if (present[m]) {
        const float* L = local + 16 * m;
        dist += sqrtf(L[3] * L[3] + L[7] * L[7] + L[11] * L[11]);
        ++n_nodes;
      }
      out.visible[bm + m] = vis;
      out.present[bm + m] = present[m];
      out.weight[bm + m] = weight[m];
    }
    for (int k = lane; k < M * 16; k += kLanes) {
      out.local[bm * 16 + k] = local[k];
      out.world[bm * 16 + k] = world[k];
    }
    count = warp_sum(count);
    dist = warp_sum(dist);
    n_visible = warp_sum(n_visible);
    n_nodes = warp_sum(n_nodes);
    const bool valid = count > 0.f;
    if (mat) out.avg_T[16 * b + e] = sum / (valid ? count : 1.f);
    if (lane == 0) {
      out.valid[b] = valid;
      out.coord[b] = anchor;
      out.n_visible[b] = n_visible;
      out.n_nodes[b] = n_nodes;
      out.dist[b] = dist / static_cast<float>(max(n_nodes, 1));
    }
    has_estimate = has_estimate || valid;
    __syncwarp();  // every lane's reads of seen before the next frame clears it
  }

  for (int m = lane; m < M; m += kLanes) {
    out.updated[m] = updated[m];
    out.reference[m] = reference[m];
  }
  if (lane == 0) *out.has_estimate = has_estimate;
}

// Does nothing: the floor a launch of one warp costs, for the timing.
__global__ void empty_launch() {}

}  // namespace

// in: the 11 pointers of Inputs, out: the 14 of Outputs, in their order.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int aprilslam_chain_graph(void* const* in, void* const* out, int B, int D, int M,
                                     void* stream) {
  const Inputs ins{static_cast<const int*>(in[0]),   static_cast<const float*>(in[1]),
                   static_cast<const bool*>(in[2]),  static_cast<const float*>(in[3]),
                   static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
                   static_cast<const bool*>(in[6]),  static_cast<const bool*>(in[7]),
                   static_cast<const int*>(in[8]),   static_cast<const int*>(in[9]),
                   static_cast<const bool*>(in[10])};
  const Outputs outs{static_cast<float*>(out[0]),     static_cast<bool*>(out[1]),
                     static_cast<bool*>(out[2]),      static_cast<bool*>(out[3]),
                     static_cast<float*>(out[4]),     static_cast<float*>(out[5]),
                     static_cast<float*>(out[6]),     static_cast<int*>(out[7]),
                     static_cast<long long*>(out[8]), static_cast<long long*>(out[9]),
                     static_cast<float*>(out[10]),    static_cast<bool*>(out[11]),
                     static_cast<int*>(out[12]),      static_cast<bool*>(out[13])};
  const int smem = 139 * M + 128;  // the layout at the top of chain_graph
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(chain_graph, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chain_graph<<<1, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(ins, outs, B, D, M);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the empty kernel on `stream`; returns cudaGetLastError().
extern "C" int aprilslam_empty_launch(void* stream) {
  empty_launch<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
