// K1, K2 and K4: the HoVer-Net post-processing tail, the standalone
// marker watershed, and the tail's stage-ablation variants, on Hopper
// (sm_90a). One library, built by hover_net_tpu_torch/ops/nvcc_build.py.
//
// K1 (`hnt_proc_tail`, skip = 0).
// Replaces the TPU's Pallas kernel `_make_kernel` in
// hover_net_tpu/ops/post_proc_pallas.py (launched by `proc_tail_blocked`
// through `pl.pallas_call`). Input: the thresholded nuclei mask `blb`
// (uint8 0/1) and the Sobel energy `sob` (float32), [N, H, W]. Output:
// int32 [N, H, W] seed-index labels (the seed pixel's linear index in its
// map + 1), equal to those of the plain version
// (hover_net_tpu_torch/ops/post_proc_cuda.py::proc_tail_reference) and of
// the JAX exact path, proc_np_hv_batch(exact=True).
//
// Stages, each one or more launches on the caller's stream:
//   1. blob CCL (union-find, min root) and removal of components under
//      `blob_min_size` pixels (sizes by atomicAdd);
//   2. overall / dist, the 3x3 Gaussian (rows, then columns, reflect-101)
//      and 65536-level quantisation, and marker = blob & overall < 0.4;
//   3. fill-holes: CCL of the marker background, flags on the components
//      that touch the map border, fill the rest;
//   4. 5x5 ellipse opening: erode with outside = foreground, then dilate
//      with outside = background;
//   5. marker CCL and removal of markers under `marker_min_size` pixels;
//   6. watershed phase 1: relax the packed cost (level << 15 | hops) to
//      its fixpoint;
//   7. watershed phase 2: relax (total hops << 32 | label) along the
//      edges that attain the fixed cost, to its fixpoint.
//
// What bounds it on this card. The TPU kernel cut the map into halo
// windows to fit VMEM; here each map is solved whole: at 1148^2 one int32
// plane is 5.3 MB, and the whole working set (~31 bytes a pixel, 41 MB)
// stays in the 50 MB L2. The CCL stages are a fixed handful of launches.
// The two watershed phases are fixpoint loops: one launch is one sweep,
// reading ~25 bytes a pixel (L2 traffic of ~33 MB a sweep at 1148^2, some
// tens of microseconds), and the host reads a device changed-flag after
// every sweep to decide whether to go on. The number of sweeps is about
// the longest optimal path in hops inside a blob (a nucleus diameter), so
// the time is sweeps x (launch + flag round trip) more than bytes. The
// design does two things about it: one thread per pixel relaxes IN PLACE
// (Gauss-Seidel rather than Jacobi), so a value can travel several pixels
// in one sweep, and nothing leaves L2 between sweeps. Block-local
// relaxation in shared memory and a persistent cooperative kernel without
// host round trips are left for later.
//
// In-place (chaotic) relaxation is legal because both phases relax a
// monotone operator from the top of a finite lattice, so every sweep
// order reaches the same unique fixpoint (hover_net_tpu/ops/
// post_proc_device.py, watershed_flood). `sweep_order` permutes the
// thread-to-pixel map of the relaxation sweeps so that a test can show it
// (0 raster, 1 reversed, 2 strided by a prime).
//
// K4 (`hnt_proc_tail`, skip > 0) replaces the TPU kernel `kernel` inside
// `make_variant` of scripts/probe_pp_stages.py: K1 with one stage left
// out, to time the stages on this card. skip = 1 (ws) returns the marker
// labels with no watershed; 2 (ws_phase2) runs phase 1 only and returns
// blob & cost reached ? seed label + (cost & 0xFF) : 0; 3 (rmsmall)
// skips both small-object removals; 4 (fill) skips fill-holes; 5 (open)
// skips the 5x5 opening. skip = 0 launches exactly K1's kernels. Unlike
// the TPU probe, whose blur fills zeros at its window edge, K4 blurs as
// K1 does (reflect-101), because it exists to time K1's stages.
//
// K2 (`hnt_watershed`) replaces the TPU kernel `_kernel` of
// hover_net_tpu/ops/watershed_pallas.py (`watershed_pallas`): the marker
// watershed alone, on int32 quantised energy, int32 markers (any positive
// label) and a uint8 flood mask. It is K1's stages 6 and 7 behind its own
// seed pass (`ws_seed`: seeded = marker > 0 && mask, cost = seeded ?
// energy << 15 : INT_MAX, packed = seeded ? marker : INT_MAX << 32) and
// K1's final pass (`ws_final`: mask ? label : 0). The packed phase-2 word
// (hops << 32) | label compares as unsigned, and a positive int32 label
// orders the same as unsigned, so ties still go to the smallest label, as
// in `_label_sweep`. The TPU kernel relaxes synchronously (Jacobi) and K2
// in place, as K1 does; both reach the same unique fixpoint (below).
// Bound on this card: bytes, 13 per pixel in and out (energy, markers,
// mask, labels); like K1's watershed it spends its time in sweeps x
// (launch + flag round trip). The TPU kernel had to fit one map in VMEM
// (<= ~512^2); K2 takes any n * h * w < 2^31.
//
// Float rounding. The float stages must round exactly as the plain
// PyTorch version does, so every float operation is an explicit
// round-to-nearest intrinsic (no FMA contraction; the library is also
// built with -fmad=false), the blur keeps the plain version's order
// ((0.25*a + 0.5*b) + 0.25*c, rows first), and quantisation uses rintf
// (round half to even, like torch.round).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIntMax = 0x7fffffff;
constexpr int kHopBits = 15;
constexpr int kHopMask = (1 << kHopBits) - 1;
constexpr int kThreads = 256;
constexpr int64_t kStride = 7919;  // prime; sweep_order 2
// returned when a relaxation exceeds its sweep bound (not a cudaError_t)
constexpr int kNoFixpoint = 100000;
// K4's `skip` codes (ops/post_proc_cuda.py SKIPS)
enum Skip { kSkipNone, kSkipWs, kSkipWsPhase2, kSkipRmsmall, kSkipFill,
            kSkipOpen, kSkipCount };

// cv2.getStructuringElement(MORPH_ELLIPSE, (5, 5))
__constant__ unsigned char kSelem[5][5] = {
    {0, 0, 1, 0, 0}, {1, 1, 1, 1, 1}, {1, 1, 1, 1, 1},
    {1, 1, 1, 1, 1}, {0, 0, 1, 0, 0}};
constexpr int kSelemTotal = 17;

struct Geom {
  int h, w;
  int64_t hw, total;
};

__device__ __forceinline__ bool in_mask(const uint8_t* mask, int pol,
                                        int64_t i) {
  return (mask[i] != 0) == (pol != 0);
}

// ---------------------------------------------------------------- CCL
// Union-find over global pixel indices with parent[x] <= x: every root is
// the minimum index of its set, i.e. the component's first raster pixel.

__device__ __forceinline__ int find_root(const int* parent, int x) {
  const volatile int* p = parent;
  int nx = p[x];
  while (nx != x) {
    x = nx;
    nx = p[x];
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  for (;;) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(&parent[b], a);
    if (old == b) return;  // b was a root and now hangs below a
    b = old;               // b had been re-linked: unite a with that
  }
}

__global__ void ccl_init(int* parent, int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < total) parent[i] = (int)i;
}

__global__ void ccl_merge(const uint8_t* mask, int pol, int* parent, Geom g) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= g.total || !in_mask(mask, pol, i)) return;
  int64_t p = i % g.hw;
  int y = (int)(p / g.w), x = (int)(p - (int64_t)y * g.w);
  if (x > 0 && in_mask(mask, pol, i - 1)) unite(parent, (int)i, (int)i - 1);
  if (y > 0 && in_mask(mask, pol, i - g.w))
    unite(parent, (int)i, (int)(i - g.w));
}

__global__ void ccl_flatten(const uint8_t* mask, int pol, int* parent,
                            int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < total && in_mask(mask, pol, i)) parent[i] = find_root(parent, (int)i);
}

__global__ void count_sizes(const uint8_t* mask, int pol, const int* parent,
                            int* cnt, int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < total && in_mask(mask, pol, i)) atomicAdd(&cnt[parent[i]], 1);
}

// min_size <= 0 keeps every component (then `cnt` is not read)
__global__ void keep_large(const uint8_t* mask, const int* parent,
                           const int* cnt, int min_size, uint8_t* out,
                           int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < total)
    out[i] = mask[i] && (min_size <= 0 || cnt[parent[i]] >= min_size);
}

// ------------------------------------------------------------- energy

__global__ void energy_dist(const float* sob, const uint8_t* blob, float* dist,
                            uint8_t* marker, int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  float bf = blob[i] ? 1.0f : 0.0f;
  float overall = fmaxf(__fsub_rn(sob[i], __fsub_rn(1.0f, bf)), 0.0f);
  dist[i] = __fmul_rn(__fsub_rn(1.0f, overall), bf);
  marker[i] = blob[i] && !(overall >= 0.4f);
}

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float blur3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.5f, b)),
                   __fmul_rn(0.25f, c));
}

// the row pass of the blur at (y, x): along the rows (vertical)
__device__ __forceinline__ float row_blur(const float* d, int y, int x,
                                          Geom g) {
  return blur3(d[(int64_t)reflect101(y - 1, g.h) * g.w + x],
               d[(int64_t)y * g.w + x],
               d[(int64_t)reflect101(y + 1, g.h) * g.w + x]);
}

__global__ void blur_quantize(const float* dist, int* energy_sh, Geom g) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= g.total) return;
  int64_t b = i / g.hw, p = i - b * g.hw;
  int y = (int)(p / g.w), x = (int)(p - (int64_t)y * g.w);
  const float* d = dist + b * g.hw;
  float blur = blur3(row_blur(d, y, reflect101(x - 1, g.w), g),
                     row_blur(d, y, x, g),
                     row_blur(d, y, reflect101(x + 1, g.w), g));
  // energy = round((-blur + 1) * 65535): the fixed [-1, 0] range of -blur
  float q = rintf(__fmul_rn(__fadd_rn(-blur, 1.0f), 65535.0f));
  energy_sh[i] = (int)q << kHopBits;
}

// --------------------------------------------------------- fill-holes

__global__ void border_touch(const uint8_t* marker, const int* parent,
                             int* touch, Geom g) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= g.total || marker[i]) return;
  int64_t p = i % g.hw;
  int y = (int)(p / g.w), x = (int)(p - (int64_t)y * g.w);
  if (y == 0 || y == g.h - 1 || x == 0 || x == g.w - 1) touch[parent[i]] = 1;
}

__global__ void fill_enclosed(uint8_t* marker, const int* parent,
                              const int* touch, int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < total && !marker[i] && !touch[parent[i]]) marker[i] = 1;
}

// ------------------------------------------------------------ opening

// outside = `fill`; erode: all taps set, dilate: any tap set
template <bool kErode>
__global__ void morph5(const uint8_t* src, uint8_t* dst, Geom g) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= g.total) return;
  int64_t b = i / g.hw, p = i - b * g.hw;
  int y = (int)(p / g.w), x = (int)(p - (int64_t)y * g.w);
  const uint8_t* s = src + b * g.hw;
  int cnt = 0;
  for (int dy = 0; dy < 5; ++dy) {
    for (int dx = 0; dx < 5; ++dx) {
      if (!kSelem[dy][dx]) continue;
      int yy = y + dy - 2, xx = x + dx - 2;
      bool inside = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
      cnt += inside ? (s[(int64_t)yy * g.w + xx] != 0) : (kErode ? 1 : 0);
    }
  }
  dst[i] = kErode ? (cnt >= kSelemTotal) : (cnt > 0);
}

// ---------------------------------------------------------- watershed

__device__ __forceinline__ int cross_cost(int q_c, int energy_sh) {
  int lev = q_c & ~kHopMask;
  return energy_sh > lev ? energy_sh : q_c + ((q_c & kHopMask) != kHopMask);
}

// the marker label of pixel i after removal: 1 + its component's first
// pixel in the map, or 0 (min_size <= 0 keeps every component)
__device__ __forceinline__ int marker_label(const uint8_t* marker,
                                            const int* parent, const int* cnt,
                                            int min_size, int64_t i, Geom g) {
  if (!marker[i] || (min_size > 0 && cnt[parent[i]] < min_size)) return 0;
  return (int)(parent[i] - i / g.hw * g.hw + 1);
}

__global__ void ws_init(const uint8_t* marker, const int* parent,
                        const int* cnt, int min_size, const uint8_t* blob,
                        const int* energy_sh, int* cost,
                        unsigned long long* packed, Geom g) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= g.total) return;
  int lab = marker_label(marker, parent, cnt, min_size, i, g);
  bool seeded = lab > 0 && blob[i];
  cost[i] = seeded ? energy_sh[i] : kIntMax;
  packed[i] = seeded ? (unsigned long long)lab
                     : ((unsigned long long)kIntMax << 32);
}

// K2's seed pass: arbitrary positive int32 markers inside `mask`
__global__ void ws_seed(const int* energy_q, const int* markers,
                        const uint8_t* mask, int* energy_sh, int* cost,
                        unsigned long long* packed, int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  int m = markers[i];
  bool seeded = m > 0 && mask[i];
  int e = (int)((unsigned)energy_q[i] << kHopBits);
  energy_sh[i] = e;
  cost[i] = seeded ? e : kIntMax;
  packed[i] = seeded ? (unsigned long long)(unsigned)m
                     : ((unsigned long long)kIntMax << 32);
}

__device__ __forceinline__ int64_t sweep_index(int64_t t, int64_t total,
                                               int order) {
  if (order == 1) return total - 1 - t;
  if (order == 2) return (t * kStride) % total;
  return t;
}

__global__ void ws_cost_sweep(int* cost, const int* energy_sh,
                              const uint8_t* blob, Geom g, int order,
                              int* changed) {
  int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= g.total) return;
  int64_t i = sweep_index(t, g.total, order);
  if (!blob[i]) return;
  int64_t p = i % g.hw;
  int y = (int)(p / g.w), x = (int)(p - (int64_t)y * g.w);
  volatile int* c = cost;
  int e = energy_sh[i], own = c[i], best = own;
  if (x > 0) best = min(best, cross_cost(c[i - 1], e));
  if (x < g.w - 1) best = min(best, cross_cost(c[i + 1], e));
  if (y > 0) best = min(best, cross_cost(c[i - g.w], e));
  if (y < g.h - 1) best = min(best, cross_cost(c[i + g.w], e));
  if (best < own) {
    c[i] = best;
    *changed = 1;
  }
}

// the (hops, label) offer of neighbour q to a pixel of cost `own_cost`
__device__ __forceinline__ void offer(const int* cost,
                                      const volatile unsigned long long* pk,
                                      int64_t q, int e, int own_cost,
                                      unsigned long long* best) {
  int q_c = cost[q];
  if (q_c == kIntMax || cross_cost(q_c, e) != own_cost) return;
  unsigned long long v = pk[q];
  if ((unsigned)v == 0u || (v >> 32) == (unsigned long long)kIntMax) return;
  v += 1ull << 32;
  if (v < *best) *best = v;
}

__global__ void ws_label_sweep(const int* cost, const int* energy_sh,
                               const uint8_t* blob, unsigned long long* packed,
                               Geom g, int order, int* changed) {
  int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= g.total) return;
  int64_t i = sweep_index(t, g.total, order);
  if (!blob[i] || cost[i] == kIntMax) return;
  int64_t p = i % g.hw;
  int y = (int)(p / g.w), x = (int)(p - (int64_t)y * g.w);
  volatile unsigned long long* pk = packed;
  int e = energy_sh[i], c = cost[i];
  unsigned long long own = pk[i], best = own;
  if (x > 0) offer(cost, pk, i - 1, e, c, &best);
  if (x < g.w - 1) offer(cost, pk, i + 1, e, c, &best);
  if (y > 0) offer(cost, pk, i - g.w, e, c, &best);
  if (y < g.h - 1) offer(cost, pk, i + g.w, e, c, &best);
  if (best < own) {
    pk[i] = best;
    *changed = 1;
  }
}

__global__ void ws_final(const uint8_t* blob, const unsigned long long* packed,
                         int* out, int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < total)
    out[i] = blob[i] ? (int)(unsigned)(packed[i] & 0xffffffffull) : 0;
}

// K4, skip = ws: the marker labels, no watershed
__global__ void marker_out(const uint8_t* marker, const int* parent,
                           const int* cnt, int min_size, int* out, Geom g) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < g.total) out[i] = marker_label(marker, parent, cnt, min_size, i, g);
}

// K4, skip = ws_phase2: phase 1 only; `packed` still holds the seeds
__global__ void phase1_out(const uint8_t* blob, const int* cost,
                           const unsigned long long* packed, int* out,
                           int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  int c = cost[i];
  out[i] = (blob[i] && c != kIntMax)
               ? (int)(unsigned)(packed[i] & 0xffffffffull) + (c & 0xFF) : 0;
}

// -------------------------------------------------------------- host

struct Workspace {
  unsigned long long* packed;
  int *parent, *cnt, *energy_sh, *cost, *flag;
  float* dist;
  uint8_t *blob, *marker, *tmp;
};

// carve the workspace out of `base` (null: only count); returns its size
int64_t carve(char* base, int64_t total, Workspace* ws) {
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    char* r = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return r;
  };
  Workspace w;
  w.packed = (unsigned long long*)take(total * 8);
  w.parent = (int*)take(total * 4);
  w.cnt = (int*)take(total * 4);
  w.energy_sh = (int*)take(total * 4);
  w.cost = (int*)take(total * 4);
  w.dist = (float*)take(total * 4);
  w.blob = (uint8_t*)take(total);
  w.marker = (uint8_t*)take(total);
  w.tmp = (uint8_t*)take(total);
  w.flag = (int*)take(4);
  if (ws) *ws = w;
  return off;
}

// K2's workspace: the watershed state only
struct WsWorkspace {
  unsigned long long* packed;
  int *energy_sh, *cost, *flag;
};

int64_t carve_ws(char* base, int64_t total, WsWorkspace* ws) {
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    char* r = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return r;
  };
  WsWorkspace w;
  w.packed = (unsigned long long*)take(total * 8);
  w.energy_sh = (int*)take(total * 4);
  w.cost = (int*)take(total * 4);
  w.flag = (int*)take(4);
  if (ws) *ws = w;
  return off;
}

cudaError_t ccl(const uint8_t* mask, int pol, int* parent, Geom g,
                unsigned blocks, cudaStream_t s) {
  ccl_init<<<blocks, kThreads, 0, s>>>(parent, g.total);
  ccl_merge<<<blocks, kThreads, 0, s>>>(mask, pol, parent, g);
  ccl_flatten<<<blocks, kThreads, 0, s>>>(mask, pol, parent, g.total);
  return cudaGetLastError();
}

cudaError_t sizes(const uint8_t* mask, const int* parent, int* cnt, Geom g,
                  unsigned blocks, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(cnt, 0, g.total * sizeof(int), s);
  if (err != cudaSuccess) return err;
  count_sizes<<<blocks, kThreads, 0, s>>>(mask, 1, parent, cnt, g.total);
  return cudaGetLastError();
}

// launch `sweep` until a sweep changes nothing (host reads the flag);
// a fixpoint takes at most one sweep per pixel of the longest path, so
// more sweeps than pixels means a fault, reported as kNoFixpoint
template <typename Sweep>
int relax(int* flag, int64_t max_sweeps, cudaStream_t s, Sweep sweep) {
  for (int64_t k = 0; k <= max_sweeps; ++k) {
    cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
    if (err != cudaSuccess) return err;
    sweep();
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    int changed = 0;
    err = cudaMemcpyAsync(&changed, flag, sizeof(int), cudaMemcpyDeviceToHost,
                          s);
    if (err != cudaSuccess) return err;
    if ((err = cudaStreamSynchronize(s)) != cudaSuccess) return err;
    if (!changed) return cudaSuccess;
  }
  return kNoFixpoint;
}

// watershed phase 1: relax the packed cost over `mask` to its fixpoint
int relax_cost(int* cost, const int* energy_sh, const uint8_t* mask,
               int* flag, Geom g, unsigned blocks, int order, cudaStream_t s) {
  return relax(flag, g.total + 1, s, [&] {
    ws_cost_sweep<<<blocks, kThreads, 0, s>>>(cost, energy_sh, mask, g, order,
                                              flag);
  });
}

// watershed phase 2: (hops, label) ties along cost-attaining edges
int relax_labels(const int* cost, const int* energy_sh, const uint8_t* mask,
                 unsigned long long* packed, int* flag, Geom g,
                 unsigned blocks, int order, cudaStream_t s) {
  return relax(flag, g.total + 1, s, [&] {
    ws_label_sweep<<<blocks, kThreads, 0, s>>>(cost, energy_sh, mask, packed,
                                               g, order, flag);
  });
}

}  // namespace

extern "C" int64_t hnt_proc_tail_workspace_bytes(int64_t total) {
  return carve(nullptr, total, nullptr);
}

extern "C" const char* hnt_error_string(int err) {
  if (err == kNoFixpoint) return "watershed relaxation did not converge";
  return cudaGetErrorString((cudaError_t)err);
}

// blb uint8 [n, h, w], sob float32 [n, h, w] -> out int32 [n, h, w];
// workspace: hnt_proc_tail_workspace_bytes(n * h * w) bytes, 256-aligned;
// skip: a Skip code (0 = the whole tail, K1). Returns 0 or a cudaError_t.
extern "C" int hnt_proc_tail(const void* blb_p, const void* sob_p, void* out_p,
                             void* ws_p, int n, int h, int w,
                             int marker_min_size, int blob_min_size,
                             int sweep_order, int skip, void* stream) {
  const uint8_t* blb = (const uint8_t*)blb_p;
  const float* sob = (const float*)sob_p;
  int* out = (int*)out_p;
  cudaStream_t s = (cudaStream_t)stream;
  Geom g{h, w, (int64_t)h * w, (int64_t)n * h * w};
  unsigned blocks = (unsigned)((g.total + kThreads - 1) / kThreads);
  Workspace ws;
  carve((char*)ws_p, g.total, &ws);
  if (skip < 0 || skip >= kSkipCount) return cudaErrorInvalidValue;
  // skip = rmsmall: no size counts, every component kept
  bool rm = skip != kSkipRmsmall;
  int blob_min = rm ? blob_min_size : 0, marker_min = rm ? marker_min_size : 0;
  cudaError_t err;
  int rc;

  // 1. blob CCL + small-object removal
  if ((err = ccl(blb, 1, ws.parent, g, blocks, s))) return err;
  if (rm && (err = sizes(blb, ws.parent, ws.cnt, g, blocks, s))) return err;
  keep_large<<<blocks, kThreads, 0, s>>>(blb, ws.parent, ws.cnt, blob_min,
                                         ws.blob, g.total);
  // 2. energy and raw markers
  energy_dist<<<blocks, kThreads, 0, s>>>(sob, ws.blob, ws.dist, ws.marker,
                                          g.total);
  blur_quantize<<<blocks, kThreads, 0, s>>>(ws.dist, ws.energy_sh, g);
  if ((err = cudaGetLastError())) return err;
  // 3. fill-holes: background components that miss the border
  if (skip != kSkipFill) {
    if ((err = ccl(ws.marker, 0, ws.parent, g, blocks, s))) return err;
    if ((err = cudaMemsetAsync(ws.cnt, 0, g.total * sizeof(int), s)))
      return err;
    border_touch<<<blocks, kThreads, 0, s>>>(ws.marker, ws.parent, ws.cnt, g);
    fill_enclosed<<<blocks, kThreads, 0, s>>>(ws.marker, ws.parent, ws.cnt,
                                              g.total);
  }
  // 4. 5x5 opening
  if (skip != kSkipOpen) {
    morph5<true><<<blocks, kThreads, 0, s>>>(ws.marker, ws.tmp, g);
    morph5<false><<<blocks, kThreads, 0, s>>>(ws.tmp, ws.marker, g);
    if ((err = cudaGetLastError())) return err;
  }
  // 5. marker CCL + removal, watershed seeds
  if ((err = ccl(ws.marker, 1, ws.parent, g, blocks, s))) return err;
  if (rm && (err = sizes(ws.marker, ws.parent, ws.cnt, g, blocks, s)))
    return err;
  if (skip == kSkipWs) {
    marker_out<<<blocks, kThreads, 0, s>>>(ws.marker, ws.parent, ws.cnt,
                                           marker_min, out, g);
    return cudaGetLastError();
  }
  ws_init<<<blocks, kThreads, 0, s>>>(ws.marker, ws.parent, ws.cnt,
                                      marker_min, ws.blob, ws.energy_sh,
                                      ws.cost, ws.packed, g);
  if ((err = cudaGetLastError())) return err;
  // 6. phase 1: packed minimax cost
  rc = relax_cost(ws.cost, ws.energy_sh, ws.blob, ws.flag, g, blocks,
                  sweep_order, s);
  if (rc) return rc;
  if (skip == kSkipWsPhase2) {
    phase1_out<<<blocks, kThreads, 0, s>>>(ws.blob, ws.cost, ws.packed, out,
                                           g.total);
    return cudaGetLastError();
  }
  // 7. phase 2: (hops, label) ties along cost-attaining edges
  rc = relax_labels(ws.cost, ws.energy_sh, ws.blob, ws.packed, ws.flag, g,
                    blocks, sweep_order, s);
  if (rc) return rc;
  ws_final<<<blocks, kThreads, 0, s>>>(ws.blob, ws.packed, out, g.total);
  return cudaGetLastError();
}

extern "C" int64_t hnt_watershed_workspace_bytes(int64_t total) {
  return carve_ws(nullptr, total, nullptr);
}

// K2: energy_q int32, markers int32, mask uint8 [n, h, w] -> out int32
// [n, h, w]; workspace: hnt_watershed_workspace_bytes(n * h * w) bytes,
// 256-aligned. Returns 0 or a cudaError_t.
extern "C" int hnt_watershed(const void* energy_p, const void* markers_p,
                             const void* mask_p, void* out_p, void* ws_p,
                             int n, int h, int w, int sweep_order,
                             void* stream) {
  const uint8_t* mask = (const uint8_t*)mask_p;
  cudaStream_t s = (cudaStream_t)stream;
  Geom g{h, w, (int64_t)h * w, (int64_t)n * h * w};
  unsigned blocks = (unsigned)((g.total + kThreads - 1) / kThreads);
  WsWorkspace ws;
  carve_ws((char*)ws_p, g.total, &ws);
  ws_seed<<<blocks, kThreads, 0, s>>>((const int*)energy_p,
                                      (const int*)markers_p, mask,
                                      ws.energy_sh, ws.cost, ws.packed,
                                      g.total);
  cudaError_t err = cudaGetLastError();
  if (err) return err;
  int rc = relax_cost(ws.cost, ws.energy_sh, mask, ws.flag, g, blocks,
                      sweep_order, s);
  if (rc) return rc;
  rc = relax_labels(ws.cost, ws.energy_sh, mask, ws.packed, ws.flag, g,
                    blocks, sweep_order, s);
  if (rc) return rc;
  ws_final<<<blocks, kThreads, 0, s>>>(mask, ws.packed, (int*)out_p, g.total);
  return cudaGetLastError();
}
