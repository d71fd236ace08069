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
//   1. blob CCL (block-based union-find, least-index roots) and removal
//      of components under `blob_min_size` pixels (sizes by atomicAdd);
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
// A caller may ask for the split of a call (`stats`): CUDA events at the
// stage boundaries and the sweep count of each watershed phase.
//
// What bounds it on this card. The TPU kernel cut the map into halo
// windows to fit VMEM; here each map is solved whole: at 1148^2 one int32
// plane is 5.3 MB, and the whole working set (~31 bytes a pixel, 41 MB)
// stays in the 50 MB L2. By bytes the tail is ~9 bytes a pixel in and
// out, a few microseconds; what it spends instead is chains of dependent
// steps: union-find chains in the CCLs and, in the watershed, fronts
// that move across the map one relaxation step at a time. The design
// keeps those steps inside shared memory (post_proc_tiles.cuh):
// - CCL (three launches): one 256-thread block per 32x32 tile takes each
//   tile row's mask as one warp ballot, roots every run of a row at its
//   first pixel at once, and unites the runs of adjacent rows with
//   shared-memory atomicMin (so the map-sized background of fill-holes
//   costs a few unions a tile, not two a pixel funnelled into one global
//   chain); then one thread per tile-border pair unites across tiles in
//   global memory with path halving, once per stretch of joined pairs;
//   then every pixel takes its root, one chain walk per distinct local
//   root of a warp. Roots stay least indices, so labels are 1 + the
//   component's first raster pixel, as in the plain version.
// - Watershed: one sweep is one launch over the tiles; each block loads
//   its tile and a 1-pixel halo into shared memory, relaxes the tile to
//   its local fixpoint against the fixed halo (a block-wide barrier per
//   step), and writes back the pixels that fell. A front thus crosses a
//   whole tile per sweep, and a phase takes a few sweeps (a nucleus is
//   smaller than a tile); after a phase's first sweep only the tiles
//   next to a tile that fell run. The host launches sweeps kSweepBatch
//   at a time, each with its own changed flag; a sweep whose predecessor
//   changed nothing returns at once, and one copy of the batch's flags
//   (one synchronisation) decides whether to go on.
//
// Relaxing in place, tile by tile and with stale halos, is legal because
// both phases relax a monotone operator from the top of a finite lattice,
// so every order reaches the same unique fixpoint (hover_net_tpu/ops/
// post_proc_device.py, watershed_flood). `sweep_order` permutes the tiles
// of a sweep and the pixels inside a tile so that a test can show it (0
// raster, 1 reversed, 2 strided by a prime).
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
// tile by tile, as K1 does; both reach the same unique fixpoint (above).
// Bound on this card: bytes, 13 per pixel in and out (energy, markers,
// mask, labels); like K1's watershed it spends its time in the sweeps'
// chains of relaxation steps. The TPU kernel had to fit one map in VMEM
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

#include "post_proc_tiles.cuh"

namespace {

using ppt::kHopBits;
using ppt::kIntMax;
constexpr int kThreads = 256;
// sweeps launched between two host reads of their changed flags: a
// phase takes 4-5 sweeps on nuclei maps (a nucleus is smaller than a
// tile), so one read mostly ends a phase and few launches idle
constexpr int kSweepBatch = 4;
// returned when a relaxation exceeds its sweep bound (not a cudaError_t)
constexpr int kNoFixpoint = 100000;
// the optional split of one call (ops/post_proc_cuda.py STAGES): a double
// [kStatWords] of kStages stage times (ms, CUDA events at the stage
// boundaries), then the sweep count of each watershed phase
constexpr int kStages = 7;
constexpr int kStatWords = kStages + 2;
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

ppt::TileGrid tile_grid(Geom g) {
  return ppt::tile_grid((int)(g.total / g.hw), g.h, g.w);
}

// ---------------------------------------------------------------- CCL
// Block-based union-find: the steps are ppt::'s (post_proc_tiles.cuh),
// the design is in the note at the top of this file. Roots are least
// indices (parent[x] <= x), so a root is its component's first pixel.

__global__ void __launch_bounds__(ppt::kTileThreads)
    ccl_local(const uint8_t* mask, int pol, int* parent, ppt::TileGrid tg) {
  static_assert(ppt::kTileW == 32 && ppt::kTilePx % ppt::kTileThreads == 0,
                "a warp ballot takes one whole tile row");
  __shared__ int sp[ppt::kTilePx];
  __shared__ unsigned rows[ppt::kTileH];
  ppt::Tile t = ppt::tile_at(tg, blockIdx.x);
  for (int l = threadIdx.x; l < ppt::kTilePx; l += blockDim.x) {
    unsigned bits = __ballot_sync(0xffffffffu,
                                  ppt::ccl_pixel_in(t, tg, mask, pol, l));
    if (l % ppt::kTileW == 0) rows[l / ppt::kTileW] = bits;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < ppt::kTilePx; l += blockDim.x)
    ppt::ccl_local_runs(rows, sp, l);
  __syncthreads();
  for (int l = threadIdx.x; l < ppt::kTilePx; l += blockDim.x)
    ppt::ccl_local_unite(rows, sp, l);
  __syncthreads();
  for (int l = threadIdx.x; l < ppt::kTilePx; l += blockDim.x)
    ppt::ccl_local_store(t, tg, rows, sp, parent, l);
}

__global__ void ccl_border(const uint8_t* mask, int pol, int* parent,
                           ppt::TileGrid tg) {
  ppt::ccl_border_merge(ppt::tile_at(tg, blockIdx.x), tg, mask, pol, parent,
                        threadIdx.x);
}

// Flatten: every pixel of the mask takes the root of its local root
// p = parent[i]. Most lanes of a warp share p, so one lane walks each
// distinct p's chain and hands the root to the others (every lane of the
// warp takes part in the match and the shuffle).
__global__ void ccl_roots(const uint8_t* mask, int pol, int* parent,
                          int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  bool in = i < total && ppt::in_mask(mask, pol, i);
  int p = in ? parent[i] : -1;
  int lead = __ffs(__match_any_sync(0xffffffffu, p)) - 1;
  int root = in && (int)(threadIdx.x % 32) == lead
                 ? ppt::find_root(parent, p) : 0;
  root = __shfl_sync(0xffffffffu, root, lead);
  if (in) parent[i] = root;
}

__global__ void count_sizes(const uint8_t* mask, int pol, const int* parent,
                            int* cnt, int64_t total) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < total && ppt::in_mask(mask, pol, i)) atomicAdd(&cnt[parent[i]], 1);
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
  packed[i] = seeded ? (unsigned long long)lab : ppt::kUnreached;
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
  packed[i] = seeded ? (unsigned long long)(unsigned)m : ppt::kUnreached;
}

// One sweep of a phase over the tiles, in `order`; each block relaxes
// its tile to the local fixpoint against its halo (the ppt:: steps of
// post_proc_tiles.cuh) and writes back what fell, if the tile is active
// (ppt::tile_active: `done` holds the sweep before's stores, null in a
// phase's first sweep). Each block that runs writes into `mark[tile]`
// whether it stored a fall. A sweep whose predecessor in the batch
// (`prev`; null for the first) changed nothing returns at once; a sweep
// in which anything fell sets *changed.

// phase 1: the packed minimax cost
__global__ void __launch_bounds__(ppt::kTileThreads)
    ws_cost_tiles(int* cost, const int* energy_sh, const uint8_t* mask,
                  ppt::TileGrid tg, int order, const uint8_t* done,
                  uint8_t* mark, const int* prev, int* changed) {
  if (prev && !*prev) return;
  __shared__ int hc[ppt::kHaloPx];
  int64_t b = ppt::sweep_index(blockIdx.x, tg.tiles, order);
  ppt::Tile t = ppt::tile_at(tg, b);
  ppt::CostLane ln;
  if (!ppt::tile_active(tg, done, b) ||
      !__syncthreads_or(ppt::cost_lane_load(ln, t, tg, cost, energy_sh, mask,
                                            threadIdx.x, order))) {
    if (threadIdx.x == 0) mark[b] = 0;
    return;
  }
  for (int hl = threadIdx.x; hl < ppt::kHaloPx; hl += blockDim.x)
    hc[hl] = ppt::halo_value(t, tg, cost, hl, kIntMax);
  __syncthreads();
  while (__syncthreads_or(ppt::cost_lane_relax(ln, hc))) {
  }
  bool fell = __syncthreads_or(
      ppt::cost_lane_store(ln, t, tg, cost, threadIdx.x, order));
  if (threadIdx.x == 0) {
    mark[b] = fell;
    if (fell) *changed = 1;
  }
}

// phase 2: (hops, label) along the edges that attain the fixed cost
__global__ void __launch_bounds__(ppt::kTileThreads)
    ws_label_tiles(const int* cost, const int* energy_sh, const uint8_t* mask,
                   unsigned long long* packed, ppt::TileGrid tg, int order,
                   const uint8_t* done, uint8_t* mark, const int* prev,
                   int* changed) {
  if (prev && !*prev) return;
  __shared__ int hc[ppt::kHaloPx];
  __shared__ unsigned long long hv[ppt::kHaloPx];
  int64_t b = ppt::sweep_index(blockIdx.x, tg.tiles, order);
  ppt::Tile t = ppt::tile_at(tg, b);
  if (!ppt::tile_active(tg, done, b) ||
      !__syncthreads_or(ppt::lane_in_mask(t, tg, mask, threadIdx.x, order))) {
    if (threadIdx.x == 0) mark[b] = 0;
    return;
  }
  for (int hl = threadIdx.x; hl < ppt::kHaloPx; hl += blockDim.x) {
    hc[hl] = ppt::halo_value(t, tg, cost, hl, kIntMax);
    hv[hl] = ppt::halo_value(t, tg, (const unsigned long long*)packed, hl,
                             ppt::kUnreached);
  }
  __syncthreads();
  ppt::LabelLane ln;
  if (!__syncthreads_or(ppt::label_lane_load(ln, t, tg, hc, energy_sh, mask,
                                             packed, threadIdx.x, order))) {
    if (threadIdx.x == 0) mark[b] = 0;
    return;
  }
  while (__syncthreads_or(ppt::label_lane_relax(ln, hv))) {
  }
  bool fell = __syncthreads_or(
      ppt::label_lane_store(ln, t, tg, packed, threadIdx.x, order));
  if (threadIdx.x == 0) {
    mark[b] = fell;
    if (fell) *changed = 1;
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
  int *parent, *cnt, *energy_sh, *cost, *flags;
  float* dist;
  uint8_t *blob, *marker, *tmp, *tile_flags;
};

// carve the workspace of `total` pixels in `tiles` tiles out of `base`
// (null: only count); returns its size
int64_t carve(char* base, int64_t total, int64_t tiles, Workspace* ws) {
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
  w.flags = (int*)take(4 * kSweepBatch);
  w.tile_flags = (uint8_t*)take(2 * tiles);
  if (ws) *ws = w;
  return off;
}

// K2's workspace: the watershed state only
struct WsWorkspace {
  unsigned long long* packed;
  int *energy_sh, *cost, *flags;
  uint8_t* tile_flags;
};

int64_t carve_ws(char* base, int64_t total, int64_t tiles, WsWorkspace* ws) {
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
  w.flags = (int*)take(4 * kSweepBatch);
  w.tile_flags = (uint8_t*)take(2 * tiles);
  if (ws) *ws = w;
  return off;
}

// parent[i] of every pixel of the mask (pol 1: set, 0: clear): the least
// index of its 4-connected component in its map (off the mask: not
// written, and read by no caller)
cudaError_t ccl(const uint8_t* mask, int pol, int* parent, Geom g,
                unsigned blocks, cudaStream_t s) {
  ppt::TileGrid tg = tile_grid(g);
  ccl_local<<<(unsigned)tg.tiles, ppt::kTileThreads, 0, s>>>(mask, pol,
                                                             parent, tg);
  ccl_border<<<(unsigned)tg.tiles, ppt::kBorderPairs, 0, s>>>(mask, pol,
                                                              parent, tg);
  ccl_roots<<<blocks, kThreads, 0, s>>>(mask, pol, parent, g.total);
  return cudaGetLastError();
}

cudaError_t sizes(const uint8_t* mask, const int* parent, int* cnt, Geom g,
                  unsigned blocks, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(cnt, 0, g.total * sizeof(int), s);
  if (err != cudaSuccess) return err;
  count_sizes<<<blocks, kThreads, 0, s>>>(mask, 1, parent, cnt, g.total);
  return cudaGetLastError();
}

// Launch sweeps until one changes nothing. Sweeps go out kSweepBatch at
// a time, each with its own changed flag; one copy of the batch's flags
// to the host (one synchronisation) decides whether to go on. Sweep k
// of the phase (from 0) reads the tiles' stores of sweep k - 1 from one
// half of `tile_flags` (none for k = 0) and writes its own into the
// other. A fixpoint takes at most one sweep per pixel of the longest
// path, so more sweeps than pixels means a fault, reported as
// kNoFixpoint. `*sweeps` counts the sweeps that ran, the last
// (unchanged) one included.
template <typename Sweep>
int relax(int* flags, uint8_t* tile_flags, ppt::TileGrid tg,
          int64_t max_sweeps, cudaStream_t s, int64_t* sweeps, Sweep sweep) {
  for (int64_t base = 0; base <= max_sweeps; base += kSweepBatch) {
    cudaError_t err = cudaMemsetAsync(flags, 0, kSweepBatch * sizeof(int), s);
    if (err != cudaSuccess) return err;
    for (int k = 0; k < kSweepBatch; ++k) {
      int64_t j = base + k;
      sweep(j ? tile_flags + ((j - 1) & 1) * tg.tiles : nullptr,
            tile_flags + (j & 1) * tg.tiles, k ? flags + k - 1 : nullptr,
            flags + k);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    int changed[kSweepBatch];
    err = cudaMemcpyAsync(changed, flags, sizeof(changed),
                          cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return err;
    if ((err = cudaStreamSynchronize(s)) != cudaSuccess) return err;
    for (int k = 0; k < kSweepBatch; ++k) {
      if (!changed[k]) {
        *sweeps = base + k + 1;
        return cudaSuccess;
      }
    }
  }
  return kNoFixpoint;
}

// watershed phase 1: relax the packed cost over `mask` to its fixpoint
int relax_cost(int* cost, const int* energy_sh, const uint8_t* mask,
               int* flags, uint8_t* tile_flags, Geom g, int order,
               cudaStream_t s, int64_t* sweeps) {
  ppt::TileGrid tg = tile_grid(g);
  return relax(flags, tile_flags, tg, g.total + 1, s, sweeps,
               [&](const uint8_t* done, uint8_t* mark, const int* prev,
                   int* f) {
                 ws_cost_tiles<<<(unsigned)tg.tiles, ppt::kTileThreads, 0,
                                 s>>>(cost, energy_sh, mask, tg, order, done,
                                      mark, prev, f);
               });
}

// watershed phase 2: (hops, label) ties along cost-attaining edges
int relax_labels(const int* cost, const int* energy_sh, const uint8_t* mask,
                 unsigned long long* packed, int* flags, uint8_t* tile_flags,
                 Geom g, int order, cudaStream_t s, int64_t* sweeps) {
  ppt::TileGrid tg = tile_grid(g);
  return relax(flags, tile_flags, tg, g.total + 1, s, sweeps,
               [&](const uint8_t* done, uint8_t* mark, const int* prev,
                   int* f) {
                 ws_label_tiles<<<(unsigned)tg.tiles, ppt::kTileThreads, 0,
                                  s>>>(cost, energy_sh, mask, packed, tg,
                                       order, done, mark, prev, f);
               });
}

// The optional split of one call: CUDA events at its stage boundaries
// (boundary 0 is the call's start, kStages its end) and the sweep counts.
// Nothing is recorded when the caller passes no `stats`.
class StageClock {
 public:
  StageClock(double* stats, cudaStream_t s) : stats_(stats), s_(s) {}
  ~StageClock() {
    for (int k = 0; k < made_; ++k) cudaEventDestroy(ev_[k]);
  }
  int64_t sweeps[2] = {0, 0};

  // record every boundary up to `k` not recorded yet (a stage that did
  // not run takes no time)
  cudaError_t mark(int k) {
    if (!stats_) return cudaSuccess;
    while (made_ <= k) {
      cudaError_t err = cudaEventCreate(&ev_[made_]);
      if (err != cudaSuccess) return err;
      if ((err = cudaEventRecord(ev_[made_++], s_)) != cudaSuccess) return err;
    }
    return cudaSuccess;
  }

  // the last boundary; wait for it and write the stage times and sweeps
  cudaError_t finish() {
    if (!stats_) return cudaSuccess;
    cudaError_t err = mark(kStages);
    if (err == cudaSuccess) err = cudaEventSynchronize(ev_[kStages]);
    for (int k = 0; k < kStages && err == cudaSuccess; ++k) {
      float ms = 0.0f;
      err = cudaEventElapsedTime(&ms, ev_[k], ev_[k + 1]);
      stats_[k] = ms;
    }
    stats_[kStages] = (double)sweeps[0];
    stats_[kStages + 1] = (double)sweeps[1];
    return err;
  }

 private:
  double* stats_;
  cudaStream_t s_;
  cudaEvent_t ev_[kStages + 1];
  int made_ = 0;
};

// K1 and K4 (see hnt_proc_tail); returns 0 or an error code
int proc_tail(const uint8_t* blb, const float* sob, int* out, void* ws_p,
              Geom g, int marker_min_size, int blob_min_size,
              int sweep_order, int skip, cudaStream_t s, StageClock& clock) {
  unsigned blocks = (unsigned)((g.total + kThreads - 1) / kThreads);
  Workspace ws;
  carve((char*)ws_p, g.total, tile_grid(g).tiles, &ws);
  // skip = rmsmall: no size counts, every component kept
  bool rm = skip != kSkipRmsmall;
  int blob_min = rm ? blob_min_size : 0, marker_min = rm ? marker_min_size : 0;
  cudaError_t err;
  int rc;

  if ((err = clock.mark(0))) return err;
  // 1. blob CCL + small-object removal
  if ((err = ccl(blb, 1, ws.parent, g, blocks, s))) return err;
  if (rm && (err = sizes(blb, ws.parent, ws.cnt, g, blocks, s))) return err;
  keep_large<<<blocks, kThreads, 0, s>>>(blb, ws.parent, ws.cnt, blob_min,
                                         ws.blob, g.total);
  if ((err = clock.mark(1))) return err;
  // 2. energy and raw markers
  energy_dist<<<blocks, kThreads, 0, s>>>(sob, ws.blob, ws.dist, ws.marker,
                                          g.total);
  blur_quantize<<<blocks, kThreads, 0, s>>>(ws.dist, ws.energy_sh, g);
  if ((err = cudaGetLastError())) return err;
  if ((err = clock.mark(2))) return err;
  // 3. fill-holes: background components that miss the border
  if (skip != kSkipFill) {
    if ((err = ccl(ws.marker, 0, ws.parent, g, blocks, s))) return err;
    if ((err = cudaMemsetAsync(ws.cnt, 0, g.total * sizeof(int), s)))
      return err;
    border_touch<<<blocks, kThreads, 0, s>>>(ws.marker, ws.parent, ws.cnt, g);
    fill_enclosed<<<blocks, kThreads, 0, s>>>(ws.marker, ws.parent, ws.cnt,
                                              g.total);
  }
  if ((err = clock.mark(3))) return err;
  // 4. 5x5 opening
  if (skip != kSkipOpen) {
    morph5<true><<<blocks, kThreads, 0, s>>>(ws.marker, ws.tmp, g);
    morph5<false><<<blocks, kThreads, 0, s>>>(ws.tmp, ws.marker, g);
    if ((err = cudaGetLastError())) return err;
  }
  if ((err = clock.mark(4))) return err;
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
  if ((err = clock.mark(5))) return err;
  // 6. phase 1: packed minimax cost
  rc = relax_cost(ws.cost, ws.energy_sh, ws.blob, ws.flags, ws.tile_flags, g,
                  sweep_order, s, &clock.sweeps[0]);
  if (rc) return rc;
  if (skip == kSkipWsPhase2) {
    phase1_out<<<blocks, kThreads, 0, s>>>(ws.blob, ws.cost, ws.packed, out,
                                           g.total);
    return cudaGetLastError();
  }
  if ((err = clock.mark(6))) return err;
  // 7. phase 2: (hops, label) ties along cost-attaining edges
  rc = relax_labels(ws.cost, ws.energy_sh, ws.blob, ws.packed, ws.flags,
                    ws.tile_flags, g, sweep_order, s, &clock.sweeps[1]);
  if (rc) return rc;
  ws_final<<<blocks, kThreads, 0, s>>>(ws.blob, ws.packed, out, g.total);
  return cudaGetLastError();
}

// K2 (see hnt_watershed); its seed pass is timed as the "markers" stage
int watershed(const int* energy_q, const int* markers, const uint8_t* mask,
              int* out, void* ws_p, Geom g, int sweep_order, cudaStream_t s,
              StageClock& clock) {
  unsigned blocks = (unsigned)((g.total + kThreads - 1) / kThreads);
  WsWorkspace ws;
  carve_ws((char*)ws_p, g.total, tile_grid(g).tiles, &ws);
  cudaError_t err = clock.mark(4);
  if (err) return err;
  ws_seed<<<blocks, kThreads, 0, s>>>(energy_q, markers, mask, ws.energy_sh,
                                      ws.cost, ws.packed, g.total);
  if ((err = cudaGetLastError()) || (err = clock.mark(5))) return err;
  int rc = relax_cost(ws.cost, ws.energy_sh, mask, ws.flags, ws.tile_flags,
                      g, sweep_order, s, &clock.sweeps[0]);
  if (rc) return rc;
  if ((err = clock.mark(6))) return err;
  rc = relax_labels(ws.cost, ws.energy_sh, mask, ws.packed, ws.flags,
                    ws.tile_flags, g, sweep_order, s, &clock.sweeps[1]);
  if (rc) return rc;
  ws_final<<<blocks, kThreads, 0, s>>>(mask, ws.packed, out, g.total);
  return cudaGetLastError();
}

}  // namespace

extern "C" int64_t hnt_proc_tail_workspace_bytes(int n, int h, int w) {
  Geom g{h, w, (int64_t)h * w, (int64_t)n * h * w};
  return carve(nullptr, g.total, tile_grid(g).tiles, nullptr);
}

extern "C" const char* hnt_error_string(int err) {
  if (err == kNoFixpoint) return "watershed relaxation did not converge";
  return cudaGetErrorString((cudaError_t)err);
}

// blb uint8 [n, h, w], sob float32 [n, h, w] -> out int32 [n, h, w];
// workspace: hnt_proc_tail_workspace_bytes(n, h, w) bytes, 256-aligned;
// skip: a Skip code (0 = the whole tail, K1); stats: null, or a double
// [kStatWords] that receives the call's split (the call then waits for
// its end). Returns 0 or a cudaError_t.
extern "C" int hnt_proc_tail(const void* blb_p, const void* sob_p, void* out_p,
                             void* ws_p, int n, int h, int w,
                             int marker_min_size, int blob_min_size,
                             int sweep_order, int skip, void* stream,
                             void* stats) {
  if (skip < 0 || skip >= kSkipCount) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  StageClock clock((double*)stats, s);
  int rc = proc_tail((const uint8_t*)blb_p, (const float*)sob_p, (int*)out_p,
                     ws_p, Geom{h, w, (int64_t)h * w, (int64_t)n * h * w},
                     marker_min_size, blob_min_size, sweep_order, skip, s,
                     clock);
  return rc ? rc : clock.finish();
}

extern "C" int64_t hnt_watershed_workspace_bytes(int n, int h, int w) {
  Geom g{h, w, (int64_t)h * w, (int64_t)n * h * w};
  return carve_ws(nullptr, g.total, tile_grid(g).tiles, nullptr);
}

// K2: energy_q int32, markers int32, mask uint8 [n, h, w] -> out int32
// [n, h, w]; workspace: hnt_watershed_workspace_bytes(n, h, w) bytes,
// 256-aligned; stats as for hnt_proc_tail (stages 0-3 take no time).
// Returns 0 or a cudaError_t.
extern "C" int hnt_watershed(const void* energy_p, const void* markers_p,
                             const void* mask_p, void* out_p, void* ws_p,
                             int n, int h, int w, int sweep_order,
                             void* stream, void* stats) {
  cudaStream_t s = (cudaStream_t)stream;
  StageClock clock((double*)stats, s);
  int rc = watershed((const int*)energy_p, (const int*)markers_p,
                     (const uint8_t*)mask_p, (int*)out_p, ws_p,
                     Geom{h, w, (int64_t)h * w, (int64_t)n * h * w},
                     sweep_order, s, clock);
  return rc ? rc : clock.finish();
}
