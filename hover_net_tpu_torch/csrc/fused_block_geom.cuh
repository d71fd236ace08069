// Index arithmetic of kernel K3 (fused_block.cu): tiles, TMA boxes and
// tensor maps, the 128-byte swizzle, wgmma descriptors and accumulator
// fragments. Free of CUDA headers, so that it also compiles as plain C++
// (g++) for checks on a machine without nvcc.

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace k3 {

constexpr int kBM = 128;         // output pixels per tile: two m64 warpgroups
constexpr int kBK = 64;          // channels per K chunk: one 128-byte row
constexpr int kRowBytes = 2 * kBK;
constexpr int kStageA = kBM * kRowBytes;  // bytes of one A stage (16 KB)

// An output tile is th x tw = kBM pixels of one image, th a power of two.
__host__ __device__ inline bool tile_ok(int th) {
  return th >= 1 && th <= kBM && (th & (th - 1)) == 0;
}

__host__ __device__ inline int tile_cols(int th) { return kBM / th; }

// The default tile: 16 columns (8 rows), or the least power of two of
// columns that covers a map narrower than 16.
__host__ __device__ inline int default_th(int s_out) {
  int tw = 16;
  while (tw > 1 && tw / 2 >= s_out) tw /= 2;
  return kBM / tw;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// N tile: the widest of 128, 64 and 32 output channels that divides n.
__host__ __device__ inline int n_tile(int n) {
  return n % 128 == 0 ? 128 : n % 64 == 0 ? 64 : 32;
}

// Offset, in input pixels, of tap row or column d (0..2) of a 3x3 'SAME'
// conv at stride s: out[q] reads in[s * q + d - (s == 1)], which is the
// TF rule (pad 1/1 at stride 1; 0 before and 1 after at stride 2). A 1x1
// product has one tap at offset 0.
__host__ __device__ inline int tap_offset(int d, int stride, int taps) {
  return taps == 1 ? 0 : d - (stride == 1);
}

// Origin of the A box of K step `it` (tap-major, then channel chunk) for
// the tile whose first output pixel is (x0, y0): channel, then input x, y.
// The box walks the input at the conv's stride (TMA element strides), so
// out-of-map rows and columns arrive as zeros: the 'SAME' padding.
struct Box {
  int c, x, y, tap;
};

__host__ __device__ inline Box a_box(int it, int kchunks, int taps,
                                     int stride, int x0, int y0) {
  Box b;
  b.tap = it / kchunks;
  b.c = (it % kchunks) * kBK;
  b.x = stride * x0 + tap_offset(b.tap % 3, stride, taps);
  b.y = stride * y0 + tap_offset(b.tap / 3, stride, taps);
  return b;
}

// Tensor maps (innermost dimension first; strides in bytes of dims 1..).
// A: the NHWC bf16 input [n, s, s, c]; box kBK channels x (stride * tw)
// x (stride * th) x 1 image, element strides 1, stride, stride, 1.
// B: weights [cout][taps][k], K-major; box kBK x 1 tap x bn rows.
struct MapGeom {
  int rank;
  uint64_t dim[4], stride[3];
  uint32_t box[4], estride[4];
};

__host__ __device__ inline MapGeom a_map(int n, int s, int c, int stride,
                                         int th) {
  MapGeom g;
  g.rank = 4;
  g.dim[0] = c;
  g.dim[1] = s;
  g.dim[2] = s;
  g.dim[3] = n;
  g.stride[0] = 2ull * c;
  g.stride[1] = 2ull * c * s;
  g.stride[2] = 2ull * c * s * s;
  g.box[0] = kBK;
  g.box[1] = stride * tile_cols(th);
  g.box[2] = stride * th;
  g.box[3] = 1;
  g.estride[0] = 1;
  g.estride[1] = stride;
  g.estride[2] = stride;
  g.estride[3] = 1;
  return g;
}

__host__ __device__ inline MapGeom b_map(int k, int taps, int cout, int bn) {
  MapGeom g;
  g.rank = 3;
  g.dim[0] = k;
  g.dim[1] = taps;
  g.dim[2] = cout;
  g.dim[3] = 1;
  g.stride[0] = 2ull * k;
  g.stride[1] = 2ull * k * taps;
  g.stride[2] = 0;
  g.box[0] = kBK;
  g.box[1] = 1;
  g.box[2] = bn;
  g.box[3] = 1;
  for (int i = 0; i < 4; ++i) g.estride[i] = 1;
  return g;
}

// The 128-byte swizzle of TMA (SWIZZLE_128B) on a 1024-byte-aligned tile
// of 128-byte rows: 16-byte chunk c (channels 8c .. 8c + 7) of row r is
// stored as chunk c ^ (r % 8). The map is its own inverse, so it also
// takes a stored chunk back to its channels.
__host__ __device__ inline int swz_chunk(int row, int chunk) {
  return chunk ^ (row & 7);
}

// wgmma shared-memory descriptor of a K-major operand in that layout:
// start address >> 4, leading byte offset 1 (unused with this swizzle),
// stride byte offset 1024 >> 4 (one 8-row atom), layout 1 = 128B swizzle.
// The k-th 16-wide K slice starts 32 * k bytes further.
__host__ __device__ inline uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Accumulator register j of thread t (0..127) of an m64nNk16 wgmma with
// f32 accumulators: its row and column in the warpgroup's 64 x N tile.
__host__ __device__ inline int acc_row(int t, int j) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((j >> 1) & 1);
}

__host__ __device__ inline int acc_col(int t, int j) {
  return 8 * (j >> 2) + 2 * (t & 3) + (j & 1);
}

}  // namespace k3
