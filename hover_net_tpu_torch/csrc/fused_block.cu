// Kernel K3: the fused-block encoder of HoVer-Net, one pre-activation
// bottleneck unit per launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_build_block_call` in
// hover_net_tpu/models/encoder_pallas.py (pallas_call at :334, entry
// `fused_block_apply` at :373). That kernel runs a whole ResidualBlock
// group per spatial tile out of VMEM. Here one launch runs one unit of
// the group: for an output tile of TH x TW pixels a thread block
//
//   1. loads the unit input over the tile's halo window into shared
//      memory (pre-activated with the folded BN + ReLU for units > 0);
//   2. conv1 (1x1) with 8 warps of mma.sync m16n8k16 bf16 tiles, f32
//      accumulation, then bf16 rounding, folded BN and ReLU in bf16; the
//      halo pixels outside the map are zeroed (XLA 'SAME' padding);
//   3. conv2 (3x3, stride 1 or 2) as 9 shifted products over that
//      shared-memory tile, BN and ReLU the same way;
//   4. conv3 (1x1) plus the shortcut: the strided 1x1 shortcut conv of
//      unit 0, or the unit input itself (the rolling shortcut), then the
//      block's final BN + ReLU on its last unit; the tile is written to
//      device memory.
//
// The unit's intermediates (conv1 and conv2 outputs) never leave shared
// memory; only the unit's input and output cross device memory. The
// rounding points are the TPU kernel's: every product accumulates in f32,
// is rounded to bf16, and only then gets the bf16 BN scale (rounded) and
// offset (rounded) and the ReLU; residual sums are bf16 + bf16 rounded
// once. Only the order of the f32 sums differs from the plain version, so
// the kernel agrees with it to a bf16 ulp on a small share of elements.
// Every output element is computed by the same instruction sequence
// whatever the tile size, so the output does not depend on the tiling.
//
// What bounds it: tensor-core throughput through mma.sync (no wgmma/TMA
// yet), one block per SM (the halo tile of a wide unit fills most of the
// 227 KB of shared memory), and the weights, which each warp reads as B
// fragments through L1/L2 rather than staging them in shared memory. The
// 3x3 halo costs extra conv1 work: (TH+2)(TW+2)/(TH*TW) at stride 1.
// The TPU's 8-row DMA alignment, 128-channel padding and compile-memory
// tile cap do not apply here and are not carried over.
//
// Plain C interface, loaded with ctypes (hover_net_tpu_torch/ops/
// fused_block_cuda.py): the wrapper allocates every buffer; the kernel
// launches on the caller's stream and returns the launch status.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;     // bf16 elements of padding per shared-memory row
constexpr int kMT = 2;      // m16 tiles per warp work item
constexpr int kNC = 32;     // output channels per warp work item (4 x n8)
constexpr int kSmemMax = 232448;

struct UnitArgs {
  const bf16* x;      // unit input  [n, s_in, s_in, cin]
  bf16* out;          // unit output [n, s_out, s_out, cout]
  int n, s_in, s_out, cin, c1, cout, stride, th, tw;
  const bf16* pre_s;  // preact BN scale/offset [cin] (null: no preact)
  const bf16* pre_o;
  const bf16* w1t;    // [c1][cin]
  const bf16* s1;
  const bf16* o1;
  const bf16* w2t;    // [9][c1 out][c1 in], tap = dy * 3 + dx
  const bf16* s2;
  const bf16* o2;
  const bf16* w3t;    // [cout][c1]
  const bf16* wsct;   // [cout][cin] strided shortcut (null: identity)
  const bf16* sb;     // final BN [cout] (null: none)
  const bf16* ob;
};

struct Geom {
  int hh, hw;  // halo window rows, cols (input resolution)
  int ph, mh;  // halo pixels, rounded up to 16
  int po, mo;  // output pixels of the tile, rounded up to 16
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline Geom make_geom(int stride, int th, int tw) {
  Geom g;
  g.hh = stride == 1 ? th + 2 : 2 * th + 1;
  g.hw = stride == 1 ? tw + 2 : 2 * tw + 1;
  g.ph = g.hh * g.hw;
  g.mh = round16(g.ph);
  g.po = th * tw;
  g.mo = round16(g.po);
  return g;
}

__host__ __device__ inline long long smem_bytes(int cin, int c1, int stride,
                                                int th, int tw) {
  Geom g = make_geom(stride, th, tw);
  return 2LL * ((long long)g.mh * (cin + kPad) + (long long)g.mh * (c1 + kPad)
                + (long long)g.mo * (c1 + kPad));
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// relu(round(round(x * s) + o)) in bf16, as the plain version's bf16 ops
__device__ __forceinline__ bf16 bn_relu(bf16 x, bf16 s, bf16 o) {
  float m = bf2f(f2bf(__fmul_rn(bf2f(x), bf2f(s))));
  float a = bf2f(f2bf(__fadd_rn(m, bf2f(o))));
  return f2bf(a > 0.f ? a : 0.f);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ bf16 lo_of(uint32_t v) {
  return __ushort_as_bfloat16((unsigned short)(v & 0xFFFF));
}

__device__ __forceinline__ bf16 hi_of(uint32_t v) {
  return __ushort_as_bfloat16((unsigned short)(v >> 16));
}

__device__ __forceinline__ uint32_t bn_relu2(uint32_t v, const bf16* s,
                                             const bf16* o) {
  return pack2(bn_relu(lo_of(v), s[0], o[0]), bn_relu(hi_of(v), s[1], o[1]));
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A[rows m0 .. m0 + 16 * kMT) @ Bt[n0 .. n0 + kNC)^T over k in [0, K).
// A lives in shared memory (row stride lda); row_of maps a logical row to
// its shared-memory row (and must accept any row index). Bt is [N][ldb] in
// device memory, so each B fragment is a pair of neighbouring k values.
template <class RowFn>
__device__ __forceinline__ void warp_gemm(float (&acc)[kMT][4][4],
                                          const bf16* sA, int lda,
                                          RowFn row_of, int m0,
                                          const bf16* __restrict__ bt, int ldb,
                                          int n0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* pa[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    pa[mt][0] = sA + (size_t)row_of(m0 + mt * 16 + g) * lda + 2 * t;
    pa[mt][1] = sA + (size_t)row_of(m0 + mt * 16 + g + 8) * lda + 2 * t;
  }
  const bf16* pb = bt + (size_t)(n0 + g) * ldb + 2 * t;
  for (int k = 0; k < K; k += 16) {
    uint32_t b[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const bf16* q = pb + (size_t)nt * 8 * ldb + k;
      b[nt][0] = ldg32(q);
      b[nt][1] = ldg32(q + 8);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t a[4];
      a[0] = lds32(pa[mt][0] + k);
      a[1] = lds32(pa[mt][1] + k);
      a[2] = lds32(pa[mt][0] + k + 8);
      a[3] = lds32(pa[mt][1] + k + 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[kMT][4][N]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[mt][nt][e] = 0.f;
}

__global__ void __launch_bounds__(kThreads, 1) unit_kernel(UnitArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geom G = make_geom(p.stride, p.th, p.tw);
  const int lda = p.cin + kPad, ldt = p.c1 + kPad;
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // halo input   [mh][lda]
  bf16* sT = sA + (size_t)G.mh * lda;             // conv1 output [mh][ldt]
  bf16* sY = sT + (size_t)G.mh * ldt;             // conv2 output [mo][ldt]

  const int tiles_x = (p.s_out + p.tw - 1) / p.tw;
  const int y0 = (blockIdx.x / tiles_x) * p.th;
  const int x0 = (blockIdx.x % tiles_x) * p.tw;
  const int img = blockIdx.y;
  // halo origin at input resolution: one pixel of 3x3 halo at stride 1;
  // at stride 2, out[q] = sum_k in[2q + k] (TF 'SAME': 0 before, 1 after)
  const int hy0 = p.stride == 1 ? y0 - 1 : 2 * y0;
  const int hx0 = p.stride == 1 ? x0 - 1 : 2 * x0;
  const bf16* xin = p.x + (size_t)img * p.s_in * p.s_in * p.cin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // 1. the halo window of the unit input, pre-activated, 16 bytes a thread
  const int cv = p.cin / 8;
  for (int i = threadIdx.x; i < G.mh * cv; i += kThreads) {
    const int r = i / cv, c = (i % cv) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < G.ph) {
      const int gy = hy0 + r / G.hw, gx = hx0 + r % G.hw;
      if (gy >= 0 && gy < p.s_in && gx >= 0 && gx < p.s_in) {
        v = __ldg(reinterpret_cast<const uint4*>(
            xin + ((size_t)gy * p.s_in + gx) * p.cin + c));
        if (p.pre_s) {
          v.x = bn_relu2(v.x, p.pre_s + c, p.pre_o + c);
          v.y = bn_relu2(v.y, p.pre_s + c + 2, p.pre_o + c + 2);
          v.z = bn_relu2(v.z, p.pre_s + c + 4, p.pre_o + c + 4);
          v.w = bn_relu2(v.w, p.pre_s + c + 6, p.pre_o + c + 6);
        }
      }
    }
    *reinterpret_cast<uint4*>(sA + (size_t)r * lda + c) = v;
  }
  __syncthreads();

  // 2. conv1 (1x1) + BN + ReLU over the halo window, zero outside the map
  {
    const int mg = (G.mh + 16 * kMT - 1) / (16 * kMT), ng = p.c1 / kNC;
    const int mh = G.mh;
    auto rows = [mh](int r) { return r < mh ? r : 0; };
    for (int it = warp; it < mg * ng; it += kWarps) {
      const int m0 = (it / ng) * 16 * kMT, n0 = (it % ng) * kNC;
      float acc[kMT][4][4];
      zero_acc(acc);
      warp_gemm(acc, sA, lda, rows, m0, p.w1t, p.cin, n0, p.cin);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + mt * 16 + g + 8 * h;
          if (r >= G.mh) continue;
          bool inmap = false;
          if (r < G.ph) {
            const int gy = hy0 + r / G.hw, gx = hx0 + r % G.hw;
            inmap = gy >= 0 && gy < p.s_in && gx >= 0 && gx < p.s_in;
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + nt * 8 + 2 * t;
            uint32_t v = 0u;
            if (inmap)
              v = pack2(bn_relu(f2bf(acc[mt][nt][2 * h]), p.s1[col], p.o1[col]),
                        bn_relu(f2bf(acc[mt][nt][2 * h + 1]), p.s1[col + 1],
                                p.o1[col + 1]));
            *reinterpret_cast<uint32_t*>(sT + (size_t)r * ldt + col) = v;
          }
        }
    }
  }
  __syncthreads();

  // 3. conv2 (3x3, stride 1 or 2) + BN + ReLU: 9 shifted products
  {
    const int mg = (G.mo + 16 * kMT - 1) / (16 * kMT), ng = p.c1 / kNC;
    for (int it = warp; it < mg * ng; it += kWarps) {
      const int m0 = (it / ng) * 16 * kMT, n0 = (it % ng) * kNC;
      float acc[kMT][4][4];
      zero_acc(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const int po = G.po, tw = p.tw, s = p.stride, hw = G.hw;
        auto rows = [=](int r) {
          if (r >= po) r = 0;
          return (r / tw * s + dy) * hw + (r % tw) * s + dx;
        };
        warp_gemm(acc, sT, ldt, rows, m0, p.w2t + (size_t)tap * p.c1 * p.c1,
                  p.c1, n0, p.c1);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + mt * 16 + g + 8 * h;
          if (r >= G.mo) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + nt * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(sY + (size_t)r * ldt + col) = pack2(
                bn_relu(f2bf(acc[mt][nt][2 * h]), p.s2[col], p.o2[col]),
                bn_relu(f2bf(acc[mt][nt][2 * h + 1]), p.s2[col + 1],
                        p.o2[col + 1]));
          }
        }
    }
  }
  __syncthreads();

  // 4. conv3 (1x1) + shortcut (+ final BN + ReLU) -> device memory
  {
    const int mg = (G.mo + 16 * kMT - 1) / (16 * kMT), ng = p.cout / kNC;
    bf16* outp = p.out + (size_t)img * p.s_out * p.s_out * p.cout;
    const int off = p.stride == 1 ? 1 : 0;
    const int mo = G.mo, po = G.po, tw = p.tw, s = p.stride, hw = G.hw;
    auto yrows = [mo](int r) { return r < mo ? r : 0; };
    // the shortcut samples the unit input at in[s * q]: halo (s*i+off, s*j+off)
    auto srows = [=](int r) {
      if (r >= po) r = 0;
      return (r / tw * s + off) * hw + (r % tw) * s + off;
    };
    for (int it = warp; it < mg * ng; it += kWarps) {
      const int m0 = (it / ng) * 16 * kMT, n0 = (it % ng) * kNC;
      float acc[kMT][4][4], accs[kMT][4][4];
      zero_acc(acc);
      zero_acc(accs);
      warp_gemm(acc, sY, ldt, yrows, m0, p.w3t, p.c1, n0, p.c1);
      if (p.wsct) warp_gemm(accs, sA, lda, srows, m0, p.wsct, p.cin, n0, p.cin);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + mt * 16 + g + 8 * h;
          if (r >= G.po) continue;
          const int oy = y0 + r / p.tw, ox = x0 + r % p.tw;
          if (oy >= p.s_out || ox >= p.s_out) continue;
          const size_t pix = (size_t)oy * p.s_out + ox;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + nt * 8 + 2 * t;
            float sc0, sc1;
            if (p.wsct) {
              sc0 = bf2f(f2bf(accs[mt][nt][2 * h]));
              sc1 = bf2f(f2bf(accs[mt][nt][2 * h + 1]));
            } else {  // identity: cin == cout and s_in == s_out
              const uint32_t v = ldg32(xin + pix * p.cin + col);
              sc0 = bf2f(lo_of(v));
              sc1 = bf2f(hi_of(v));
            }
            bf16 v0 = f2bf(__fadd_rn(bf2f(f2bf(acc[mt][nt][2 * h])), sc0));
            bf16 v1 = f2bf(__fadd_rn(bf2f(f2bf(acc[mt][nt][2 * h + 1])), sc1));
            if (p.sb) {
              v0 = bn_relu(v0, p.sb[col], p.ob[col]);
              v1 = bn_relu(v1, p.sb[col + 1], p.ob[col + 1]);
            }
            *reinterpret_cast<uint32_t*>(outp + pix * p.cout + col) =
                pack2(v0, v1);
          }
        }
    }
  }
}

}  // namespace

extern "C" {

// 1 when a th x tw output tile of this unit fits shared memory, else 0
int hnt_fused_unit_fits(int cin, int c1, int stride, int th, int tw) {
  return smem_bytes(cin, c1, stride, th, tw) <= kSmemMax;
}

int hnt_fused_unit(const void* x, void* out, int n, int s_in, int s_out,
                   int cin, int c1, int cout, int stride, int th, int tw,
                   const void* pre_s, const void* pre_o, const void* w1t,
                   const void* s1, const void* o1, const void* w2t,
                   const void* s2, const void* o2, const void* w3t,
                   const void* wsct, const void* sb, const void* ob,
                   void* stream) {
  if (n <= 0 || n > 65535 || th <= 0 || tw <= 0 || cin % 32 || c1 % 32
      || cout % 32 || (stride != 1 && stride != 2)
      || s_out * stride != s_in || (!wsct && (cin != cout || stride != 1)))
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(cin, c1, stride, th, tw);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      unit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  UnitArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.s_in = s_in;
  a.s_out = s_out;
  a.cin = cin;
  a.c1 = c1;
  a.cout = cout;
  a.stride = stride;
  a.th = th;
  a.tw = tw;
  a.pre_s = static_cast<const bf16*>(pre_s);
  a.pre_o = static_cast<const bf16*>(pre_o);
  a.w1t = static_cast<const bf16*>(w1t);
  a.s1 = static_cast<const bf16*>(s1);
  a.o1 = static_cast<const bf16*>(o1);
  a.w2t = static_cast<const bf16*>(w2t);
  a.s2 = static_cast<const bf16*>(s2);
  a.o2 = static_cast<const bf16*>(o2);
  a.w3t = static_cast<const bf16*>(w3t);
  a.wsct = static_cast<const bf16*>(wsct);
  a.sb = static_cast<const bf16*>(sb);
  a.ob = static_cast<const bf16*>(ob);
  const int tiles = ((s_out + th - 1) / th) * ((s_out + tw - 1) / tw);
  dim3 grid(tiles, n);
  unit_kernel<<<grid, kThreads, (size_t)smem,
                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* hnt_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
