// Kernel K3: the fused-block encoder of HoVer-Net, one pre-activation
// bottleneck unit per call, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_build_block_call` in
// hover_net_tpu/models/encoder_pallas.py:220 (pallas_call at :334, entry
// `fused_block_apply` at :373). That kernel runs a whole ResidualBlock
// group per spatial tile out of VMEM. Here each unit runs as three
// launches of one implicit-GEMM convolution kernel, `conv_gemm`:
//
//   conv1 1x1 (+ the pre-activation BN + ReLU of units > 0) + BN + ReLU
//                                               -> t (the input's size)
//   conv2 3x3 'SAME' at the unit's stride + BN + ReLU      -> y
//   conv3 1x1 + residual (+ the block's final BN + ReLU)   -> out
//
// The residual of unit 0 is its strided 1x1 shortcut, computed inside
// conv3's launch as a first product over the same output tile (SC) and
// rounded on its own; later units add their input, in place.
//
// A launch computes a 128-pixel x BN-channel output tile per block (BN =
// 128, 64 or 32, the widest dividing the output channels; the tile is
// th x 128/th pixels of one image, 8 x 16 by default), two blocks per SM.
// One producer warp keeps a ring of 3-4 shared-memory stages filled by
// TMA: per K step (tap-major, then 64-channel chunks) the A box of 128
// input pixels x 64 channels of the 4-D NHWC tensor map, shifted by the
// tap and walked at the conv's stride (element strides), and the B box of
// BN weight rows x 64 channels of the [cout][taps][k] K-major weights, so
// the weights are staged once per block and shared by both warpgroups.
// TMA's out-of-bounds zero fill is the 'SAME' padding and the ragged map
// edge. Two consumer warpgroups each multiply their 64 rows with wgmma
// m64nBNk16 from the 128-byte-swizzled stages into f32 registers, keeping
// one wgmma group in flight while the next stage lands; the pre-activation
// of units > 0 is applied to a stage in shared memory on its way to the
// products. The epilogue stages the tile, rounded to bf16, in the freed
// stages and stores it in 16-byte chunks (consecutive threads on
// consecutive channels of a pixel), reading each residual chunk before any
// store, since the output may overwrite the residual in place.
//
// Rounding points are the plain version's and the model's own bf16
// forward's: every product accumulates in f32 and is rounded to bf16 once
// (conv2's nine taps form one f32 sum); a residual is bf16(bf16(conv3) +
// shortcut), and the strided shortcut is rounded on its own; each folded
// BN takes the bf16 value to float32, multiplies by its float32 scale and
// adds its float32 offset (two f32 ops, __fmul_rn / __fadd_rn, never
// fused), and rounds to bf16 once before the ReLU, as the model's float32
// BatchNorms do. (The TPU kernel applies the BN in bf16, rounding after
// the multiply and after the add.) The residual sum runs on bf16 pairs
// with __hadd2_rn: for a sum of two bf16 values one rounding equals the
// plain version's f32 sum rounded to bf16. Built with -fmad=false. Each
// output element is summed in one fixed K order by one thread, with no
// split-K and no atomics, so the output does not depend on the tile.
//
// What bounds it: the bytes, in every call. Counting what the launches
// themselves move (ops/fused_block_cuda.launch_plan: each input map,
// weight and residual read once and each output written once; conv1's
// and conv2's outputs round-trip in bf16), at w64, batch 32, d0 moves
// 11.3 GB (3.37 ms at 3.35 TB/s; its products 0.90 ms at 989 TFLOP/s),
// d1 9.7 GB (2.89 ms; 1.39 ms), d2a 3.8 GB (1.12 ms; 1.09 ms) and d2b
// 3.2 GB (0.96 ms; 0.89 ms): 27.9 GB = 8.34 ms of bytes against 4.27 ms
// of tensor-core work. d0 and d1 are bytes-bound by 2-4x, d2a and d2b
// nearly balanced. The design answers the old limits (a cin-wide window
// in shared memory, weights read per warp) by streaming K chunks and
// staging weights once per block; what it adds is the intermediates'
// round trip, and the 3x3 conv2 re-reads its A boxes from L2 once per
// tap. The next steps: one halo box per channel chunk for conv2, then
// conv1 -> conv2 -> conv3 of a unit in shared memory (one launch per
// unit). The TPU's 8-row DMA alignment, 128-channel padding and
// compile-memory tile cap do not apply here.
//
// Plain C interface, loaded with ctypes (hover_net_tpu_torch/ops/
// fused_block_cuda.py): the wrapper allocates every buffer; the kernels
// launch on the caller's stream and the call returns the launch status.
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, fetched
// through cudaGetDriverEntryPointByVersion, so nothing links libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "fused_block_geom.cuh"

namespace {

using namespace k3;
typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // + one producer warp

template <int BN>
struct Cfg {
  static constexpr int kStageB = BN * kRowBytes;
  static constexpr int kStages = BN == 128 ? 3 : 4;
  // 1 KB of slack to align the stages to the swizzle atom, the stages,
  // then a full and an empty barrier per stage: <= 98 KB, two blocks/SM
  static constexpr int kSmem =
      1024 + kStages * (kStageA + kStageB) + 2 * kStages * 8;
};

struct GemmArgs {
  bf16* out;          // [n, s_out, s_out, cout]
  const bf16* res;    // residual, same shape (may alias out) or null
  const float* pre_s;  // pre-activation BN of A [cin] or null
  const float* pre_o;
  const float* s;      // epilogue BN [cout] + ReLU, or null
  const float* o;
  int s_out, cin, cout, stride, taps, th, tw, tw_log2, tiles_x;
  int sc_cin, sc_stride;  // the shortcut phase of unit 0's conv3 (SC)
};

// ------------------------------------------------------ bf16 arithmetic

__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ __nv_bfloat162 as_b2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The folded BN and ReLU of two bf16 lanes in float32, rounded to bf16
// once (round to nearest even): relu(round(x * s + o)), the product and
// the sum each an f32 op, as the plain version computes them.
__device__ __forceinline__ float bn_relu1(float x, float s, float o) {
  return fmaxf(__fadd_rn(__fmul_rn(x, s), o), 0.f);
}

__device__ __forceinline__ uint32_t bn_relu2(uint32_t x, float2 s, float2 o) {
  const float2 v = __bfloat1622float2(as_b2(x));
  return as_u32(__floats2bfloat162_rn(bn_relu1(v.x, s.x, o.x),
                                      bn_relu1(v.y, s.y, o.y)));
}

// eight lanes: `s` and `o` point at eight float32 values, 16-byte aligned
__device__ __forceinline__ uint4 bn_relu8(uint4 v, const float* s,
                                          const float* o) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(s));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(s) + 1);
  const float4 o0 = __ldg(reinterpret_cast<const float4*>(o));
  const float4 o1 = __ldg(reinterpret_cast<const float4*>(o) + 1);
  return make_uint4(bn_relu2(v.x, make_float2(s0.x, s0.y),
                             make_float2(o0.x, o0.y)),
                    bn_relu2(v.y, make_float2(s0.z, s0.w),
                             make_float2(o0.z, o0.w)),
                    bn_relu2(v.z, make_float2(s1.x, s1.y),
                             make_float2(o1.x, o1.y)),
                    bn_relu2(v.w, make_float2(s1.z, s1.w),
                             make_float2(o1.z, o1.w)));
}

__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  auto add2 = [](uint32_t x, uint32_t y) {
    return as_u32(__hadd2_rn(as_b2(x), as_b2(y)));
  };
  return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z),
                    add2(a.w, b.w));
}

// ------------------------------------------------- barriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of this parity has completed. A wait of
// more than 4 s traps: a wrong byte count is then a launch failure that
// the caller sees, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] B[16 x N]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// The pre-activation of units > 0, in place on this warpgroup's 64 rows
// of an A stage (512 swizzled 16-byte chunks, 4 a thread, one at a time:
// the 64 accumulators stay in registers). Channels past cin (the
// zero-filled rest of a chunk) stay zero.
__device__ __forceinline__ void preact_rows(uint8_t* rows, int t, int k0,
                                            const GemmArgs& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = t + 128 * i, row = idx >> 3, pc = idx & 7;
    const int ch = k0 + 8 * swz_chunk(row, pc);
    if (ch >= p.cin) continue;
    uint4* q = reinterpret_cast<uint4*>(rows + row * kRowBytes + pc * 16);
    *q = bn_relu8(*q, p.pre_s + ch, p.pre_o + ch);
  }
}

// ------------------------------------------------------------- the kernel

// SC: before its own product, the block runs unit 0's strided 1x1
// shortcut (map_sa: the unit input, map_sb: its weights) over the same
// output tile and keeps it, rounded to bf16, as the residual.
template <int BN, bool SC>
__global__ void __launch_bounds__(kThreads, 2)
    conv_gemm(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ CUtensorMap map_sa,
              const __grid_constant__ CUtensorMap map_sb, const GemmArgs p) {
  typedef Cfg<BN> C;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sa = base;                           // A stages
  const uint32_t sb = sa + C::kStages * kStageA;      // B stages
  const uint32_t full = sb + C::kStages * C::kStageB;  // + 8 * stage
  const uint32_t empty = full + 8 * C::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN;
  const int x0 = (blockIdx.y % p.tiles_x) * p.tw;
  const int y0 = (blockIdx.y / p.tiles_x) * p.th;
  const int img = blockIdx.z;
  const int kchunks = cdiv(p.cin, kBK);
  const int sc_iters = SC ? cdiv(p.sc_cin, kBK) : 0;
  const int iters = sc_iters + p.taps * kchunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one thread issues
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int st = it % C::kStages, round = it / C::kStages;
        if (round > 0) mbar_wait(empty + 8 * st, (round - 1) & 1);
        const bool sc = SC && it < sc_iters;
        const Box b = sc ? a_box(it, sc_iters, 1, p.sc_stride, x0, y0)
                         : a_box(it - sc_iters, kchunks, p.taps, p.stride, x0,
                                 y0);
        mbar_expect_tx(full + 8 * st, kStageA + C::kStageB);
        tma_load_4d(sa + st * kStageA, sc ? &map_sa : &map_a, full + 8 * st,
                    b.c, b.x, b.y, img);
        tma_load_3d(sb + st * C::kStageB, sc ? &map_sb : &map_b,
                    full + 8 * st, b.c, b.tap, n0);
      }
    }
    return;
  }

  // the consumer warpgroups: rows 64 * wg .. 64 * wg + 63 of the tile
  const int wg = warp >> 2, t = threadIdx.x & 127;
  float acc[BN / 2];
  uint32_t sc[SC ? BN / 4 : 1];  // the rounded shortcut, bf16 pairs
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int st = it % C::kStages;
    mbar_wait(full + 8 * st, (it / C::kStages) & 1);
    const uint32_t a_rows = sa + st * kStageA + wg * 64 * kRowBytes;
    const uint32_t b_rows = sb + st * C::kStageB;
    if (!SC && p.pre_s) {
      preact_rows(gbase + (a_rows - base), t, (it % kchunks) * kBK, p);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k)
      wgmma(acc, smem_desc(a_rows + 32 * k), smem_desc(b_rows + 32 * k));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous step's products are done: free it
    fence_acc(acc);
    if (it > 0 && lane == 0)
      mbar_arrive(empty + 8 * ((it - 1) % C::kStages));
    if (SC && it == sc_iters - 1) {  // the shortcut is done: round, restart
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < BN / 2; j += 2) {
        sc[j / 2] = pack2(f2bf(acc[j]), f2bf(acc[j + 1]));
        acc[j] = acc[j + 1] = 0.f;
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue. Both warpgroups are past their last product, so the stages
  // are free: stage the tile rounded to bf16 (rows padded by 16 bytes;
  // with SC, plus the rounded shortcut), then each thread takes 16-byte
  // chunks, consecutive threads on consecutive channels of a pixel, loads
  // all its residual chunks, and only then adds, applies BN + ReLU and
  // stores (out may alias res).
  constexpr int kLd = BN + 8;                    // staged row, elements
  constexpr int kChunks = BN / 8;                // 16-byte chunks a row
  constexpr int kPer = kBM * kChunks / kConsumers;
  bf16* const stg = reinterpret_cast<bf16*>(gbase);
  asm volatile("bar.sync 3, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    uint32_t v2 = pack2(f2bf(acc[j]), f2bf(acc[j + 1]));
    if (SC) v2 = as_u32(__hadd2_rn(as_b2(v2), as_b2(sc[j / 2])));
    *reinterpret_cast<uint32_t*>(stg + (wg * 64 + acc_row(t, j)) * kLd
                                 + acc_col(t, j)) = v2;
  }
  asm volatile("bar.sync 3, %0;" ::"n"(kConsumers) : "memory");
  uint4 v[kPer], r[kPer];
  size_t at[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int q = threadIdx.x + kConsumers * i, m = q / kChunks;
    const int c = (q % kChunks) * 8;
    const int oy = y0 + (m >> p.tw_log2), ox = x0 + (m & (p.tw - 1));
    at[i] = oy < p.s_out && ox < p.s_out
                ? (((size_t)img * p.s_out + oy) * p.s_out + ox) * p.cout + n0 + c
                : ~(size_t)0;
    v[i] = *reinterpret_cast<const uint4*>(stg + m * kLd + c);
    if (p.res && at[i] != ~(size_t)0)
      r[i] = *reinterpret_cast<const uint4*>(p.res + at[i]);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (at[i] == ~(size_t)0) continue;
    const int c = n0 + ((threadIdx.x + kConsumers * i) % kChunks) * 8;
    if (p.res) v[i] = add8(v[i], r[i]);
    if (p.s) v[i] = bn_relu8(v[i], p.s + c, p.o + c);
    *reinterpret_cast<uint4*>(p.out + at[i]) = v[i];
  }
}

// --------------------------------------------------------------- the host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int encode(CUtensorMap* map, const void* ptr, const MapGeom& g) {
  EncodeTiled fn = encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t dim[4], stride[3];
  cuuint32_t box[4], es[4];
  for (int i = 0; i < g.rank; ++i) {
    dim[i] = g.dim[i];
    box[i] = g.box[i];
    es[i] = g.estride[i];
    if (i + 1 < g.rank) stride[i] = g.stride[i];
  }
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.rank,
                  const_cast<void*>(ptr), dim, stride, box, es,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, bool SC>
int launch(const CUtensorMap* maps, const GemmArgs& a, dim3 grid,
           cudaStream_t stream) {
  // the shared-memory limit belongs to the function on a device: set it
  // once per instance and device (bit d of `set_on`)
  static std::atomic<uint32_t> set_on{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (!(set_on.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(conv_gemm<BN, SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<BN>::kSmem);
    if (err != cudaSuccess) return (int)err;
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  conv_gemm<BN, SC><<<grid, kThreads, Cfg<BN>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

// The strided 1x1 shortcut of unit 0 as a first phase of conv3's launch:
// xs [n, s_in, s_in, cin] (*) ws [cout][1][cin] at `stride`.
struct Shortcut {
  const void* xs;
  const void* ws;
  int s_in, cin, stride;
};

// One convolution: x [n, s_in, s_in, cin] (*) w [cout][taps][cin] at
// `stride` -> out [n, s_in / stride, ..., cout], with the optional
// pre-activation of x, residual (from memory, or the shortcut phase) and
// BN + ReLU. th = 0 picks the tile.
int conv(const void* x, int n, int s_in, int cin, const void* w, int taps,
         int cout, int stride, int th, void* out, const void* res,
         const void* pre_s, const void* pre_o, const void* s, const void* o,
         const Shortcut* sc, cudaStream_t stream) {
  const int s_out = s_in / stride;
  if (!th) th = default_th(s_out);
  GemmArgs a;
  a.out = static_cast<bf16*>(out);
  a.res = static_cast<const bf16*>(res);
  a.pre_s = static_cast<const float*>(pre_s);
  a.pre_o = static_cast<const float*>(pre_o);
  a.s = static_cast<const float*>(s);
  a.o = static_cast<const float*>(o);
  a.s_out = s_out;
  a.cin = cin;
  a.cout = cout;
  a.stride = stride;
  a.taps = taps;
  a.th = th;
  a.tw = tile_cols(th);
  a.tw_log2 = 0;
  while ((1 << a.tw_log2) < a.tw) ++a.tw_log2;
  a.tiles_x = cdiv(s_out, a.tw);
  a.sc_cin = sc ? sc->cin : 0;
  a.sc_stride = sc ? sc->stride : 1;
  const int tiles = a.tiles_x * cdiv(s_out, th);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  // with the shortcut phase the block also holds it in registers: <= 64
  const int bn = sc && n_tile(cout) == 128 ? 64 : n_tile(cout);
  CUtensorMap maps[4];
  int err = encode(&maps[0], x, a_map(n, s_in, cin, stride, th));
  if (!err) err = encode(&maps[1], w, b_map(cin, taps, cout, bn));
  if (!err && sc)
    err = encode(&maps[2], sc->xs, a_map(n, sc->s_in, sc->cin, sc->stride, th));
  if (!err && sc) err = encode(&maps[3], sc->ws, b_map(sc->cin, 1, cout, bn));
  if (err) return err;
  if (!sc) maps[2] = maps[3] = maps[0];  // unused
  const dim3 grid(cout / bn, tiles, n);
  if (sc) return bn == 64 ? launch<64, true>(maps, a, grid, stream)
                          : launch<32, true>(maps, a, grid, stream);
  if (bn == 128) return launch<128, false>(maps, a, grid, stream);
  if (bn == 64) return launch<64, false>(maps, a, grid, stream);
  return launch<32, false>(maps, a, grid, stream);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// One pre-activation bottleneck unit: x [n, s_in, s_in, cin] -> out [n,
// s_out, s_out, cout], through the scratch maps t [n, s_in, s_in, c1] and
// y [n, s_out, s_out, c1]. wsct (the strided 1x1 shortcut) marks unit 0;
// without it the shortcut is x itself, and out may be x (in place).
// th = 0 picks each launch's tile; th > 0 forces th x (128 / th) output
// tiles, and a th that is not a power of two in [1, 128] is refused.
int hnt_fused_unit(const void* x, void* out, void* t, void* y, int n,
                   int s_in, int s_out, int cin, int c1, int cout, int stride,
                   int th, const void* pre_s, const void* pre_o,
                   const void* w1t, const void* s1, const void* o1,
                   const void* w2t, const void* s2, const void* o2,
                   const void* w3t, const void* wsct, const void* sb,
                   const void* ob, void* stream) {
  if (n <= 0 || n > 65535 || s_in <= 0 || (th && !tile_ok(th)) || cin % 32
      || c1 % 32 || cout % 32 || (stride != 1 && stride != 2)
      || s_out * stride != s_in || (!wsct && (cin != cout || stride != 1))
      || !aligned16(x) || !aligned16(out) || !aligned16(t) || !aligned16(y)
      || !aligned16(w1t) || !aligned16(w2t) || !aligned16(w3t)
      || !aligned16(wsct) || !aligned16(pre_s) || !aligned16(pre_o)
      || !aligned16(s1) || !aligned16(o1) || !aligned16(s2) || !aligned16(o2)
      || !aligned16(sb) || !aligned16(ob))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // unit 0: conv3's launch runs the strided shortcut first (rounded
  // alone); later units add their own input
  const Shortcut sc = {x, wsct, s_in, cin, stride};
  int err = conv(x, n, s_in, cin, w1t, 1, c1, 1, th, t, nullptr, pre_s, pre_o,
                 s1, o1, nullptr, st);
  if (!err)
    err = conv(t, n, s_in, c1, w2t, 9, c1, stride, th, y, nullptr, nullptr,
               nullptr, s2, o2, nullptr, st);
  if (!err)
    err = conv(y, n, s_out, c1, w3t, 1, cout, 1, th, out, wsct ? nullptr : x,
               nullptr, nullptr, sb, ob, wsct ? &sc : nullptr, st);
  return err;
}

const char* hnt_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
