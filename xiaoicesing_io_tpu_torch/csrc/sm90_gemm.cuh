// Hopper GEMM core shared by csrc/lynx_conv.cu (K1), csrc/lynx_layer.cu (K5, K7),
// csrc/wavenet_block.cu (K4) and, through csrc/hifigan_tapconv.cuh, csrc/hifigan_stage.cu (K2) and
// csrc/hifigan_resblock.cu (K6); sm_90a.
//
//     out[b, r, n] = epilogue( sum_k A'[b, r, k] * B[n, k] )
//
// A is a bf16 tensor [batch, rows, A's width] read through a 3-D TMA tensor map; the reduction runs
// over K = taps * a_k (a_k: A's width rounded up to 64; TMA fills the columns past the width with
// zeros), where tap j reads A's rows shifted by tap_row[j] (one tap at 0: a plain product; K4's
// {-d, 0, d}: a dilated k=3 conv; a conv's kept taps at tap * d - pad_l: any conv over the rows of
// each batch entry, its all-zero taps left out by the host). Rows outside [0, rows) read as zero:
// TMA fills out-of-bounds boxes with zeros, which is exactly the conv's per-sequence zero padding,
// and the tail of a ragged last row tile. B is K-major bf16 [N, K] (row n holds output column n's
// weights). Both maps are 3-D (B's outer extent is 1).
//
// Design (one output tile of 128 rows x BN columns per block, BN = 128 or 256, BK = 64):
//   - copies: one producer thread issues TMA loads of the A and B tiles (128-byte swizzle, 64 bf16
//     a row) into a ring of kStages stages in shared memory, each with a full and an empty mbarrier;
//   - products: two consumer warpgroups, each owning 64 rows of the tile, run
//     wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate) from shared memory; one K block's group
//     stays in flight while the next is issued, and a stage goes back to the producer when its
//     group has completed;
//   - registers: setmaxnreg moves registers from the producer warpgroup (40) to the consumers (232);
//   - epilogue, one of two kinds:
//     * pairs: a functor's value() turns each pair of adjacent accumulator columns, with its
//       (batch, row, column), into a pair of outputs (Epi::Out: bf16 or f32); rows >= rows and
//       columns >= cols are never passed. With kPaired, tile p holds the columns p * BN/2.. of the
//       first and of the second half of a column-paired B (the host builds it), and value() gets
//       both halves of a column at once: in wgmma's accumulator layout columns c and c + BN/2 of a
//       tile sit in the same thread, so a gate can be register-local. The pairs are staged in
//       shared memory and written out in 16-byte pieces, a warp to a row of Epi::row(batch, row):
//       stored straight from the accumulator layout, a warp's pairs of bf16 would cover 16 bytes
//       of each of eight rows, half a sector each.
//     * rows (a functor with load4 and store4, see IsRowwise): the f32 accumulators themselves
//       are staged, and the functor gets four adjacent columns of one row at a time, neighbouring
//       threads on neighbouring columns, so an epilogue with several inputs and outputs (a
//       residual read, an f32 and a bf16 write) reads and writes each of them in whole sectors.
// Tensor maps are encoded on the host through sm90_encode_map (cuTensorMapEncodeTiled, looked up
// with cudaGetDriverEntryPoint, so the library links nothing) and passed to the kernel as
// __grid_constant__ parameters, as is Args (the producer indexes its tap table in place).
//
// A second entry, launch_persistent, runs the same products on a persistent schedule: one block an
// SM walks the output tiles in a fixed raster (tile = blockIdx.x + i * gridDim.x, N fastest, then
// rows, then batch), the ring's stage and phase carrying across tiles, so the producer loads the
// next tile's K blocks while the consumers run the current tile's epilogue. The epilogue stages
// its outputs in a buffer of its own (the next tile's loads are landing in the ring by then), in
// the 128-byte swizzle of 128-byte boxes, and TMA stores (cp.async.bulk.tensor, one bulk group a
// chunk) write them out while the consumers go on to the next tile's products; a warpgroup waits
// for its last store to have read the buffer (cp.async.bulk.wait_group.read) before writing it
// again. Its epilogue kinds: pairs (as above; kPaired too), and rows, whose functor has load4
// (a plain load, as above) and value4, which returns the four outputs instead of storing them;
// the thread pairs of the accumulator layout swap halves with one shuffle so that each thread
// holds four adjacent columns of one row, and with the accumulators live kPersistentBatch pieces
// are loaded ahead. Even so the rows kind spills at BN 256 (128 accumulators a thread), in K7's
// output product (lynx_layer.cu, LayerOut) and in the card tests' TestRows; no other kernel of
// lynx_layer.cu spills. chip_smoke.py prints each kernel's spill bytes from the build log, and
// PERF.md gives them. The buffer holds half of each warpgroup's columns, written in kRounds = 2
// rounds, and the ring gets what is left of the 227 KB: 4 stages at BN 256 (the whole tile
// beside 3 stages was slower, PERF.md).
//
// Not done yet: ping-pong consumers (one tile's epilogue under the other warpgroup's products).
// Two-block clusters multicasting B were tried and made both kernels slower (PERF.md).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

// Internal linkage: both libraries include this header, and a function-local static of an inline
// template (the per-device attribute flags below) would otherwise be one symbol for the whole
// process, shared between them.
namespace sm90 {
namespace {

constexpr int kBM = 128;        // rows of an output tile: two consumer warpgroups of 64
constexpr int kBK = 64;         // K per stage: one 128-byte swizzle row of bf16
constexpr int kThreads = 384;   // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int kConsumerWarps = 8;
constexpr int kMaxDevices = 64;
constexpr int kMaxTaps = 64;    // rows of the tap table

template <int BN>
struct Config {
  static_assert(BN == 128 || BN == 256, "wgmma tile width");
  static constexpr int kStages = BN == 256 ? 4 : 5;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // + 1024 to align the ring to the swizzle atom, + the barriers
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

struct Args {
  int rows;                // rows of one batch entry of A and of the output
  int cols;                // output columns (N)
  int a_k;                 // K of one tap: A's width rounded up to a multiple of 64
  int taps;                // K = taps * a_k, 1 <= taps <= kMaxTaps
  int tap_row[kMaxTaps];   // row shift of each tap
};

// An epilogue with store4() takes the rows kind (see the top of the file): for each piece of four
// columns the core calls load4(batch, row, col), which returns Epi::In (what the piece reads from
// device memory), for kBatch pieces, then store4(batch, row, col, z, in) for the same pieces.
// Every load of a batch is issued before its first store: the compiler cannot tell the outputs
// from the inputs, and would otherwise wait out each load's latency behind the last store.
template <class E, class = void>
struct IsRowwise : std::false_type {};
template <class E>
struct IsRowwise<E, std::void_t<decltype(&E::store4)>> : std::true_type {};

// ---- device helpers -----------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of the given parity to complete. A wait that lasts seconds is a pipeline
// fault, never a legitimate wait: trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  if (mbar_try_wait(b, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(b, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile stored by TMA with the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO), layout type 1 (B128). The leading offset is
// unused for swizzled K-major layouts. K steps of 16 bf16 inside the 64-wide row add 32 bytes to
// the start address (+2 in the descriptor's 16-byte units); the tile base is 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N]^T, A and B K-major in shared memory; scale_d = 0 ignores D.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 128) {
    wgmma_m64n128k16(d, da, db, scale_d);
  } else {
    wgmma_m64n256k16(d, da, db, scale_d);
  }
}

// ---- the kernel ---------------------------------------------------------------------------------

template <int BN, bool kPaired, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ Args args, const Epi epi) {
  using Cfg = Config<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kStages * Cfg::kStageBytes);
  uint64_t* empty = full + Cfg::kStages;

  const int n_tile = blockIdx.x;
  const int m_tile = blockIdx.y;
  const int batch = blockIdx.z;
  const int k_blocks = args.taps * args.a_k / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      const int a_blocks = args.a_k / kBK;
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* sa = smem + stage * Cfg::kStageBytes;
        mbar_expect_tx(&full[stage], Cfg::kStageBytes);
        const int tap = kb / a_blocks;
        const int row = m_tile * kBM + args.tap_row[tap];
        tma_load_3d(sa, &map_a, &full[stage], (kb - tap * a_blocks) * kBK, row, batch);
        tma_load_3d(sa + Cfg::kABytes, &map_b, &full[stage], kb * kBK, n_tile * BN, 0);
        if (++stage == Cfg::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg * 64 .. + 64 of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // No instruction but the products touches the accumulators until the last wait: the first
    // product ignores them (scale-d 0) instead of reading zeros, so the products never serialise.
    float acc[BN / 2];
    // One group of products stays in flight: after issuing K block kb, wait for kb - 1's group
    // and hand its stage back to the producer.
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < k_blocks; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint8_t* sa = smem + stage * Cfg::kStageBytes;
      const uint64_t da = desc_sw128(sa + wg * 64 * kBK * 2);
      const uint64_t db = desc_sw128(sa + Cfg::kABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk, (kb | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kb > 0) {
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == Cfg::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operand(acc);

    // ---- epilogue: accumulator element i of a thread is row 16 w + lane / 4 + 8 ((i / 2) % 2),
    // column 8 (i / 4) + 2 (lane % 4) + i % 2 of its warpgroup's 64 x BN tile. The functor's
    // pairs (or, for the rows kind, the accumulators) are staged in shared memory (the ring, idle
    // once both warpgroups are done with it), then each warpgroup writes its 64 rows out,
    // neighbouring threads on neighbouring columns ----
    const int lane = threadIdx.x & 31;
    const int r0 = ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // row in the warpgroup's 64
    const int row_base = m_tile * kBM + wg * 64;
    const int c0 = 2 * (lane & 3);
    if constexpr (IsRowwise<Epi>::value) {
      static_assert(!kPaired, "the rows kind takes a plain product");
      // rows padded by 8 floats: a half warp's pair writes (4 rows x 4 lanes) miss no bank twice
      constexpr int kRowFloats = BN + 8;
      static_assert(kBM * kRowFloats * 4 <= Cfg::kStages * Cfg::kStageBytes, "staging");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both warpgroups are off the ring
      float* tile = reinterpret_cast<float*>(smem) + wg * 64 * kRowFloats;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * kRowFloats + 8 * j + c0) =
              make_float2(acc[i], acc[i + 1]);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      const int t = threadIdx.x & 127;
      const int col_base = n_tile * BN;
      constexpr int kQuads = BN / 4;             // pieces of a row
      constexpr int kPieces = 64 * kQuads / 128;  // pieces a thread
      constexpr int kBatch = Epi::kBatch < kPieces ? Epi::kBatch : kPieces;
      static_assert(kPieces % kBatch == 0, "batches");
#pragma unroll
      for (int p0 = 0; p0 < kPieces; p0 += kBatch) {
        typename Epi::In in[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int q = t + 128 * (p0 + j);
          const int r = row_base + q / kQuads, c = col_base + (q % kQuads) * 4;
          if (r < args.rows && c < args.cols) in[j] = epi.load4(batch, r, c);  // cols % 4 == 0
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int q = t + 128 * (p0 + j);
          const int r = row_base + q / kQuads, c = col_base + (q % kQuads) * 4;
          const float* z = tile + (q / kQuads) * kRowFloats + (q % kQuads) * 4;
          if (r < args.rows && c < args.cols) {
            epi.store4(batch, r, c, *reinterpret_cast<const float4*>(z), in[j]);
          }
        }
      }
    } else {
      using Out = typename Epi::Out;
      using Pair = typename Epi::Pair;
      constexpr int kOutCols = kPaired ? BN / 2 : BN;  // output columns of a tile
      // rows padded by four pairs: the pair writes of a warp (8 rows x 4 lanes) miss no bank twice
      constexpr int kRowBytes = kOutCols * (int)sizeof(Out) + 4 * (int)sizeof(Pair);
      constexpr int kChunks = kOutCols * (int)sizeof(Out) / 16;  // 16-byte pieces of a row
      constexpr int kPerChunk = 16 / (int)sizeof(Out);
      static_assert(kBM * kRowBytes <= Cfg::kStages * Cfg::kStageBytes, "staging");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both warpgroups are off the ring
      uint8_t* tile = smem + wg * 64 * kRowBytes;
      const int col_base = n_tile * kOutCols;
      const int out_cols = kPaired ? args.cols / 2 : args.cols;
#pragma unroll
      for (int j = 0; j < kOutCols / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const int i = 4 * j + 2 * h;
          const int col = col_base + 8 * j + c0;
          if (row_base + r < args.rows && col < out_cols) {
            Pair v;
            if constexpr (kPaired) {
              const int i2 = i + BN / 4;  // column c + BN / 2 of the tile
              v = epi.value(batch, row_base + r, col, acc[i], acc[i + 1], acc[i2], acc[i2 + 1]);
            } else {
              v = epi.value(batch, row_base + r, col, acc[i], acc[i + 1]);
            }
            *reinterpret_cast<Pair*>(tile + r * kRowBytes + (8 * j + c0) * (int)sizeof(Out)) = v;
          }
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      const int t = threadIdx.x & 127;
#pragma unroll 4
      for (int q = t; q < 64 * kChunks; q += 128) {
        const int r = q / kChunks;
        const int ch = q % kChunks;
        const int col = col_base + ch * kPerChunk;
        if (row_base + r < args.rows && col + kPerChunk <= out_cols) {
          *reinterpret_cast<uint4*>(epi.row(batch, row_base + r) + col) =
              *reinterpret_cast<const uint4*>(tile + r * kRowBytes + ch * 16);
        }
      }
    }
  }
}

// out[b * rows + r, n] = acc + bias[n] as bf16, ld = cols: a plain product's epilogue.
struct StoreBiasBf16 {
  using Out = __nv_bfloat16;
  using Pair = __nv_bfloat162;
  const float* bias;
  __nv_bfloat16* out;
  int rows;
  int cols;
  __device__ __forceinline__ Pair value(int, int, int n, float v0, float v1) const {
    const float2 bn = *reinterpret_cast<const float2*>(bias + n);
    return __floats2bfloat162_rn(v0 + bn.x, v1 + bn.y);
  }
  __device__ __forceinline__ Out* row(int b, int r) const { return out + ((size_t)b * rows + r) * cols; }
};

// ---- the persistent schedule --------------------------------------------------------------------

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The stores committed so far have read their shared memory (they may still be writing).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to the TMA unit (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A persistent epilogue of the rows kind: load4 and value4 (see the top of the file).
template <class E, class = void>
struct IsRowwiseValue : std::false_type {};
template <class E>
struct IsRowwiseValue<E, std::void_t<decltype(&E::value4)>> : std::true_type {};

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can have on an H100
constexpr int kBox = 128;           // bytes of a store box's row: the 128-byte swizzle span
constexpr int kBoxRows = 64;        // rows of a store box: one warpgroup's rows of the tile
constexpr int kPersistentBatch = 2;  // pieces a rows-kind epilogue loads before storing any

template <int BN, bool kPaired, class Out>
struct PersistentConfig {
  static constexpr int kRounds = 2;                            // epilogue rounds of a tile
  static constexpr int kOutCols = kPaired ? BN / 2 : BN;       // output columns of a tile
  static constexpr int kChunkCols = kOutCols / kRounds;        // of one round of the epilogue
  static constexpr int kChunkBytes = kChunkCols * (int)sizeof(Out);
  static_assert(kChunkBytes % kBox == 0, "whole boxes");
  static constexpr int kBoxes = kChunkBytes / kBox;            // store boxes a round
  static constexpr int kBoxBytes = kBoxRows * kBox;
  static constexpr int kBufBytes = kBoxes * kBoxBytes;         // one warpgroup's buffer
  static constexpr int kStageBytes = Config<BN>::kStageBytes;
  static constexpr int kFit = (kSmemLimit - 1024 - 2 * 8 * 8 - 2 * kBufBytes) / kStageBytes;
  static constexpr int kStages = kFit < 5 ? kFit : 5;
  static_assert(kStages >= 2, "the ring needs two stages at least");
  static constexpr int kSmem = kStages * kStageBytes + 2 * kBufBytes + 1024 + 2 * kStages * 8;
};

// Byte offset of (row, byte) of a round's outputs in a warpgroup's buffer: box byte / 128, then
// the row's 128 bytes with its 16-byte pieces swizzled as TMA's 128-byte swizzle reads them.
__device__ __forceinline__ int swizzled(int row, int byte) {
  return (byte / kBox) * (kBoxRows * kBox) + row * kBox +
         ((((byte % kBox) >> 4) ^ (row & 7)) << 4) + (byte & 15);
}

template <int BN, bool kPaired, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_persistent_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_out,
                           const __grid_constant__ Args args, const int batch, const Epi epi) {
  using Cfg = Config<BN>;
  using Out = typename Epi::Out;
  using PC = PersistentConfig<BN, kPaired, Out>;
  constexpr bool kRows = IsRowwiseValue<Epi>::value;
  static_assert(!(kRows && kPaired), "the rows kind takes a plain product");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* epi_buf = smem + PC::kStages * Cfg::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi_buf + 2 * PC::kBufBytes);
  uint64_t* empty = full + PC::kStages;

  const int n_tiles = (args.cols + BN - 1) / BN;
  const int m_tiles = (args.rows + kBM - 1) / kBM;
  const int tiles = n_tiles * m_tiles * batch;
  const int k_blocks = args.taps * args.a_k / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < PC::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread walks the block's tiles and keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      const int a_blocks = args.a_k / kBK;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n_tile = tile % n_tiles;
        const int m_tile = (tile / n_tiles) % m_tiles;
        const int b = tile / (n_tiles * m_tiles);
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sa = smem + stage * Cfg::kStageBytes;
          mbar_expect_tx(&full[stage], Cfg::kStageBytes);
          const int tap = kb / a_blocks;
          const int row = m_tile * kBM + args.tap_row[tap];
          tma_load_3d(sa, &map_a, &full[stage], (kb - tap * a_blocks) * kBK, row, b);
          tma_load_3d(sa + Cfg::kABytes, &map_b, &full[stage], kb * kBK, n_tile * BN, 0);
          if (++stage == PC::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg * 64 .. + 64 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int t = threadIdx.x & 127;
    const int r0 = ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // row in the warpgroup's 64
    const int c0 = 2 * (lane & 3);
    const int out_cols = kPaired ? args.cols / 2 : args.cols;
    uint8_t* buf = epi_buf + wg * PC::kBufBytes;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n_tile = tile % n_tiles;
      const int m_tile = (tile / n_tiles) % m_tiles;
      const int b = tile / (n_tiles * m_tiles);
      float acc[BN / 2];
      int prev = 0;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* sa = smem + stage * Cfg::kStageBytes;
        const uint64_t da = desc_sw128(sa + wg * 64 * kBK * 2);
        const uint64_t db = desc_sw128(sa + Cfg::kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk, (kb | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (kb > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == PC::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operand(acc);
      // the tile's last stage goes back too: the producer is already on the next tile
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);

      // ---- epilogue, in kRounds rounds of kChunkCols output columns: values into the
      // swizzled buffer, then one thread stores the round's boxes ----
      const int row_base = m_tile * kBM + wg * 64;
      const int col_base = n_tile * PC::kOutCols;
#pragma unroll
      for (int c = 0; c < PC::kRounds; ++c) {
        if (t == 0) bulk_wait_read();  // the buffer's last store has read it
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
        if constexpr (kRows) {
          // Lanes l and l ^ 1 hold columns c0, c0 + 1 of rows r0 and r0 + 8 each; one shuffle
          // gives the even lane four columns of row r0 and the odd lane four of row r0 + 8.
          // at most kPersistentBatch pieces' inputs in flight: the accumulators stay live here
          constexpr int kJ = BN / 8 / PC::kRounds;
          constexpr int kB = Epi::kBatch < kPersistentBatch ? Epi::kBatch : kPersistentBatch;
          constexpr int kBatch = kB < kJ ? kB : kJ;
          static_assert(kJ % kBatch == 0, "batches");
          const int odd = lane & 1;
          const int rr = r0 + 8 * odd;
          const int r = row_base + rr;
          const int cq = 4 * ((lane & 3) >> 1);
#pragma unroll
          for (int j0 = 0; j0 < kJ; j0 += kBatch) {
            typename Epi::In in[kBatch];
#pragma unroll
            for (int jj = 0; jj < kBatch; ++jj) {
              const int col = col_base + 8 * (c * kJ + j0 + jj) + cq;
              if (r < args.rows && col < args.cols) in[jj] = epi.load4(b, r, col);
            }
#pragma unroll
            for (int jj = 0; jj < kBatch; ++jj) {
              const int j = c * kJ + j0 + jj;
              const int i = 4 * j;
              const float send_x = odd ? acc[i] : acc[i + 2];
              const float send_y = odd ? acc[i + 1] : acc[i + 3];
              const float got_x = __shfl_xor_sync(0xffffffffu, send_x, 1);
              const float got_y = __shfl_xor_sync(0xffffffffu, send_y, 1);
              const float4 z = odd ? make_float4(got_x, got_y, acc[i + 2], acc[i + 3])
                                   : make_float4(acc[i], acc[i + 1], got_x, got_y);
              const int col = col_base + 8 * j + cq;
              if (r < args.rows && col < args.cols) {
                *reinterpret_cast<typename Epi::Out4*>(
                    buf + swizzled(rr, (8 * (j0 + jj) + cq) * (int)sizeof(Out))) =
                    epi.value4(b, r, col, z, in[jj]);
              }
            }
          }
        } else {
          using Pair = typename Epi::Pair;
          constexpr int kJ = PC::kOutCols / 8 / PC::kRounds;
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj) {
            const int j = c * kJ + jj;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rr = r0 + 8 * h;
              const int i = 4 * j + 2 * h;
              const int col = col_base + 8 * j + c0;
              if (row_base + rr < args.rows && col < out_cols) {
                Pair v;
                if constexpr (kPaired) {
                  const int i2 = i + BN / 4;  // column c + BN / 2 of the tile
                  v = epi.value(b, row_base + rr, col, acc[i], acc[i + 1], acc[i2], acc[i2 + 1]);
                } else {
                  v = epi.value(b, row_base + rr, col, acc[i], acc[i + 1]);
                }
                *reinterpret_cast<Pair*>(buf + swizzled(rr, (8 * jj + c0) * (int)sizeof(Out))) =
                    v;
              }
            }
          }
        }
        fence_async_shared();
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
        if (t == 0 && row_base < args.rows) {
#pragma unroll
          for (int x = 0; x < PC::kBoxes; ++x) {
            const int col = col_base + c * PC::kChunkCols + x * (kBox / (int)sizeof(Out));
            if (col < out_cols) tma_store_3d(&map_out, buf + x * PC::kBoxBytes, col, row_base, b);
          }
          bulk_commit();
        }
      }
    }
    if (t == 0) bulk_wait();  // the block's stores are done before its shared memory goes
  }
}

// ---- host side ----------------------------------------------------------------------------------

inline CUtensorMap load_map(const void* host_bytes) {
  CUtensorMap m;
  std::memcpy(&m, host_bytes, sizeof(m));
  return m;
}

template <int BN, bool kPaired, class Epi>
inline cudaError_t launch(const void* map_a, const void* map_b, const Args& args, int batch,
                          const Epi& epi, cudaStream_t stream) {
  const int m_tiles = (args.rows + kBM - 1) / kBM;
  if (args.rows < 1 || args.cols < 1 || args.a_k < kBK || args.a_k % kBK || args.taps < 1 ||
      args.taps > kMaxTaps || args.cols % 8 || batch < 1 || batch > 65535 || m_tiles > 65535 ||
      (kPaired && args.cols % BN)) {
    return cudaErrorInvalidValue;
  }
  using Cfg = Config<BN>;
  auto kernel = gemm_kernel<BN, kPaired, Epi>;
  // the attribute belongs to a device: set it once for each
  static bool smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices || !smem_set[device]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) smem_set[device] = true;
  }
  const dim3 grid((args.cols + BN - 1) / BN, m_tiles, batch);
  kernel<<<grid, kThreads, Cfg::kSmem, stream>>>(load_map(map_a), load_map(map_b), args, epi);
  return cudaGetLastError();
}

// The persistent entry: map_out is the output's store map (sm90_encode_store_map, boxes of 64 rows
// x 128 bytes, 128-byte swizzle). Grid: one block an SM, fewer when there are fewer tiles.
template <int BN, bool kPaired, class Epi>
inline cudaError_t launch_persistent(const void* map_a, const void* map_b, const void* map_out,
                                     const Args& args, int batch, const Epi& epi,
                                     cudaStream_t stream) {
  const long long m_tiles = (args.rows + kBM - 1) / kBM;
  const long long tiles = ((long long)args.cols + BN - 1) / BN * m_tiles * batch;
  if (args.rows < 1 || args.cols < 1 || args.a_k < kBK || args.a_k % kBK || args.taps < 1 ||
      args.taps > kMaxTaps || args.cols % 8 || batch < 1 || tiles > 0x7fffffffLL ||
      (kPaired && args.cols % BN)) {
    return cudaErrorInvalidValue;
  }
  using PC = PersistentConfig<BN, kPaired, typename Epi::Out>;
  auto kernel = gemm_persistent_kernel<BN, kPaired, Epi>;
  static bool smem_set[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  int n_sms = device < kMaxDevices ? sms[device] : 0;
  if (n_sms == 0) {
    e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) sms[device] = n_sms;
  }
  if (device >= kMaxDevices || !smem_set[device]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PC::kSmem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) smem_set[device] = true;
  }
  const int grid = (int)(tiles < n_sms ? tiles : n_sms);
  kernel<<<grid, kThreads, PC::kSmem, stream>>>(load_map(map_a), load_map(map_b),
                                                  load_map(map_out), args, batch, epi);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

}  // namespace
}  // namespace sm90

// The tensor map of a row-major bf16 tensor seen as [d2, d1, d0] (d0 innermost, d0 * 2 bytes a
// row; s1, s2 the byte strides of dimensions 1 and 2), box {64, box_rows, 1}, 128-byte swizzle,
// zero fill out of bounds. Writes the 128-byte map to out; returns a CUDA error code, 0 on success.
extern "C" int sm90_encode_map(void* out, const void* base, long long d0, long long d1,
                               long long d2, long long s1, long long s2, int box_rows) {
  sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)sm90::kBK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  std::memcpy(out, &map, sizeof(map));
  return 0;
}

// The store map of a row-major f32 (elem_bytes 4) or bf16 (2) tensor seen as [d2, d1, d0], for
// the persistent entry's TMA stores: box {128 bytes of a row, 64 rows, 1}, 128-byte swizzle (the
// layout its epilogue stages). Returns a CUDA error code, 0 on success.
extern "C" int sm90_encode_store_map(void* out, const void* base, long long d0, long long d1,
                                     long long d2, long long s1, long long s2, int elem_bytes) {
  sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)(sm90::kBox / elem_bytes), (cuuint32_t)sm90::kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      &map, elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  std::memcpy(out, &map, sizeof(map));
  return 0;
}
