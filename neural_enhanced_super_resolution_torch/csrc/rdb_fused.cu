// K2: one whole residual dense block (RDB) of RRDBNet in one launch.
//
// Replaces kernels/rdb_dform.py:_mk_kernel via rdb_dform_call (the fused
// whole-RDB Pallas kernel of the JAX package), with its v2 numerics
// (rdb_dform_reference(..., v2=True)): each conv output is rounded to bf16
// once, before the dense-block assembly adds, and every assembly slot is
// rounded to bf16 as it is updated. The D-form / rows-s2d I/O format, the
// line buffer and the v1/v3 schedules are TPU artifacts and are not ported:
// input and output are plain (N, H, W, 64) bf16 NHWC.
//
// Weights are the source-major fused layout of fuse_rdb (models/rrdbnet.py):
// w0 (3,3,64,192), w1 (3,3,32,160), w2 (3,3,32,128), w3 (3,3,32,96), w4
// (3,3,32,64), bias (192,) fp32 = conv1..conv5 biases, each weight packed
// by K1's kernels/conv3x3.py:pack_conv3x3_weights (w0 as 2 N tiles of 96,
// w1 as 2 of 80, w2 128, w3 96, w4 64; slabs of 64 (w0) or 32 input
// channels by N). Conv s produces [x_{s+1} pre-activation | slots
// a_{s+2}.. (32 each) | a5 (64)], so the five convs need no concatenated
// input.
//
// Schedule: halo recompute. A block owns an 8x8 output tile, stages its
// 18x18x64 input (5-px halo), and each of the five stages shrinks the
// valid region by one pixel; x1..x4 and the slots stay in shared memory.
// Every stage computes 16-pixel-wide rows (16, 14, 12, 10, 8 rows), about
// 3.4x the RDB's FLOPs, and with wgmma's 64-row M tiles ~110 MFLOP a
// block (~507 GFLOP a launch on the 4 x 268 x 268 tile batch: a floor of
// ~0.51 ms at 989 TFLOP/s). The schedule is kept from the first design so
// that this one changes only the machinery under it, which the first
// design's phase clock showed to be its bound (synchronous weight
// staging 29% of a block, mma.sync with idle warps, a scalar epilogue).
//
// What bounds it on an H100, on the 4 x 268 x 268 tile batch: 1.13 ms by
// device time, 12% of the RDB's own bound (0.1392 ms, operations) and 45%
// of this schedule's floor (PERF.md, tools/k2_ablation.py). One block an
// SM runs its phases in turn: thread 0's clock puts 41% of a block in the
// MMAs (near the tensor cores' peak while they run), 24% in waits for
// weight slabs (each block streams all 479 KB from L2), 18% at barriers
// and 17% in the epilogue. Only a row walk without halo recompute goes
// below the floor; short of it, the phases can overlap and a tile can read
// fewer weight bytes from L2.
//
// Machinery (K1's, csrc/conv3x3.cu):
//  * The RDB's 63 weight slabs (479,232 bytes) form one sequence across
//    the five stages. Thread 0 moves each with one cp.async.bulk into a
//    ring of RING slots of the largest slab (12,288 bytes) with full/empty
//    mbarriers, and refills a slot two slabs after every warp released it,
//    so the next stage's first slabs arrive during this stage's epilogue.
//  * Four warpgroups, one 64-row M tile each (four 16-pixel stage rows, one
//    a warp), issue wgmma.mma_async m64nNk16 with A from ldmatrix of the
//    stage's source buffer (two fragment sets alternating by tap) and B
//    from the ring by descriptor. Each stage is its own template
//    instantiation, so N and the k-steps are immediates and no wgmma sits
//    under a branch over them. A slot goes back to the ring only after
//    wgmma.wait_group retires the MMAs that read it.
//  * Stages 1 and 3 (14 and 10 rows) end on an M tile with 2 dead rows:
//    their ldmatrix rows are clamped to the stage's last real row and
//    their results dropped. Stages 2-4 have 3, 3 and 2 M tiles: a
//    warpgroup without one only waits for each slab and releases it, so
//    the tensor cores serve the others (the SM's tensor cores are shared,
//    so the stage costs its M tiles' work, not 4 of them).
//  * The epilogue turns each accumulator pair (two adjacent channels of a
//    pixel) into x_{s+1} (bias, LeakyReLU, zero outside the image) or a
//    slot update, one bf16x2 word at a time, and at stage 4 into y = x +
//    0.2 x5. The slots' pixel pitch is padded by 16 bytes, so a fragment's
//    stores are free of bank conflicts.
#include "common.cuh"
#include "wgmma.cuh"

// Phase-clock hooks: empty here; tools/k2_ablation.py defines K2_CLOCK and
// builds a copy whose thread 0 charges the SM clocks since its previous
// mark to (stage, phase): 0 weights, 1 MMA, 2 epilogue, 3 waiting for the
// other warps; stage 5 is the input staging.
#ifndef K2_CLOCK
#define K2_CLOCK_INIT
#define K2_PHASE(stage, phase)
#define K2_CLOCK_STORE
#endif

namespace {

using nesr::bf16;

constexpr int NFEAT = 64;   // trunk features
constexpr int GROW = 32;    // growth channels
constexpr int T = 8;        // output tile edge
constexpr int SW = 18;      // source row width of every stage (16 + 2)
constexpr int NWG = 4;      // warpgroups: one 64-row M tile each
constexpr int WARPS = 4 * NWG;
constexpr int THREADS = 32 * WARPS;
constexpr int XP = NFEAT + 8;   // input pixel pitch (elements)
constexpr int GP = GROW + 8;    // x_k pixel pitch
constexpr int NBIAS = 4 * GROW + NFEAT;
constexpr int RING = 6;         // weight ring slots
constexpr int SLOT_BYTES = 2 * NFEAT * 96;   // the largest slab (w0's)

// Conv s: Cin, Cout, its N tiles (kernels/conv3x3.py:tile_width), the
// first slab of the RDB's sequence it reads.
__host__ __device__ constexpr int stage_cin(int s) {
  return s == 0 ? NFEAT : GROW;
}
__host__ __device__ constexpr int stage_cout(int s) {
  return NBIAS - s * GROW;
}
__host__ __device__ constexpr int stage_nt(int s) {
  return stage_cout(s) > 128 ? 2 : 1;
}
__host__ __device__ constexpr int stage_slab(int s) {   // elements
  return stage_cin(s) * stage_cout(s) / stage_nt(s);
}
__host__ __device__ constexpr int stage_g0(int s) {
  return s == 0 ? 0 : stage_g0(s - 1) + 9 * stage_nt(s - 1);
}
constexpr int NSLAB = stage_g0(5);
static_assert(NSLAB == 63, "K2: 63 slabs an RDB");
static_assert(2 * stage_slab(0) == SLOT_BYTES && stage_slab(1) <= stage_slab(0)
              && stage_slab(2) <= stage_slab(0), "K2: slot size");

template <int S>
struct Stage {
  static constexpr int CIN = stage_cin(S), KS = CIN / 16;
  static constexpr int SP = S == 0 ? XP : GP;   // source pixel pitch
  static constexpr int NT = stage_nt(S), N = stage_cout(S) / NT;
  static constexpr int ROWS = 16 - 2 * S, MT = (ROWS + 3) / 4;
  static constexpr int G0 = stage_g0(S);
};

// Shared memory (bytes): [ring][input][x_k ping-pong][slots a2..a5]
// [bias][full bars][empty bars].
constexpr int XIN_BYTES = SW * SW * XP * 2;        // input, 5-px halo
constexpr int XB_BYTES = 16 * SW * GP * 2;         // x_k buffer
constexpr int SLP = GROW + 8;                      // a2..a4 pixel pitch
constexpr int S5P = NFEAT + 8;                     // a5 pixel pitch
constexpr int A2_BYTES = 14 * 16 * SLP * 2;        // slot a2 (stage-1 rows)
constexpr int A3_BYTES = 12 * 16 * SLP * 2;
constexpr int A4_BYTES = 10 * 16 * SLP * 2;
constexpr int A5_BYTES = T * T * S5P * 2;          // only the kept tile
constexpr int XIN_OFF = RING * SLOT_BYTES;
constexpr int XB_OFF = XIN_OFF + XIN_BYTES;
constexpr int A2_OFF = XB_OFF + 2 * XB_BYTES;
constexpr int A3_OFF = A2_OFF + A2_BYTES;
constexpr int A4_OFF = A3_OFF + A3_BYTES;
constexpr int A5_OFF = A4_OFF + A4_BYTES;
constexpr int BIAS_OFF = A5_OFF + A5_BYTES;
constexpr int BAR_OFF = BIAS_OFF + NBIAS * 4;
constexpr int SMEM_BYTES = BAR_OFF + 2 * RING * 8;
static_assert(SMEM_BYTES + 1024 <= 233472, "K2: one block an SM");

struct Params {
  const bf16* x;
  const bf16* w0;   // packed (pack_conv3x3_weights)
  const bf16* w1;
  const bf16* w2;
  const bf16* w3;
  const bf16* w4;
  const float* bias;
  bf16* y;
  int H, W, tiles_x;
};

struct Ctx {
  unsigned char* smem;
  bf16* xin;
  const float* bias;   // shared copy
  bf16* y;
  int n, H, W, oy, ox;
  uint32_t ring, full, empty;   // shared addresses
};

// Slot a_m (m = 2..5) in shared memory, selected without indexing an array.
__device__ __forceinline__ bf16* slot_ptr(const Ctx& c, int m) {
  return reinterpret_cast<bf16*>(
      c.smem + (m == 2 ? A2_OFF : m == 3 ? A3_OFF : m == 4 ? A4_OFF : A5_OFF));
}
__device__ __forceinline__ int slot_rows(int m) { return 16 - 2 * (m - 1); }
__device__ __forceinline__ int slot_cols(int m) { return m == 5 ? T : 16; }
__device__ __forceinline__ int slot_pitch(int m) { return m == 5 ? S5P : SLP; }

// Thread 0: slab g of the RDB's sequence into its ring slot.
__device__ __forceinline__ void issue_slab(const Params& p, const Ctx& c,
                                           int g) {
  const bf16* src;
  int elems;
  if (g < stage_g0(1)) {
    src = p.w0 + (size_t)g * stage_slab(0);
    elems = stage_slab(0);
  } else if (g < stage_g0(2)) {
    src = p.w1 + (size_t)(g - stage_g0(1)) * stage_slab(1);
    elems = stage_slab(1);
  } else if (g < stage_g0(3)) {
    src = p.w2 + (size_t)(g - stage_g0(2)) * stage_slab(2);
    elems = stage_slab(2);
  } else if (g < stage_g0(4)) {
    src = p.w3 + (size_t)(g - stage_g0(3)) * stage_slab(3);
    elems = stage_slab(3);
  } else {
    src = p.w4 + (size_t)(g - stage_g0(4)) * stage_slab(4);
    elems = stage_slab(4);
  }
  const int s = g % RING;
  nesr::bulk_load(c.ring + s * SLOT_BYTES, src, elems * 2, c.full + 8 * s);
}

// A channel pair of conv S's output: channels co, co+1 (co even, so both
// land in one slot) at row r, column i of the stage-S region, conv values
// v0, v1 (fp32 accumulators). Loads and stores move the pair as one
// bf16x2 word; with the slots' 40-element pixel pitch the 32 lanes of a
// fragment store (8 pixels x 4 pairs) hit 32 distinct banks.
template <int S>
__device__ __forceinline__ void rdb_emit(const Ctx& c, int r, int i, int co,
                                         float v0, float v1, bf16* xdst) {
  const int gy = c.oy - 4 + S + r, gx = c.ox - 4 + S + i;
  const bool inimg = gy >= 0 && gy < c.H && gx >= 0 && gx < c.W;
  const float c0 = nesr::round_bf16(v0), c1 = nesr::round_bf16(v1);
  if (S < 4 && co < GROW) {
    // x_{S+1} = lrelu(a_{S+1} + c_S + b), zero outside the image (the next
    // conv's SAME padding).
    float u0 = c0, u1 = c1;
    if (S > 0) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          slot_ptr(c, S + 1) + (r * 16 + i) * SLP + co));
      u0 += a.x;
      u1 += a.y;
    }
    u0 = nesr::lrelu(u0 + c.bias[GROW * S + co]);
    u1 = nesr::lrelu(u1 + c.bias[GROW * S + co + 1]);
    *reinterpret_cast<__nv_bfloat162*>(xdst + (r * SW + i) * GP + co) =
        inimg ? __floats2bfloat162_rn(u0, u1) : __floats2bfloat162_rn(0.f, 0.f);
    return;
  }
  constexpr int nslots32 = GROW * (4 - S);  // channels of 32-wide slots
  int m, ch;
  if (co < nslots32) {
    m = S + 1 + co / GROW;
    ch = co % GROW;
  } else {
    m = 5;
    ch = co - nslots32;
  }
  const int d = m - 1 - S;  // region offset to the consumer stage
  const int rr = r - d, ii = i - d;
  if (rr < 0 || rr >= slot_rows(m) || ii < 0 || ii >= slot_cols(m)) return;
  auto* slot = reinterpret_cast<__nv_bfloat162*>(
      slot_ptr(c, m) + (rr * slot_cols(m) + ii) * slot_pitch(m) + ch);
  if (S == 4) {
    // x5 = a5 + c4 + b5; out = x + 0.2 * x5 on the 8x8 tile.
    if (inimg) {
      const float2 a = __bfloat1622float2(*slot);
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              c.xin + ((rr + 5) * SW + (ii + 5)) * XP + ch));
      const float x50 = a.x + c0 + c.bias[4 * GROW + ch];
      const float x51 = a.y + c1 + c.bias[4 * GROW + ch + 1];
      *reinterpret_cast<__nv_bfloat162*>(
          c.y + ((size_t)(c.n * c.H + gy) * c.W + gx) * NFEAT + ch) =
          __floats2bfloat162_rn(xv.x + 0.2f * x50, xv.y + 0.2f * x51);
    }
  } else if (S == 0) {
    *slot = __floats2bfloat162_rn(c0, c1);
  } else {
    const float2 a = __bfloat1622float2(*slot);
    *slot = __floats2bfloat162_rn(a.x + c0, a.y + c1);
  }
}

// Conv S: src holds x_S on the stage-(S-1) region ((18 - 2S) rows x 18
// cols, pixel pitch SP); (16 - 2S) output rows of 16 pixels, Cout in NT
// tiles of N, slabs G0.. of the ring.
template <int S>
__device__ __forceinline__ void rdb_stage(const Params& p, const Ctx& c,
                                          const bf16* src, bf16* xdst) {
  using St = Stage<S>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  // This warp is done with slab g (its MMAs retired): one arrival a warp.
  auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) nesr::mbar_arrive(c.empty + 8 * (g % RING));
  };
  if (wg >= St::MT) {
    // No M tile for this warpgroup: pass the stage's slabs through.
    for (int g = St::G0; g < St::G0 + 9 * St::NT; ++g) {
      nesr::mbar_wait(c.full + 8 * (g % RING), (g / RING) & 1);
      release(g);
    }
  } else {
    const int r = 4 * wg + warp % 4;        // this warp's stage row
    const int ra = min(r, St::ROWS - 1);    // a dead row reads a real one
    // This lane's ldmatrix row: pixel (ra, lane % 16), channel 8 (lane /
    // 16), at tap (0, 0).
    const uint32_t a_s = nesr::smem_u32(src) +
        ((ra * SW + lane % 16) * St::SP + lane / 16 * 8) * 2;
    float acc[St::N / 2];
    // A fragments, double-buffered by tap parity: the MMAs of tap t-1 may
    // still read one set while tap t's ldmatrix fills the other.
    uint32_t a[2][St::KS][4];
    const int fr = lane / 4, q = lane % 4;   // accumulator row, column pair
    // N tiles unrolled: each accumulator pair's channel, and so its slot,
    // is a constant but for the column pair q.
#pragma unroll
    for (int nt = 0; nt < St::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < St::N / 2; ++e) acc[e] = 0.f;
      const int g0 = St::G0 + 9 * nt;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int g = g0 + t, s = g % RING;
        K2_PHASE(S, 1);
        nesr::mbar_wait(c.full + 8 * s, (g / RING) & 1);
        K2_PHASE(S, 0);
        __syncwarp();
        // A: this warp's 16 pixels (its stage row, shifted by the tap) x
        // 16 channels a k-step; B: the slab's k-steps by descriptor
        // (K-major, no swizzle, core matrices 128 bytes apart along K,
        // 256 along N).
        const int tap_off = ((t / 3) * SW + t % 3) * St::SP * 2;
        const uint32_t bs = c.ring + s * SLOT_BYTES;
#pragma unroll
        for (int kk = 0; kk < St::KS; ++kk)
          nesr::ldsm_x4_at(a[t & 1][kk], a_s + tap_off + kk * 32);
        nesr::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < St::KS; ++kk)
          nesr::wgmma_rs<St::N>(acc, a[t & 1][kk],
                                nesr::wgmma_desc(bs + kk * 32 * St::N, 128,
                                                 256));
        nesr::wgmma_commit();
        // Tap t-1's MMAs have retired once at most this tap's group is in
        // flight: its slot goes back to the ring.
        if (t > 0) {
          nesr::wgmma_wait<1>();
          release(g - 1);
        }
        // Refill the slot of slab g-2, which every warp released one slab
        // ago; the sequence runs on into the next stages.
        if (tid == 0 && g >= 2 && g - 2 + RING < NSLAB) {
          K2_PHASE(S, 1);
          nesr::mbar_wait(c.empty + 8 * ((g - 2) % RING),
                          ((g - 2) / RING) & 1);
          K2_PHASE(S, 3);
          issue_slab(p, c, g - 2 + RING);
        }
        __syncwarp();
      }
      nesr::wgmma_wait<0>();
      release(g0 + 8);
      K2_PHASE(S, 1);
#pragma unroll
      for (int e = 0; e < St::N / 2; ++e) nesr::reg_fence(acc[e]);
      // Epilogue: pixel fr or fr+8 of row r, channels 2q and 2q+1 of each
      // n8 fragment; a dead row's results are dropped.
      if (r < St::ROWS) {
        const int co0 = nt * St::N;
#pragma unroll
        for (int j = 0; j < St::N / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            rdb_emit<S>(c, r, fr + 8 * h, co0 + 8 * j + 2 * q,
                        acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], xdst);
      }
      K2_PHASE(S, 2);
    }
  }
  __syncthreads();   // x_{S+1} and the slots complete
  K2_PHASE(S, 3);
}

__global__ void __launch_bounds__(THREADS, 1)
rdb_fused_kernel(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  K2_CLOCK_INIT;
  const int tid = threadIdx.x;
  Ctx c;
  c.smem = smem;
  c.xin = reinterpret_cast<bf16*>(smem + XIN_OFF);
  bf16* xb0 = reinterpret_cast<bf16*>(smem + XB_OFF);
  bf16* xb1 = reinterpret_cast<bf16*>(smem + XB_OFF + XB_BYTES);
  float* bias = reinterpret_cast<float*>(smem + BIAS_OFF);
  c.bias = bias;
  c.y = p.y;
  c.n = blockIdx.y;
  c.H = p.H;
  c.W = p.W;
  c.oy = (blockIdx.x / p.tiles_x) * T;
  c.ox = (blockIdx.x % p.tiles_x) * T;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  c.ring = nesr::smem_u32(smem);
  c.full = nesr::smem_u32(full);
  c.empty = c.full + 8 * RING;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      nesr::mbar_init(&full[s], 1);
      nesr::mbar_init(&full[RING + s], WARPS);
    }
    nesr::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < RING; ++g) issue_slab(p, c, g);

  // Input tile with a 5-px halo; zeros outside the image (SAME padding).
  for (int it = tid; it < SW * SW * (NFEAT / 8); it += THREADS) {
    const int v = it % (NFEAT / 8), q = it / (NFEAT / 8);
    const int gy = c.oy - 5 + q / SW, gx = c.ox - 5 + q % SW;
    const bool ok = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    const bf16* src =
        ok ? p.x + ((size_t)(c.n * p.H + gy) * p.W + gx) * NFEAT + v * 8
           : p.x;
    nesr::cp_async_zfill<16>(c.xin + q * XP + v * 8, src, ok ? 16 : 0);
  }
  // The x_k buffers' columns 16..17 are only ever read by discarded
  // columns; keep them finite.
  for (int it = tid; it < 2 * XB_BYTES / 16; it += THREADS)
    nesr::zero8(xb0 + it * 8);
  for (int i = tid; i < NBIAS; i += THREADS) bias[i] = p.bias[i];
  nesr::cp_async_wait_all();
  __syncthreads();
  K2_PHASE(5, 0);

  rdb_stage<0>(p, c, c.xin, xb0);
  rdb_stage<1>(p, c, xb0, xb1);
  rdb_stage<2>(p, c, xb1, xb0);
  rdb_stage<3>(p, c, xb0, xb1);
  rdb_stage<4>(p, c, xb1, nullptr);
  K2_CLOCK_STORE;
}

}  // namespace

// x (N, H, W, 64) bf16, 16-byte aligned; w0..w4 packed by
// pack_conv3x3_weights (16-byte aligned); bias (192,) fp32; y like x.
extern "C" int nesr_rdb_fused(const void* x, const void* w0, const void* w1,
                              const void* w2, const void* w3, const void* w4,
                              const void* bias, void* y, int N, int H, int W,
                              void* stream) {
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      rdb_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.x = (const bf16*)x;
  p.w0 = (const bf16*)w0;
  p.w1 = (const bf16*)w1;
  p.w2 = (const bf16*)w2;
  p.w3 = (const bf16*)w3;
  p.w4 = (const bf16*)w4;
  p.bias = (const float*)bias;
  p.y = (bf16*)y;
  p.H = H;
  p.W = W;
  p.tiles_x = (W + T - 1) / T;
  const int tiles_y = (H + T - 1) / T;
  dim3 grid(p.tiles_x * tiles_y, N);
  rdb_fused_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
