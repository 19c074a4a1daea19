// K3: flash attention, non-causal and unmasked: o = softmax(q k^T / sqrt(d)) v
// over (batch, head) pairs, bf16 in and out, fp32 scores and accumulators.
//
// Replaces the JAX package's Pallas flash attention,
//   kernels/attention.py:_flash_kernel        (whole KV in VMEM, pallas_call
//                                               :208)
//   kernels/attention.py:_flash_kernel_kvgrid (KV as a grid axis, :232)
// via flash_attention / _flash_attention_body (:125, :139). The math is
// theirs: bf16 operands, S = q k^T accumulated in fp32 and scaled by
// 1/sqrt(d) in fp32, online softmax with the running max m and sum l in
// fp32, P = exp(S - m) rounded to bf16 for P v with fp32 accumulation, l
// summed from the fp32 P, o = acc / l rounded to bf16. The two TPU
// lowerings exist for the VMEM budget; here every form streams KV. Keys at
// or past Skv are masked by a bounds check on the score (exact), not by
// the TPU code's extra -1e9 feature column, and K and V rows past Skv (and
// Q rows past Sq) are staged as zeros.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s; 16 exponentials
// a clock an SM): at the diffusion shapes (S 117..16384, d 8..512) a score
// costs 4 d tensor-core FLOPs and one exponential and is never written to
// device memory, so attention is bound by its operations. At d = 64 the
// exponentials alone take as long as the matrix products at the tensor
// cores' peak, so the softmax has to run under the MMAs. At d = 512 each
// 64-query block streams all of K and V through L2.
//
// Design, shared by both forms: a block owns 64 query rows of one (batch,
// head). Q, K and V tiles arrive by TMA (cp.async.bulk.tensor from 4-d
// tensor maps built per call, coordinates (column, row, head, batch)) in
// boxes of 64 columns swizzled over 128 bytes (32 / 64 bytes at d 16 /
// 32), the layout wgmma's descriptors read; the copy engine zero-fills
// rows past Sq or Skv and columns past d, and completes each tile on an
// mbarrier; a buffer is refilled once every warp's MMAs that read it have
// retired. S = Q K^T runs as wgmma with both operands from shared memory
// (Q and K K-major); P V reads V in its natural key-major layout as a
// transposed B (imm-trans-b). Tiles of 64 keys.
//
// Narrow form, d <= 128 (the UNet, 640 launches a request): one warpgroup
// a block and no producer warp, so four blocks share an SM at d <= 64 (two
// at d = 128). The warpgroup computes S into registers, issues S_{j+1}
// ahead of P V_j and runs the online softmax of tile j + 1 under P V_j,
// turning the S accumulator into P's A fragments in place (two register
// sets); P V reads P from registers (wgmma RS). Its thread 0 refills the
// K ring (three tiles) and the V ring (two) under each S.
//
// Wide form, d in (128, 512] (the VAE mid-block, d = 512): each score tile
// is computed once per KV tile. Q (64 x 512) stays in shared memory; one
// warpgroup computes S (m64n64, 32 k-steps) and the softmax, loads the
// next K tile as soon as its MMAs retire, and writes P (bf16, double-
// buffered, no swizzle) and each row's rescale factor alpha to shared
// memory; d/128 warpgroups each own 128 output columns (64 fp32
// accumulators a thread), load their own V slice, rescale by alpha and
// run P V. S_{j+1} overlaps P V_j. No producer warp, so the five
// warpgroups at d = 512 keep 96 registers a thread.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): the
// wide form reaches half of its operations bound at the VAE shape (1.11
// ms against 0.556), the narrow form 43% at the UNet's 64^2 (0.080 ms
// against 0.0347); there the softmax is about 45% of a step's critical
// path (tools/k3_ablation.py's phase trace).
//
// q, k, v and o are addressed through (batch, head, sequence) strides in
// elements with the head dim contiguous, so (B, S, H, d) views of packed
// (B, S, H*d) projections are read and written in place. The wrapper
// (kernels/attention.py) checks: bf16, d % 8 == 0, d <= 512, strides and
// base pointers 16-byte aligned.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <math_constants.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using nesr::bf16;

constexpr int BQ = 64;             // query rows a block
constexpr int SM_SMEM = 233472;    // shared memory of an H100 SM (228 KB)

struct Args {
  bf16* o;
  int H, Sq, Skv, D;
  long long osb, osh, oss;
  float scale;
  // 1 where a tensor map's coordinates are (column, row, head, batch), 0
  // where they are (column, head, row, batch): q, k, v
  int s_inner[3];
};

// A tile of ROWS x DP bf16 as TMA writes it: DP / CW boxes one after the
// other, each ROWS rows of 2 CW bytes with the 16-byte chunks of every
// 8-row atom swizzled over 2 CW bytes. CW is 64 columns (128 bytes, the
// widest swizzle) or DP where DP is narrower.
template <int DP>
__host__ __device__ constexpr int box_cols() { return DP < 64 ? DP : 64; }

// wgmma descriptor layout field for a swizzle span of 2 CW bytes.
template <int CW>
__host__ __device__ constexpr uint64_t swizzle_mode() {
  return CW == 64 ? 1ull : CW == 32 ? 2ull : 3ull;   // 128B, 64B, 32B
}

// Q or K as a K-major operand (rows = M or N, columns = K): k-step kk (16
// columns) starts in box 16kk / CW, 32 (kk mod CW / 16) bytes into the
// swizzle atom; 8-row groups are 16 CW bytes apart (SBO).
template <int DP, int ROWS>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  constexpr int CW = box_cols<DP>();
  const uint32_t addr =
      tile + (kk * 16 / CW) * ROWS * CW * 2 + (kk * 16 % CW) * 2;
  return nesr::wgmma_desc(addr, 16, 16 * CW) | (swizzle_mode<CW>() << 62);
}

// V as a transposed B (rows = keys = K, columns = N): k-step kk is 16 rows
// on; the boxes of CW columns are ROWS x 2 CW bytes apart along N (LBO),
// 8-row groups 16 CW bytes apart (SBO).
template <int DP, int ROWS>
__device__ __forceinline__ uint64_t trans_desc(uint32_t tile, int kk) {
  constexpr int CW = box_cols<DP>();
  return nesr::wgmma_desc(tile + kk * 32 * CW, ROWS * CW * 2, 16 * CW) |
         (swizzle_mode<CW>() << 62);
}

// P (wide form) as a K-major A written by the softmax warpgroup, no
// swizzle: core matrix (r / 8, c / 8) of 8 rows x 16 bytes at
// ((r / 8) COLS / 8 + c / 8) 128 bytes; a k-step is 256 bytes on, LBO 128
// (along K), SBO 16 COLS (along M).
template <int COLS>
__device__ __forceinline__ uint32_t p_off(int r, int c) {
  return ((r >> 3) * (COLS / 8) + (c >> 3)) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

template <int COLS>
__device__ __forceinline__ uint64_t p_desc(uint32_t tile, int kk) {
  return nesr::wgmma_desc(tile + kk * 256, 128, 16 * COLS);
}

// Boxes [box0, box0 + nbox) of rows [r0, r0 + ROWS) of (batch b, head h)
// into the tile at `tile` (TMA zero-fills rows past the sequence and
// columns past D); completes on `bar`, whose expected bytes the caller
// has announced.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t tile, const CUtensorMap* map,
                                          int s_inner, int r0, int b, int h,
                                          uint32_t bar, int box0, int nbox) {
  constexpr int CW = box_cols<DP>();
  const int x1 = s_inner ? r0 : h, x2 = s_inner ? h : r0;
  for (int i = box0; i < box0 + nbox; ++i)
    nesr::tma_load_4d(tile + i * ROWS * CW * 2, map, i * CW, x1, x2, b, bar);
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one score tile held as a wgmma accumulator: s[4j + e]
// is row g (e < 2) or g + 8 of this warp's 16, key 8j + 2t + (e & 1).
// Masks keys >= Skv, updates the running max m of the scaled scores and
// this thread's share of l, turns s into P = exp(s scale - m) and returns
// each row's rescale factor in alpha. The scale is positive, so the row
// max is taken on the raw sums and scaled once; exp(s scale - m) is
// 2^(s (scale log2 e) - m log2 e), one fused multiply-add and the ex2
// unit, as __expf computes it, without a separate scale and subtraction.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int kv0,
                                             int Skv, float scale, int t) {
  float tmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if (kv0 + BK > Skv) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kv0 + 8 * j + 2 * t + (e & 1) >= Skv) s[4 * j + e] = -CUDART_INF_F;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tmax[e >> 1] = fmaxf(tmax[e >> 1], s[4 * j + e]);
  const float c = scale * kLog2e;
  float rsum[2] = {0.f, 0.f}, mlog[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
    const float m_new = fmaxf(m[i], tmax[i] * scale);
    alpha[i] = __expf(m[i] - m_new);
    m[i] = m_new;
    mlog[i] = m_new * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -mlog[e >> 1]));
      rsum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// o[row, c0 + 8n + 2t, +1] = acc / l for this thread's rows g and g + 8 of
// its warp's 16 (row0 = the first of them); l is this thread's share.
template <int N>
__device__ __forceinline__ void store_rows(const Args& a, const float (&acc)[N / 2],
                                           float (&l)[2], int row0, int c0,
                                           int t) {
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  bf16* ob = a.o + b * a.osb + h * a.osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= a.Sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int col = c0 + n * 8 + 2 * t;
      if (col >= a.D) continue;   // D % 8 == 0: col + 1 < D as well
      *reinterpret_cast<__nv_bfloat162*>(ob + row * a.oss + col) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv,
                                acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Every warp of a group is done with a buffer: one arrival a warp.
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) nesr::mbar_arrive(bar);
}

// bar.sync on a named barrier (id > 0) that `n` threads share.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ---- Narrow form: d <= 128 ------------------------------------------------

// The softmax of a retired S tile, into P's A fragments for P V: the S
// accumulator of keys 16kk..16kk+15 is k-step kk's fragment, (g, 2t),
// (g + 8, 2t), (g, 8 + 2t), (g + 8, 8 + 2t).
template <int BK>
__device__ __forceinline__ void narrow_softmax(float (&sc)[BK / 2],
                                               uint32_t (&p)[BK / 16][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int kv0,
                                               const Args& a, int t) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) nesr::reg_fence(sc[e]);
  softmax_tile<BK>(sc, m, l, alpha, kv0, a.Skv, a.scale, t);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// One warpgroup (64 query rows) a block and no producer warp: its thread 0
// issues the TMA loads, each into the buffer the MMAs just released, so
// the registers a producer warp would hold go to a fourth block an SM at
// d <= 64 (two at d = 128). K has a ring of three tiles and V of two,
// which fits four blocks' shared memory.
template <int DP>
struct Narrow {
  static constexpr int BK = 64;   // keys a tile
  static constexpr int THREADS = 128;
  static constexpr int BLOCKS = DP <= 64 ? 4 : 2;
  static constexpr int KST = 3, VST = 2;   // K and V ring depths
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int T_BYTES = BK * DP * 2;   // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + KST * T_BYTES;
  // barriers: Q, K full per K slot, V full per V slot
  static constexpr int BAR_OFF = V_OFF + VST * T_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + KST + VST);
  static_assert(BLOCKS * (BYTES + 1024) <= SM_SMEM, "K3: narrow buffers");
};

template <int DP>
__global__ void __launch_bounds__(Narrow<DP>::THREADS, Narrow<DP>::BLOCKS)
flash_narrow(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Narrow<DP>;
  constexpr int BK = L::BK, KST = L::KST, VST = L::VST;
  constexpr int NBOX = DP / box_cols<DP>();
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = nesr::smem_u32(smem);
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t q_bar = base + L::BAR_OFF;
  const uint32_t kfull = q_bar + 8, vfull = kfull + 8 * KST;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int nkv = (a.Skv + BK - 1) / BK;

  // K_j and V_j go to slots j mod KST and j mod VST.
  auto load_k = [&](int j) {
    const uint32_t bar = kfull + 8 * (j % KST);
    nesr::mbar_expect_tx(bar, L::T_BYTES);
    load_tile<DP, BK>(k_s + j % KST * L::T_BYTES, &tk, a.s_inner[1], j * BK,
                      b, h, bar, 0, NBOX);
  };
  auto load_v = [&](int j) {
    const uint32_t bar = vfull + 8 * (j % VST);
    nesr::mbar_expect_tx(bar, L::T_BYTES);
    load_tile<DP, BK>(v_s + j % VST * L::T_BYTES, &tv, a.s_inner[2], j * BK,
                      b, h, bar, 0, NBOX);
  };
  if (tid == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
    for (int i = 0; i < 1 + KST + VST; ++i) nesr::mbar_init(&bars[i], 1);
    nesr::mbar_init_fence();
    nesr::mbar_expect_tx(q_bar, L::Q_BYTES);
    load_tile<DP, BQ>(q_s, &tq, a.s_inner[0], q0, b, h, q_bar, 0, NBOX);
    for (int j = 0; j < KST && j < nkv; ++j) load_k(j);
    for (int j = 0; j < VST && j < nkv; ++j) load_v(j);
  }
  __syncthreads();

  // S_{j+1} is issued before P V_j, and the softmax of tile j + 1 runs
  // while P V_j is on the tensor cores; P alternates between two register
  // sets. Once the MMAs reading a K or V slot have retired in every warp
  // (named barrier 1, once a step, while S runs), thread 0 refills it.
  auto issue_s = [&](float (&sc)[BK / 2], int j) {
    nesr::mbar_wait(kfull + 8 * (j % KST), (j / KST) & 1);
    nesr::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      nesr::wgmma_ss<BK>(sc, kmajor_desc<DP, BQ>(q_s, kk),
                         kmajor_desc<DP, BK>(k_s + j % KST * L::T_BYTES, kk),
                         kk > 0);
    nesr::wgmma_commit();
  };
  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[BK / 2];
  uint32_t p0[BK / 16][4], p1[BK / 16][4];
  nesr::mbar_wait(q_bar, 0);
  issue_s(sc, 0);
  nesr::wgmma_wait<0>();
  narrow_softmax<BK>(sc, p0, m, l, alpha, 0, a, t);
  // One KV tile: P_j (in pc) V_j, with S_{j+1} issued ahead of it and its
  // softmax into pn behind it.
  auto step = [&](int j, uint32_t (&pc)[BK / 16][4],
                  uint32_t (&pn)[BK / 16][4]) {
    // The last tile issues its own S again (its K slot is not refilled),
    // so no wgmma sits under a branch.
    const bool more = j + 1 < nkv;
    issue_s(sc, more ? j + 1 : j);
    // Under S_{j+1}: K_j's and V_{j-1}'s slots are free (their MMAs
    // retired before this step).
    const bool refill_k = j + KST < nkv;
    const bool refill_v = j > 0 && j - 1 + VST < nkv;
    if (refill_k || refill_v) {
      group_sync(1, 128);
      if (tid == 0) {
        if (refill_k) load_k(j + KST);
        if (refill_v) load_v(j - 1 + VST);
      }
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
    nesr::mbar_wait(vfull + 8 * (j % VST), (j / VST) & 1);
    nesr::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      nesr::wgmma_rs_tb<DP>(
          acc, pc[kk], trans_desc<DP, BK>(v_s + j % VST * L::T_BYTES, kk));
    nesr::wgmma_commit();
    nesr::wgmma_wait<1>();   // S_{j+1} has retired; P V_j may still run
    if (more) narrow_softmax<BK>(sc, pn, m, l, alpha, (j + 1) * BK, a, t);
    nesr::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) nesr::reg_fence(acc[e]);
  };
  for (int j = 0; j < nkv; j += 2) {
    step(j, p0, p1);
    if (j + 1 < nkv) step(j + 1, p1, p0);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_rows<DP>(a, acc, l, q0 + 16 * warp + g, 0, t);
}

// ---- Wide form: 128 < d <= 512 --------------------------------------------

template <int DP>
struct Wide {
  static constexpr int BK = 64;
  static constexpr int NPV = DP / 128;   // P V warpgroups, 128 columns each
  static constexpr int THREADS = 128 * (1 + NPV);
  static constexpr int T_BYTES = BQ * DP * 2;   // Q, a K tile, a V tile
  static constexpr int P_BYTES = BQ * BK * 2;
  static constexpr int K_OFF = T_BYTES, V_OFF = 2 * T_BYTES;
  static constexpr int P_OFF = 3 * T_BYTES;               // two P buffers
  static constexpr int A_OFF = P_OFF + 2 * P_BYTES;       // two alpha rows
  static constexpr int L_OFF = A_OFF + 2 * BQ * 4;        // l per row
  // barriers: K full, P full x2, P empty x2, l, V full per slice
  static constexpr int BAR_OFF = L_OFF + BQ * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (6 + NPV);
  static_assert(BYTES + 1024 <= SM_SMEM, "K3: the wide form's buffers");
};

// No producer warp: the S warpgroup loads Q and each K tile, and each P V
// warpgroup its own 128 columns of each V tile, right after the MMAs that
// read the buffer before have retired; at d = 512 the five warpgroups keep
// 96 registers a thread, enough for P V's 64 accumulators.
template <int DP>
__global__ void __launch_bounds__(Wide<DP>::THREADS, 1)
flash_wide(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Wide<DP>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = nesr::smem_u32(smem);
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t p_s = base + L::P_OFF;
  float* alpha_s = reinterpret_cast<float*>(smem + L::A_OFF);
  float* l_s = reinterpret_cast<float*>(smem + L::L_OFF);
  const uint32_t kfull = base + L::BAR_OFF, pfull = kfull + 8,
                 pempty = kfull + 24, l_bar = kfull + 40, vfull = kfull + 48;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, i = tid % 128;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int nkv = (a.Skv + BK - 1) / BK;

  if (tid == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
    const int counts[6] = {1, 4, 4, 4 * L::NPV, 4 * L::NPV, 4};
    for (int n = 0; n < 6; ++n) nesr::mbar_init(&bars[n], counts[n]);
    for (int c = 0; c < L::NPV; ++c) nesr::mbar_init(&bars[6 + c], 1);
    nesr::mbar_init_fence();
  }
  __syncthreads();

  const int g = lane / 4, t = lane % 4, wrow = 16 * (warp % 4);
  if (wg == 0) {   // S = Q K^T and the online softmax
    if (i == 0) {
      nesr::mbar_expect_tx(kfull, 2 * L::T_BYTES);
      load_tile<DP, BQ>(q_s, &tq, a.s_inner[0], q0, b, h, kfull, 0, DP / 64);
      load_tile<DP, BK>(k_s, &tk, a.s_inner[1], 0, b, h, kfull, 0, DP / 64);
    }
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    for (int j = 0; j < nkv; ++j) {
      nesr::mbar_wait(kfull, j & 1);
      float sc[BK / 2];
      nesr::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        nesr::wgmma_ss<BK>(sc, kmajor_desc<DP, BQ>(q_s, kk),
                           kmajor_desc<DP, BK>(k_s, kk), kk > 0);
      nesr::wgmma_commit();
      nesr::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) nesr::reg_fence(sc[e]);
      group_sync(1, 128);   // every warp's MMAs are done with K_j
      if (i == 0 && j + 1 < nkv) {
        nesr::mbar_expect_tx(kfull, L::T_BYTES);
        load_tile<DP, BK>(k_s, &tk, a.s_inner[1], (j + 1) * BK, b, h, kfull,
                          0, DP / 64);
      }

      float alpha[2];
      softmax_tile<BK>(sc, m, l, alpha, j * BK, a.Skv, a.scale, t);
      const int pb = j & 1;
      if (j >= 2) nesr::mbar_wait(pempty + 8 * pb, ((j >> 1) - 1) & 1);
      unsigned char* pt = smem + L::P_OFF + pb * L::P_BYTES;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(
              pt + p_off<BK>(wrow + g + 8 * r, 8 * n + 2 * t)) =
              pack_bf16(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]);
      }
      if (t == 0) {
        alpha_s[pb * BQ + wrow + g] = alpha[0];
        alpha_s[pb * BQ + wrow + g + 8] = alpha[1];
      }
      nesr::fence_proxy_async();
      warp_arrive(pfull + 8 * pb);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    if (t == 0) {
      l_s[wrow + g] = l[0];
      l_s[wrow + g + 8] = l[1];
    }
    warp_arrive(l_bar);
    return;
  }

  // P V on columns [c0, c0 + 128)
  const int c = wg - 1, c0 = 128 * c;
  const uint32_t my_vfull = vfull + 8 * c;
  // this slice's V: boxes 2c and 2c + 1 of each tile
  if (i == 0) {
    nesr::mbar_expect_tx(my_vfull, L::T_BYTES / L::NPV);
    load_tile<DP, BK>(v_s, &tv, a.s_inner[2], 0, b, h, my_vfull, 2 * c, 2);
  }
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  for (int j = 0; j < nkv; ++j) {
    const int pb = j & 1;
    nesr::mbar_wait(pfull + 8 * pb, (j >> 1) & 1);
    const float a0 = alpha_s[pb * BQ + wrow + g];
    const float a1 = alpha_s[pb * BQ + wrow + g + 8];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[4 * n] *= a0;
      acc[4 * n + 1] *= a0;
      acc[4 * n + 2] *= a1;
      acc[4 * n + 3] *= a1;
    }
    nesr::mbar_wait(my_vfull, j & 1);
    nesr::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      nesr::wgmma_ss_tb<128>(acc, p_desc<BK>(p_s + pb * L::P_BYTES, kk),
                             trans_desc<DP, BK>(v_s + 2 * c * BK * 128, kk));
    nesr::wgmma_commit();
    nesr::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) nesr::reg_fence(acc[e]);
    group_sync(2 + c, 128);   // every warp's MMAs are done with P_j, V_j
    warp_arrive(pempty + 8 * pb);
    if (i == 0 && j + 1 < nkv) {
      nesr::mbar_expect_tx(my_vfull, L::T_BYTES / L::NPV);
      load_tile<DP, BK>(v_s, &tv, a.s_inner[2], (j + 1) * BK, b, h, my_vfull,
                        2 * c, 2);
    }
  }
  nesr::mbar_wait(l_bar, 0);
  float l[2] = {l_s[wrow + g], l_s[wrow + g + 8]};
  store_rows<128>(a, acc, l, q0 + wrow + g, c0, t);
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so the library links against the CUDA runtime alone.
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// One operand: its base, sequence length and element strides.
struct Operand {
  const void* ptr;
  int S;
  long long sb, sh, ss;
};

// A 4-d tensor map over (D, S, H, B) of one operand with the sequence and
// head dims ordered inner to outer by stride (packed (B, S, H, d) views
// step heads faster than rows); boxes of cw columns x rows rows, swizzled
// over 2 cw bytes, zero fill past every edge. A dim of one element is
// never stepped and gets a stride the encoder takes.
int make_map(CUtensorMap* map, const Operand& t, int D, int H, int B, int cw,
             int rows, int* s_inner) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t ss = t.ss * 2, sh = t.sh * 2, sb = t.sb * 2;   // bytes
  if (t.S == 1) ss = (cuuint64_t)D * 2;
  if (H == 1) sh = ss * t.S;
  if (B == 1) sb = ss * t.S > sh * H ? ss * t.S : sh * H;
  const bool inner = ss <= sh;
  *s_inner = inner;
  const cuuint64_t S = t.S, Hd = H;
  const cuuint64_t dims[4] = {(cuuint64_t)D, inner ? S : Hd, inner ? Hd : S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {inner ? ss : sh, inner ? sh : ss, sb};
  const cuuint32_t box[4] = {(cuuint32_t)cw, inner ? (cuuint32_t)rows : 1u,
                             inner ? 1u : (cuuint32_t)rows, 1u};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t.ptr),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Maps of q (boxes of q_rows rows) and of k and v (kv_rows rows).
template <int DP>
int make_maps(CUtensorMap (&maps)[3], const Operand (&ops)[3], Args& a,
              int B, int q_rows, int kv_rows) {
  for (int i = 0; i < 3; ++i) {
    const int err = make_map(&maps[i], ops[i], a.D, a.H, B, box_cols<DP>(),
                             i == 0 ? q_rows : kv_rows, &a.s_inner[i]);
    if (err) return err;
  }
  return 0;
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, int rows,
           const CUtensorMap (&maps)[3], const Args& a, int B,
           cudaStream_t stream) {
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + rows - 1) / rows, B * a.H);
  kernel<<<grid, threads, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_narrow(const Operand (&ops)[3], Args a, int B, cudaStream_t s) {
  using L = Narrow<DP>;
  CUtensorMap maps[3];
  if (const int e = make_maps<DP>(maps, ops, a, B, BQ, L::BK)) return e;
  return launch(flash_narrow<DP>, L::THREADS, L::BYTES, BQ, maps, a, B, s);
}

template <int DP>
int launch_wide(const Operand (&ops)[3], Args a, int B, cudaStream_t s) {
  CUtensorMap maps[3];
  if (const int e = make_maps<DP>(maps, ops, a, B, BQ, Wide<DP>::BK)) return e;
  return launch(flash_wide<DP>, Wide<DP>::THREADS, Wide<DP>::BYTES, BQ, maps,
                a, B, s);
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) for q, k, v, o.
extern "C" int nesr_flash_attn(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Sq, int Skv, int D,
                               const long long* st, float scale,
                               void* stream) {
  const Operand ops[3] = {{q, Sq, st[0], st[1], st[2]},
                          {k, Skv, st[3], st[4], st[5]},
                          {v, Skv, st[6], st[7], st[8]}};
  Args a{};
  a.o = (bf16*)o;
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.osb = st[9];
  a.osh = st[10];
  a.oss = st[11];
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 16) return launch_narrow<16>(ops, a, B, s);
  if (D <= 32) return launch_narrow<32>(ops, a, B, s);
  if (D <= 64) return launch_narrow<64>(ops, a, B, s);
  if (D <= 128) return launch_narrow<128>(ops, a, B, s);
  if (D <= 256) return launch_wide<256>(ops, a, B, s);
  if (D <= 512) return launch_wide<512>(ops, a, B, s);
  return (int)cudaErrorInvalidValue;
}
