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
// fp32, P = exp(S - m) rounded to bf16 for P v with fp32 accumulation,
// o = acc / l rounded to bf16. The two TPU lowerings exist for the VMEM
// budget; here one kernel always streams KV. Keys at or past Skv are masked
// by a bounds check on the score (exact), not by the TPU code's extra
// -1e9 feature column, and K and V rows past Skv are staged as zeros.
//
// What bounds it on an H100: at the diffusion shapes (S 117..16384, d 8..512)
// attention does 4 d FLOPs per score against one score never written to
// device memory, so a flash kernel is tensor-core bound; with mma.sync and
// unpipelined staging the limits are issue rate and the shared-memory
// operand fetches. Design (FA2): a block owns 64 query rows of one
// (batch, head), 4 warps of 16 rows each; it walks KV in tiles of 64 keys
// staged in shared memory with rows padded by 16 bytes (every ldmatrix
// phase bank-conflict free); each warp computes its 16 x 64 score tile with
// mma.sync m16n8k16, keeps it in registers, rescales and reuses it as the A
// operand of P v (the accumulator layout of S is the A layout of P). The
// head dim is padded to a power of two DP in [16, 512] with zero columns.
//
// The output accumulator of a warp is 16 x DV fp32 in registers. For
// d = 512 (the VAE mid-block: one head over the whole latent grid) a 16 x
// 512 accumulator would be 256 registers a thread, more than a thread has.
// So the output columns are split across blocks in slices of DV = 128
// (blockIdx.z): each slice's block recomputes the full 512-wide S = q k^T
// and multiplies P only by its 128 columns of V. At d = 512 that is 4x the
// QK^T FLOPs, 2.5x the attention's FLOPs in all, for registers that fit
// (about 64 accumulator registers a thread at DV = 128) and no shared-memory
// exchange between warps. d <= 128 runs as one slice.
//
// q, k, v and o are addressed through (batch, head, sequence) strides in
// elements with the head dim contiguous, so (B, S, H, d) views of packed
// (B, S, H*d) projections are read and written in place. The wrapper
// (kernels/attention.py) checks: bf16, d % 8 == 0, d <= 512, strides and
// base pointers 16-byte aligned.
// Not yet: cp.async/TMA double buffering of the K/V tiles, wgmma.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;              // query rows per block, 16 per warp
constexpr int BK = 64;              // keys per KV tile
constexpr int NWARP = BQ / 16;
constexpr int THREADS = NWARP * 32;

using nesr::bf16;

template <int DP, int DV>
constexpr int smem_bytes() {
  return (BQ * (DP + 8) + BK * (DP + 8) + BK * (DV + 8)) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage `rows` x `cols` (cols a multiple of 8) bf16 from rows r0.. of a
// strided source into shared memory (pitch `pitch`); row r >= nrows or
// column c >= ncols is written as zero.
__device__ __forceinline__ void stage(bf16* dst, int pitch, const bf16* src,
                                      long long row_stride, int r0, int nrows,
                                      int c0, int ncols, int rows, int cols) {
  const int chunks = cols / 8;
  for (int it = threadIdx.x; it < rows * chunks; it += THREADS) {
    const int r = it / chunks;
    const int c = (it % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < nrows && c0 + c < ncols)
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(r0 + r) * row_stride + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

template <int DP, int DV>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                  int Sq, int Skv, int D, long long qsb, long long qsh,
                  long long qss, long long ksb, long long ksh, long long kss,
                  long long vsb, long long vsh, long long vss, long long osb,
                  long long osh, long long oss, float scale) {
  constexpr int QP = DP + 8, KP = DP + 8, VP = DV + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * QP;
  bf16* vs = ks + BK * KP;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int dv0 = blockIdx.z * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  stage(qs, QP, qb, qss, q0, Sq, 0, D, BQ, DP);

  // Row g of the warp's 16 is index 0, row g + 8 index 1.
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};  // this thread's share; quad-summed at the end
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nkv = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < nkv; ++kt) {
    const int kv0 = kt * BK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    stage(ks, KP, kb, kss, kv0, Skv, 0, D, BK, DP);
    stage(vs, VP, vb, vss, kv0, Skv, dv0, D, BK, DV);
    __syncthreads();

    // S = q k^T for the warp's 16 rows x 64 keys; s[j] holds keys 8j..8j+7.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      nesr::ldsm_x4<false>(a, qs + warp * 16 * QP + kk * 16, QP);
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t bk[4];  // keys nb*16 + 0..7: (bk[0], bk[2]); + 8..15: (1, 3)
        nesr::ldsm_x4<false>(bk, ks + nb * 16 * KP + kk * 16, KP);
        nesr::mma_bf16(s[2 * nb], a, bk[0], bk[2]);
        nesr::mma_bf16(s[2 * nb + 1], a, bk[1], bk[3]);
      }
    }

    // Scale in fp32, mask keys past Skv, online softmax.
    float tmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < Skv ? s[j][e] * scale : -CUDART_INF_F;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_run[i], tmax[i]);
      alpha[i] = __expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_run[e >> 1]);
        rsum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rsum[i];
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P v over the tile's 64 keys, P rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nb = 0; nb < DV / 16; ++nb) {
        uint32_t bv[4];
        nesr::ldsm_x4<true>(bv, vs + kk * 16 * VP + nb * 16, VP);
        nesr::mma_bf16(acc[2 * nb], a, bv[0], bv[1]);
        nesr::mma_bf16(acc[2 * nb + 1], a, bv[2], bv[3]);
      }
    }
  }

  // o = acc / l: row g (and g + 8), columns 2t, 2t + 1 of each n8 fragment.
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = dv0 + n * 8 + 2 * t;
      if (col >= D) continue;  // D % 8 == 0: col + 1 < D as well
      *reinterpret_cast<__nv_bfloat162*>(ob + row * oss + col) =
          __floats2bfloat162_rn(acc[n][2 * i] / l, acc[n][2 * i + 1] / l);
    }
  }
}

template <int DP, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Sq, int Skv, int D, const long long* st, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP, DV>();
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<DP, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H, (D + DV - 1) / DV);
  flash_attn_kernel<DP, DV><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) for q, k, v, o.
extern "C" int nesr_flash_attn(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Sq, int Skv, int D,
                               const long long* strides, float scale,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 16) return launch<16, 16>(q, k, v, o, B, H, Sq, Skv, D, strides,
                                     scale, s);
  if (D <= 32) return launch<32, 32>(q, k, v, o, B, H, Sq, Skv, D, strides,
                                     scale, s);
  if (D <= 64) return launch<64, 64>(q, k, v, o, B, H, Sq, Skv, D, strides,
                                     scale, s);
  if (D <= 128) return launch<128, 128>(q, k, v, o, B, H, Sq, Skv, D, strides,
                                        scale, s);
  if (D <= 256) return launch<256, 128>(q, k, v, o, B, H, Sq, Skv, D, strides,
                                        scale, s);
  if (D <= 512) return launch<512, 128>(q, k, v, o, B, H, Sq, Skv, D, strides,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}
