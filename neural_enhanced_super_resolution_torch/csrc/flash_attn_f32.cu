// K3f: K3's float32 form. Non-causal, unmasked attention
// softmax(q k^T * scale) v over strided (batch, head, sequence, head dim)
// float32 views, all in float32 on the CUDA cores, with the online softmax
// of a flash kernel: the (Sq, Skv) scores never reach device memory.
// ``precision: "float32"`` (the JAX package's parity mode) runs it wherever
// bf16 runs K3.
//
// Replaces the JAX package's Pallas kernels/attention.py:125 flash_attention
// on float32 operands (its parity mode casts q, k, v to float32 and runs
// the same kernel; K3 takes its bf16 form).
//
// What bounds it on an H100: its operations, 4 x Sq x Skv x d against 67
// TFLOP/s of float32 outside the tensor cores (128 FMA lanes an SM). To
// get near that rate an SM must issue an FFMA nearly every clock on each of
// its four schedulers, read under 1 byte of shared memory per FMA (it
// serves 128 bytes a clock), and have enough blocks to keep all 132 SMs
// busy on short sequences. The design:
//  * Register tiles in both products. A thread holds a 4 (rows) x KPT
//    (keys) block of scores, KPT 4 up to d 128 and 8 at d 256 and 512,
//    reading per 4-wide step of d one float4 of each of its rows and keys:
//    8 (KPT 4) or 6 (KPT 8) LDS.128 for 64 FFMA. It accumulates 4 rows x TN
//    output columns (TN = 16 from d 128 up: 64 accumulators), reading per
//    key one float4 of P (stored key-major, so its 4 rows are adjacent) and
//    TN / 4 float4 of V. A warp is 4 row groups x 8 column groups, so each
//    load is one shared-memory wavefront shared by 4 or 8 lanes: about 0.4
//    bytes of shared memory per FMA in S and 0.3 in P V. Rows are padded by
//    4 floats so the float4 lanes of a wavefront hit distinct banks.
//  * The softmax runs on the score registers: the row max over a warp's 8
//    key lanes by shuffles and, where a row's keys span several warps (d
//    256, 512), over them through shared memory at one barrier a tile. The
//    row sum stays a per-thread partial, reduced once at the end. P and
//    the rescale factor pass to the P V layout through shared memory.
//  * Asynchronous staging: K and V pass through a ring of shared-memory
//    stages filled by cp.async (16 bytes, zero-filled past Skv and past d),
//    one stage ahead of the FMAs, with one wait and one barrier a stage.
//    Up to d 128 a stage holds a whole 32-key tile of K and of V, so a
//    tile costs one barrier; at d 256 and 512 the 128- and 256-key tile is
//    walked in stages of 33-37 KB (K in d-chunks, V in key chunks), with a
//    third stage, so that q (whole, in shared memory), three stages and P
//    fit the 227 KB. Those two run one 8-warp block an SM (248 registers);
//    what holds them back (tools/f32_ablation.py, PERF.md): the S product's
//    shared-memory loads and the staging (~17% of the time).
//  * Split keys. A block owns BQ query rows of one (batch, head) and,
//    when the query blocks alone are fewer than the SMs, one of `nsplit`
//    key ranges of whole tiles, about two waves' worth
//    (kernels/attention.py:flash_f32_splits picks it).
//    Each split writes its unnormalised output and its row max m (base 2)
//    and sum l to scratch; attn_f32_merge combines them with the online
//    softmax's own step.
// The head dim is zero-padded to the instantiation's DP (32 ... 512), which
// changes no dot product; keys past Skv score -inf.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// One instantiation: padded head dim DP, NT threads, BQ query rows a block,
// KPT keys a thread in S; DC_ and KV_ (d 256 and 512) are the head dims of
// a K stage and the keys of a V stage.
template <int DP_, int NT_, int BQ_, int KPT_, int DC_, int KV_>
struct Cfg {
  static constexpr int DP = DP_, NT = NT_, BQ = BQ_, KPT = KPT_;
  static constexpr int RG = BQ / 4;      // row groups, 4 rows a thread
  static constexpr int CG = NT / RG;     // column (key) groups
  static constexpr int BK = KPT * CG;    // keys a tile
  static constexpr int LC = 8, LR = 4;   // a warp: 4 row x 8 column groups
  static constexpr int WC = CG / LC, WR = RG / LR;
  static constexpr bool NARROW = WC == 1;   // a warp holds whole rows
  static constexpr int DC = NARROW ? DP : DC_;
  static constexpr int KV = NARROW ? BK : KV_;
  static constexpr int NJ = DP / CG / 4;    // float4 output columns a thread
  static constexpr int LDQ = DP + 4, LDK = DC + 4, LDV = DP + 4;
  static constexpr int LDP = BQ + LR;
  static constexpr int NKC = DP / DC, NVC = BK / KV;
  static constexpr int CPT = NARROW ? 1 : NKC + NVC;   // stages a tile
  static constexpr int STAGE =
      NARROW ? BK * (LDK + LDV) : (BK * LDK > KV * LDV ? BK * LDK : KV * LDV);
  static constexpr int STAGES = NARROW ? 2 : 3;
  static constexpr int FLOATS =
      BQ * LDQ + STAGES * STAGE + BK * LDP + WC * BQ + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(WR * WC * 32 == NT && RG % LR == 0 && CG % LC == 0, "warps");
  static_assert(DP % DC == 0 && BK % KV == 0 && NJ >= 1, "chunks");
  static_assert(BYTES <= 232448, "shared memory");
};

template <int DP> struct Pick;
template <> struct Pick<32> { using T = Cfg<32, 128, 64, 4, 0, 0>; };
template <> struct Pick<64> { using T = Cfg<64, 128, 64, 4, 0, 0>; };
template <> struct Pick<128> { using T = Cfg<128, 128, 64, 4, 0, 0>; };
template <> struct Pick<256> { using T = Cfg<256, 256, 64, 8, 64, 32>; };
template <> struct Pick<512> { using T = Cfg<512, 256, 32, 8, 32, 16>; };

struct Operand {
  const float* ptr;
  long long sb, sh, ss;   // element strides: batch, head, sequence
};

struct Args {
  Operand q, k, v;
  float* o;               // the output (one split) or nullptr
  long long osb, osh, oss;
  float* part;            // (nsplit, B*H, Sq, D) unnormalised outputs
  float2* ml;             // (nsplit, B*H, Sq): row max (base 2), row sum
  int H, Sq, Skv, D, kps; // kps: keys a split (a multiple of BK)
  float scale;            // 1 / sqrt(d) x log2(e)
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of one (batch, head) of t
// into dst (row stride LD) by cp.async, zero past `rend` and past D. A
// thread copies the same 16-byte column of every NT / (COLS / 4)-th row.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* base,
                                           long long ss, int r0, int rend,
                                           int c0, int D) {
  constexpr int C4 = COLS / 4, STEP = NT / C4, N = ROWS / STEP;
  static_assert(NT % C4 == 0 && ROWS % STEP == 0, "whole rows a pass");
  const int r = r0 + threadIdx.x / C4, c = (threadIdx.x % C4) * 4;
  const bool col_ok = c0 + c < D;
  const float* src = base + (long long)r * ss + c0 + c;
  dst += (threadIdx.x / C4) * LD + c;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool ok = col_ok && r + j * STEP < rend;
    nesr::cp_async_zfill<16>(dst + j * STEP * LD,
                             ok ? src + j * STEP * ss : base, ok ? 16 : 0);
  }
}

template <class C>
__global__ void __launch_bounds__(C::NT) attn_f32_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);     // BQ x LDQ
  float* ring = sq + C::BQ * C::LDQ;               // STAGES x STAGE
  float* sp = ring + C::STAGES * C::STAGE;         // P: BK x LDP, key-major
  float* red = sp + C::BK * C::LDP;                // WC x BQ row maxima
  float* salpha = red + C::WC * C::BQ;             // BQ rescale factors
  float* sl = salpha + C::BQ;                      // BQ row sums

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * C::BQ, split = blockIdx.z;
  const int kbeg = split * a.kps;
  const int kend = min(a.Skv, kbeg + a.kps);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = lane >> 3, lc = lane & 7;
  const int wr = warp / C::WC, wc = warp % C::WC;
  const int rg = wr * C::LR + lr, cg = wc * C::LC + lc;
  const int srow0 = wr * 4 * C::LR + lr;   // S rows srow0 + LR i

  const float* qb = a.q.ptr + b * a.q.sb + h * a.q.sh;
  const float* kb = a.k.ptr + b * a.k.sb + h * a.k.sh;
  const float* vb = a.v.ptr + b * a.v.sb + h * a.v.sh;
  const int nchunks = (kend - kbeg + C::BK - 1) / C::BK * C::CPT;

  // Fills ring stage g % STAGES with chunk g of this block's key range.
  auto issue = [&](int g) {
    float* st = ring + (g % C::STAGES) * C::STAGE;
    const int k0 = kbeg + (g / C::CPT) * C::BK, c = g % C::CPT;
    if constexpr (C::NARROW) {
      stage_rows<C::BK, C::DP, C::LDK, C::NT>(st, kb, a.k.ss, k0, kend, 0,
                                              a.D);
      stage_rows<C::BK, C::DP, C::LDV, C::NT>(st + C::BK * C::LDK, vb,
                                              a.v.ss, k0, kend, 0, a.D);
    } else if (c < C::NKC) {
      stage_rows<C::BK, C::DC, C::LDK, C::NT>(st, kb, a.k.ss, k0, kend,
                                              c * C::DC, a.D);
    } else {
      stage_rows<C::KV, C::DP, C::LDV, C::NT>(
          st, vb, a.v.ss, k0 + (c - C::NKC) * C::KV, kend, 0, a.D);
    }
  };
  // Waits for chunk g, frees the stage of chunk g - 1 for chunk
  // g + STAGES - 1, and returns chunk g's stage.
  auto next = [&](int g) -> const float* {
    cp_wait<C::STAGES - 2>();
    __syncthreads();
    if (g + C::STAGES - 1 < nchunks) issue(g + C::STAGES - 1);
    cp_commit();
    return ring + (g % C::STAGES) * C::STAGE;
  };

  stage_rows<C::BQ, C::DP, C::LDQ, C::NT>(sq, qb, a.q.ss, q0, a.Sq, 0, a.D);
  cp_commit();
#pragma unroll
  for (int g = 0; g < C::STAGES - 1; ++g) {
    if (g < nchunks) issue(g);
    cp_commit();
  }

  float4 acc[4][C::NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  int g = 0;
  for (int k0 = kbeg; k0 < kend; k0 += C::BK) {
    // ---- S = q k^T: 4 rows x KPT keys a thread ---------------------------
    float s[4][C::KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) s[i][j] = 0.f;
    const float* stk = nullptr;
#pragma unroll 1
    for (int c = 0; c < C::NKC; ++c) {
      stk = next(g++);
      const float* qs = sq + srow0 * C::LDQ + c * C::DC;
      const float* ks = stk + cg * C::LDK;
#pragma unroll 4
      for (int d = 0; d < C::DC; d += 4) {
        float4 qv[4], kv[C::KPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = ld4(qs + i * C::LR * C::LDQ + d);
#pragma unroll
        for (int j = 0; j < C::KPT; ++j)
          kv[j] = ld4(ks + j * C::CG * C::LDK + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C::KPT; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
    }

    // ---- online softmax on the registers (base 2) ------------------------
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) {
        s[i][j] = k0 + cg + C::CG * j < kend ? s[i][j] * a.scale : -INFINITY;
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < C::LC; off <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }
    if constexpr (!C::NARROW) {
      if (lc == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[wc * C::BQ + srow0 + C::LR * i] = mx[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int w = 0; w < C::WC; ++w)
          mx[i] = fmaxf(mx[i], red[w * C::BQ + srow0 + C::LR * i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);   // finite: a real key
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sp[(cg + C::CG * j) * C::LDP + srow0 + C::LR * i] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + ps;
      if (lc == 0 && wc == 0) salpha[srow0 + C::LR * i] = alpha;
    }
    if constexpr (C::NARROW) __syncwarp();

    // ---- O = O alpha + P v: 4 rows x NJ float4 columns a thread ----------
#pragma unroll 1
    for (int c = 0; c < C::NVC; ++c) {
      const float* stv =
          C::NARROW ? stk + C::BK * C::LDK : next(g++);
      if (c == 0) {
        const float4 al = ld4(salpha + 4 * rg);
        const float af[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C::NJ; ++j) {
            acc[i][j].x *= af[i];
            acc[i][j].y *= af[i];
            acc[i][j].z *= af[i];
            acc[i][j].w *= af[i];
          }
      }
      const float* ps = sp + c * C::KV * C::LDP + 4 * rg;
      const float* vs = stv + 4 * cg;
#pragma unroll 4
      for (int kk = 0; kk < C::KV; ++kk) {
        const float4 p4 = ld4(ps + kk * C::LDP);
        const float pf[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          const float4 v4 = ld4(vs + kk * C::LDV + 4 * C::CG * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j].x = fmaf(pf[i], v4.x, acc[i][j].x);
            acc[i][j].y = fmaf(pf[i], v4.y, acc[i][j].y);
            acc[i][j].z = fmaf(pf[i], v4.z, acc[i][j].z);
            acc[i][j].w = fmaf(pf[i], v4.w, acc[i][j].w);
          }
        }
      }
    }
  }

  // ---- the row sums, then the output (or this split's share) -------------
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < C::LC; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  if constexpr (!C::NARROW) {
    if (lc == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[wc * C::BQ + srow0 + C::LR * i] = l[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = 0.f;
#pragma unroll
      for (int w = 0; w < C::WC; ++w) l[i] += red[w * C::BQ + srow0 + C::LR * i];
    }
  }
  if (lc == 0 && wc == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sl[srow0 + C::LR * i] = l[i];
      salpha[srow0 + C::LR * i] = m[i];
    }
  __syncthreads();
  const float4 l4 = ld4(sl + 4 * rg), m4 = ld4(salpha + 4 * rg);
  const float lf[4] = {l4.x, l4.y, l4.z, l4.w};
  const float mf[4] = {m4.x, m4.y, m4.z, m4.w};
  const long long BH = gridDim.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= a.Sq) break;
    if (a.o != nullptr) {
      const float inv = 1.f / lf[i];
      float* op = a.o + b * a.osb + h * a.osh + row * a.oss;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const int col = 4 * (cg + C::CG * j);
        if (col < a.D)
          *reinterpret_cast<float4*>(op + col) =
              make_float4(acc[i][j].x * inv, acc[i][j].y * inv,
                          acc[i][j].z * inv, acc[i][j].w * inv);
      }
    } else {
      const long long r = (split * BH + bh) * a.Sq + row;
      float* pp = a.part + r * a.D;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const int col = 4 * (cg + C::CG * j);
        if (col < a.D) *reinterpret_cast<float4*>(pp + col) = acc[i][j];
      }
      if (cg == 0) a.ml[r] = make_float2(mf[i], lf[i]);
    }
  }
}

// Combines the splits of one output row (a block; a thread a float4): the
// online softmax's step over the splits in order, then the division by the
// row sum.
__global__ void __launch_bounds__(128)
attn_f32_merge(const float* __restrict__ part, const float2* __restrict__ ml,
               float* __restrict__ o, long long osb, long long osh,
               long long oss, int H, int BH, int Sq, int D, int nsplit) {
  const int r = blockIdx.x;   // bh * Sq + row
  const int row = r % Sq, bh = r / Sq, col = 4 * threadIdx.x;
  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nsplit; ++s) {
    const long long rs = (long long)s * BH * Sq + r;
    const float2 ms = ml[rs];
    const float4 os = ld4(part + rs * D + col);
    const float m_new = fmaxf(m, ms.x);
    const float alpha = exp2f(m - m_new), beta = exp2f(ms.x - m_new);
    l = l * alpha + ms.y * beta;
    acc.x = acc.x * alpha + os.x * beta;
    acc.y = acc.y * alpha + os.y * beta;
    acc.z = acc.z * alpha + os.z * beta;
    acc.w = acc.w * alpha + os.w * beta;
    m = m_new;
  }
  const float inv = 1.f / l;
  *reinterpret_cast<float4*>(o + (bh / H) * osb + (bh % H) * osh + row * oss +
                             col) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

template <int DP>
int launch(Args a, int B, int nsplit, int bq, int bk, cudaStream_t stream) {
  using C = typename Pick<DP>::T;
  // The wrapper's tile table (kernels/attention.py:F32_TILES) must be this
  // instantiation's, or its split lengths would not be whole tiles.
  if (bq != C::BQ || bk != C::BK || a.kps % C::BK != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::BYTES);
  if (err != cudaSuccess) return (int)err;
  float* o = a.o;
  if (nsplit > 1) a.o = nullptr;
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, B * a.H, nsplit);
  attn_f32_kernel<C><<<grid, C::NT, C::BYTES, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  attn_f32_merge<<<B * a.H * a.Sq, a.D / 4, 0, stream>>>(
      a.part, a.ml, o, a.osb, a.osh, a.oss, a.H, B * a.H, a.Sq, a.D, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) for q, k, v, o; the
// head dim is contiguous and D a multiple of 4, every stride a multiple of
// 4 and every pointer 16-byte aligned (kernels/attention.py checks). With
// nsplit > 1, part (nsplit, B*H, Sq, D) and ml (nsplit, B*H, Sq, 2) are
// float32 scratch and kps (a multiple of bk) the keys of a split; bq and
// bk are the wrapper's tile sizes for D, checked against the kernel's.
extern "C" int nesr_flash_attn_f32(const void* q, const void* k,
                                   const void* v, void* o, void* part,
                                   void* ml, int B, int H, int Sq, int Skv,
                                   int D, const long long* st, float scale,
                                   int nsplit, int kps, int bq, int bk,
                                   void* stream) {
  Args a;
  a.q = {(const float*)q, st[0], st[1], st[2]};
  a.k = {(const float*)k, st[3], st[4], st[5]};
  a.v = {(const float*)v, st[6], st[7], st[8]};
  a.o = (float*)o;
  a.osb = st[9];
  a.osh = st[10];
  a.oss = st[11];
  a.part = (float*)part;
  a.ml = (float2*)ml;
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.kps = kps;
  a.scale = scale * 1.4426950408889634f;
  if (nsplit < 1 || (long long)(nsplit - 1) * kps >= Skv ||
      (nsplit > 1 && (part == nullptr || ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) return launch<32>(a, B, nsplit, bq, bk, s);
  if (D <= 64) return launch<64>(a, B, nsplit, bq, bk, s);
  if (D <= 128) return launch<128>(a, B, nsplit, bq, bk, s);
  if (D <= 256) return launch<256>(a, B, nsplit, bq, bk, s);
  if (D <= 512) return launch<512>(a, B, nsplit, bq, bk, s);
  return (int)cudaErrorInvalidValue;
}
