// K3f: K3's float32 form. Non-causal, unmasked attention
// softmax(q k^T * scale) v over strided (batch, head, sequence, head dim)
// float32 views, all in float32 on the CUDA cores, with the online softmax
// of a flash kernel: the (Sq, Skv) scores never reach device memory.
// ``precision: "float32"`` (the JAX package's parity mode) runs it wherever
// bf16 runs K3.
//
// Replaces the JAX package's Pallas kernels/attention.py:flash_attention on
// float32 operands (its parity mode casts q, k, v to float32 and runs the
// same kernel; K3 takes its bf16 form).
//
// What bounds it on an H100: its operations, 4 x Sq x Skv x d against 67
// TFLOP/s of float32 outside the tensor cores. The design is the plain one,
// right first:
//  * A block (8 warps) owns 32 query rows of one (batch, head); each row
//    belongs to 8 lanes of one warp. The q tile stays in shared memory; the
//    keys and then the values of each 32-key tile pass through one shared
//    buffer. Rows are padded by 4 floats, so the 8 lanes of a float4 load
//    phase hit distinct banks.
//  * Scores: a lane computes 4 of its row's 32 (keys 8i + lane % 8); the
//    row's max and sum are reduced over its 8 lanes with shuffles; P goes
//    to shared memory. Keys past Skv score -inf.
//  * Output: a lane holds d/8 of its row's columns (float4 groups 32 apart)
//    in registers, rescaled by exp(m_old - m_new) each tile, divided by the
//    row's sum at the end. The head dim is zero-padded to the template's
//    DP (32 ... 512), which changes no dot product.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32, BK = 32, THREADS = 256;

struct Operand {
  const float* ptr;
  long long sb, sh, ss;   // element strides: batch, head, sequence
};

struct Args {
  Operand q, k, v;
  float* o;
  long long osb, osh, oss;
  int H, Sq, Skv, D;
  float scale;
};

template <int DP>
struct Smem {
  static constexpr int LD = DP + 4;
  static constexpr int BYTES = (BQ * LD + BK * LD + BQ * (BK + 1)) * 4;
};

// rows [r0, r0 + rows) of one (batch, head) of t into dst (rows x LD),
// zero past S and past D.
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, const Operand& t,
                                          int b, int h, int r0, int rows,
                                          int S, int D) {
  constexpr int LD = Smem<DP>::LD, C4 = DP / 4;
  const float* base = t.ptr + b * t.sb + h * t.sh;
  for (int i = threadIdx.x; i < rows * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c < D)
      v = *reinterpret_cast<const float4*>(base + (r0 + r) * t.ss + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS) attn_f32_kernel(Args a) {
  constexpr int LD = Smem<DP>::LD, NO = DP / 32;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* skv = sq + BQ * LD;
  float* sp = skv + BK * LD;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x >> 3, cc = threadIdx.x & 7;

  load_rows<DP>(sq, a.q, b, h, q0, BQ, a.Sq, a.D);
  float4 o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < a.Skv; k0 += BK) {
    __syncthreads();   // the last tile's values are read
    load_rows<DP>(skv, a.k, b, h, k0, BK, a.Skv, a.D);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(sq + r * LD + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(skv + (cc + 8 * i) * LD + dd);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = k0 + cc + 8 * i < a.Skv ? s[i] * a.scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);   // finite: the tile has a real key
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - m_new);
      sp[r * (BK + 1) + cc + 8 * i] = p;
      ps += p;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l = l * alpha + ps;
    m = m_new;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j].x *= alpha;
      o[j].y *= alpha;
      o[j].z *= alpha;
      o[j].w *= alpha;
    }
    __syncthreads();   // the keys are read, P is written
    load_rows<DP>(skv, a.v, b, h, k0, BK, a.Skv, a.D);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = sp[r * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(skv + c * LD + 4 * cc + 32 * j);
        o[j].x += p * vv.x;
        o[j].y += p * vv.y;
        o[j].z += p * vv.z;
        o[j].w += p * vv.w;
      }
    }
  }

  if (q0 + r >= a.Sq) return;
  const float inv = 1.f / l;
  float* op = a.o + b * a.osb + h * a.osh + (q0 + r) * a.oss;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = 4 * cc + 32 * j;
    if (c < a.D)
      *reinterpret_cast<float4*>(op + c) =
          make_float4(o[j].x * inv, o[j].y * inv, o[j].z * inv, o[j].w * inv);
  }
}

template <int DP>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = Smem<DP>::BYTES;
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, B * a.H);
  attn_f32_kernel<DP><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) for q, k, v, o; the
// head dim is contiguous and D a multiple of 4, every stride a multiple of
// 4 and every pointer 16-byte aligned (kernels/attention.py checks).
extern "C" int nesr_flash_attn_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Sq, int Skv, int D,
                                   const long long* st, float scale,
                                   void* stream) {
  Args a;
  a.q = {(const float*)q, st[0], st[1], st[2]};
  a.k = {(const float*)k, st[3], st[4], st[5]};
  a.v = {(const float*)v, st[6], st[7], st[8]};
  a.o = (float*)o;
  a.osb = st[9];
  a.osh = st[10];
  a.oss = st[11];
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) return launch<32>(a, B, s);
  if (D <= 64) return launch<64>(a, B, s);
  if (D <= 128) return launch<128>(a, B, s);
  if (D <= 256) return launch<256>(a, B, s);
  if (D <= 512) return launch<512>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
