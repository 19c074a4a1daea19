// K1 step: one conv of the bf16 residual dense block with its share of the
// dense-block assembly in the epilogue. Five launches an RDB (k = 0..4)
// compute the JAX package's _rdb_fused
// (neural_enhanced_super_resolution_tpu/models/rrdbnet.py:167-193), which
// is no Pallas kernel: XLA's bias-free bf16 convs (_conv3x3_f32, rounded
// to the compute dtype) with the assembly fused into their outputs. The
// port's plain composition of it, five K1 launches with the assembly in
// PyTorch between them (models/rrdbnet.py: FusedRDB._composition), is
// what this kernel equals bit for bit: K1's own tap MMAs and patch layout
// (csrc/conv3x3_body.cuh: the same K order, pass, tap, k16; the same N
// tiles), and the same rounding points in the epilogue
// (kernels/conv3x3_rdb.py: conv3x3_rdb_plain is that composition one step
// at a time). Built without --use_fast_math; every rounding below is an
// IEEE one (__fadd_rn, __fmul_rn, round-to-nearest-even casts).
//
// Step k reads its source (k 0: the RDB input x; k >= 1: x_k, bf16) and
// rounds the conv's fp32 sums once, c = bf16(acc). Conv k's output
// channel j belongs to assembly slot channel k g + j of the bf16 slot
// buffer (N, H, W, 4g + nf), laid out as conv 0's output: its first g
// channels complete slot k + 1 and give x_{k+1} = bf16(lrelu(float(
// bf16(slot + c)) + b)) (k 0: bf16(lrelu(float(c) + b))), stored into a
// buffer other than x_k, whose halo neighbouring tiles still read; the
// rest are added into the slots, bf16(float(slot) + float(c)), conv 0
// first, as PyTorch's bf16 adds run (step 0 stores c there). Step 4
// completes x5 = bf16(slot5 + c4) and writes out = x + 0.2 * bf16(x5 + b),
// each op rounded to bf16 as PyTorch rounds it, and with `skip` (the RRDB
// input, for an RRDB's third RDB) skip + 0.2 * out: the RRDB's residual.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), an RDB on the
// 4 x 268 x 268 tile batch (nf 64, g 32): its operations, 0.1392 ms (x
// read and out written, 256 bytes a pixel, take 0.022 ms). Five launches
// move 2,688 bytes a pixel (x read twice, x1..x4 written and read, the
// slots read and written, out written): 0.2307 ms, the floor of this
// design, not of the RDB. Steps 1-4 are bound by their bytes, step 0 by
// its operations.
//
// Design: a persistent, warp-specialised kernel, one block an SM (grid:
// the SMs, or half the tiles where there are fewer), 320 threads: two
// consumer warpgroups, a producer warp and a weight warp. Against the
// costs of the earlier one-tile-a-block step on K1's own mainloop
// (PERF.md: a block's phases one after another, its stores 24-43% and
// slot prefetch 14% of it, its patch 16-21%, every weight slab reloaded
// for every 8 x 16 tile, spills at 128 registers):
//  * Consumer c of block b walks tiles 2 (b + i grid) + c, i = 0, 1, ...:
//    4 x 16 output pixels (one m64 row block, one 16-pixel row a warp)
//    and the N tiles of a sweep (below), of at most 128 channels as K1
//    has them. Blocks no longer relaunch, set up barriers or reload their
//    weights for every tile (2,312 blocks a launch before).
//  * The producer warp keeps each consumer's next tile in flight while it
//    computes its current one, in a ring of four stages (two a consumer,
//    full/empty mbarriers): the patch of x_k (6 x 18 pixels at pixel
//    pitch KC + 8, so each ldmatrix phase is conflict free) and, for
//    k >= 1, the slot channels the tile adds to, straight into the
//    consumer's staging tile (pitch nps N + 8; at step 4 x and skip too).
//    Its lane 0 issues each as one TMA box from a 4-d tensor map over the
//    NHWC tensor (built per launch; zeros past the image edges and the
//    last channel); widths the 16-byte path does not take go by the
//    warp's cp.async.
//  * Resident weights: the weight warp loads a sweep's packed weights
//    once a block with bulk copies onto one mbarrier, and they stay while
//    the block walks all its tiles. A sweep is every N tile where they fit
//    beside the stages (steps 1-4 of the trunk: 36,864 B at w4 up to
//    92,160 B at w1), else one N tile (w0, 64 -> 192, 221,184 B: two
//    sweeps of 110,592 B, each reading x_k again, from L2 mostly).
//  * Ping-pong: the consumers take turns at the tensor cores (a pair of
//    named barriers orders their MMA phases), so one's epilogue runs under
//    the other's MMAs; each syncs on a named barrier of its own (bar.sync
//    id, 128), never the whole block.
//  * The epilogue: each N tile's sums, rounded once, are added into the
//    slots in the staging tile; x_{k+1} (or out) goes into a dense buffer
//    in the stage's patch, dead by then; the tile leaves by bulk copies
//    (cp.async.bulk, shared to global), one a tile row of x_{k+1} or out
//    and one a pixel of the slot channels, which run on while the consumer
//    goes on: its stage goes back to the producer after its next MMA
//    phase, when they have read it (at once with one stage a consumer).
//  * Registers: 320 threads, three warps on some of an SM's four
//    schedulers, leave 168 a thread: the N 80-128 accumulators (40-64)
//    and two sets of A fragments fit without spills. Handing a producer
//    warpgroup's registers to the consumers (setmaxnreg, 384 threads) was
//    tried: the build still reported 168 registers, now with spills, and
//    the step was no faster (PERF.md).
// Shared memory (kernels/conv3x3_rdb.py: step_smem computes the same):
// [a sweep's weights][4 stages: patch (every pass, each 128-byte
// aligned), staging tile, x and skip at step 4][barriers]. The trunk's
// steps: step 0 <96, 4> 226,384 B (a sweep 110,592 B, stages of 28,928
// B); step 1 <80, 2> 213,072 B; step 2 <128, 2> 178,256 B; step 3
// <96, 2> 143,440 B; step 4 <64, 2> 174,160 B (stages of 34,304 B with x
// and skip).
#include <cuda.h>
#include <cudaTypedefs.h>

#include "conv3x3_body.cuh"

// Phase hooks, empty here: tools/rdb_step_ablation.py defines them in a
// copy that sums each role's SM clock by phase.
#ifndef STEP_TRACE_BEGIN
#define STEP_TRACE_BEGIN
#define STEP_MARK(i)
#define STEP_TRACE_END(role)
#endif

namespace {

constexpr int STH = 4;                 // a consumer's tile: STH x TW pixels
constexpr int SPX = STH * TW;          // 64: one m64 row block
constexpr int PROWS = STH + 2;         // its patch: PROWS x (TW + 2)
constexpr int CTHREADS = 128;          // a consumer: one warpgroup
constexpr int CWARPS = 8;              // the two consumers' warps
constexpr int STEP_THREADS = CWARPS * 32 + 64;   // + the producer warps
// Named barriers: 1 + c a consumer's own; ORD0 / ORD1 consumer 0 / 1 may
// start its MMAs.
constexpr int ORD0 = 3, ORD1 = 4;

// x: the step's source (k 0: the RDB input; k >= 1: x_k, (N, H, W, g)).
struct Params : ConvParams {
  const float* bias;   // (cs,) the RDB's biases, conv1..conv5
  bf16* slots;         // (N, H, W, cs) bf16 assembly slots
  bf16* xn;            // k < 4: x_{k+1}, (N, H, W, g)
  const bf16* res;     // k 4: the RDB input, (N, H, W, nf)
  const bf16* skip;    // k 4: the RRDB input or null
  bf16* out;           // k 4: (N, H, W, nf)
  int k, g, cs, nf;
  int vec_out;         // 16-byte slot, x_{k+1}, x, skip and out paths
  int bulk;            // TMA loads and bulk stores (else cp.async, stores)
  int tiles, tiles_y;  // STH x TW tiles of the batch; of an image's height
  int nps, sweeps;     // N tiles a sweep; sweeps
  int epoch;           // rounds of tiles a load of a sweep's weights serves
                       // (all of the sweep's)
  int stages;          // 4, or 2 where 4 do not fit
  int tp;              // the staging tile's pitch, elements: nps N + 8
  // shared memory, bytes: a pass of the patch, a stage, where the stages
  // start, and in a stage the staging tile and x (then skip); then the
  // barriers. The dense output (bulk) is the patch's, dead by then.
  int patch_bytes, stage_bytes, stage_off, tile_off, res_off, bar_off;
};

// The tensor maps of the producer's TMA boxes; those a step does not use
// are left unset.
struct Maps {
  CUtensorMap src;     // the patch: (KC + 8) channels x 18 x 6
  CUtensorMap slots;   // the slots a sweep adds to: tp channels x 16 x 4
  CUtensorMap res, skip;   // x and skip: nf channels x 16 x 4
};

// The shared-memory layout of a launch (see the header; step_smem in
// kernels/conv3x3_rdb.py computes the same).
struct Layout {
  int patch, stage, stage_off, tile_off, res_off, bar_off, total;
};

Layout layout(int kc, int npass, int nw, int nps, int k, int nf,
              int stages) {
  Layout l;
  l.patch = round_up(PROWS * (TW + 2) * (kc + 8) * 2, 128);
  l.tile_off = npass * l.patch;
  l.res_off = round_up(l.tile_off + SPX * (nps * nw + 8) * 2, 128);
  l.stage = round_up(l.res_off + (k == 4 ? 2 * SPX * nf * 2 : 0), 128);
  l.stage_off = round_up(nps * npass * 9 * kc * nw * 2, 128);
  l.bar_off = l.stage_off + stages * l.stage;
  l.total = l.bar_off + 8 * (2 * stages + 2);
  return l;
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's pending count is raised first, so this arrival nets out
// and the thread's own mbar_arrive is the one the count expects).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// One bulk copy onto `bar`, whose bytes an earlier expect_tx announced.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One bulk copy from shared to global memory, tracked by this thread's
// bulk groups: commit, then wait for the copies' reads of shared memory
// (the buffer may be reused) or their completion.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Tiles of consumer c of this block (consumer 1 has as many as consumer
// 0, or one fewer).
__device__ __forceinline__ int tile_count(const Params& p, int c) {
  const int first = 2 * blockIdx.x + c, stride = 2 * gridDim.x;
  return first < p.tiles ? (p.tiles - first + stride - 1) / stride : 0;
}

// Image and origin of tile t (row-major in each image).
__device__ __forceinline__ void origin(const Params& p, int t, int& n,
                                       int& oy, int& ox) {
  const int per_img = p.tiles_x * p.tiles_y;
  n = t / per_img;
  const int r = t % per_img;
  oy = r / p.tiles_x * STH;
  ox = r % p.tiles_x * TW;
}

// Channels [c0, c0 + count) of each in-image pixel of a tile of `src`
// (C channels a pixel) to `dst` at pixel pitch `pitch` by the producer
// warp, 16-byte cp.async (vec) or plain loads; out-of-image pixels are
// left as they are, since nothing of them is written.
__device__ void load_pixels(const Params& p, const bf16* src, int C,
                            bf16* dst, int pitch, int n, int oy, int ox,
                            int c0, int count, int lane) {
  const bf16* base = src + (size_t)n * p.H * p.W * C + c0;
  const int v8 = p.vec_out ? 8 : 1, nv = count / v8;
#pragma unroll 1
  for (int it = lane; it < SPX * nv; it += 32) {
    const int v = it % nv, px = it / nv;
    const int gy = oy + px / TW, gx = ox + px % TW;
    if (gy >= p.H || gx >= p.W) continue;
    const bf16* s = base + ((size_t)gy * p.W + gx) * C + v8 * v;
    bf16* d = dst + px * pitch + v8 * v;
    if (p.vec_out) nesr::cp_async_zfill<16>(d, s, 16);
    else *d = *s;
  }
}

// Stage s's loads for a tile at (n, oy, ox) and the sweep of output
// channels [c0, c1): TMA boxes from lane 0 (their bytes announced on the
// full barrier), or the warp's cp.async and plain copies (each lane's
// arrival counted).
template <int KS>
__device__ __forceinline__ void load_stage(const Params& p, const Maps& m,
                                           unsigned char* st, uint32_t full,
                                           int n, int oy, int ox, int c0,
                                           int c1, int lane) {
  constexpr int KC = 16 * KS;
  const int npass = p.kp / KC;
  if (p.bulk) {
    const uint32_t st_s = nesr::smem_u32(st);
    nesr::mbar_expect_tx(
        full, npass * PROWS * (TW + 2) * (KC + 8) * 2 +
                  (p.k > 0 ? SPX * p.tp * 2 : 0) +
                  (p.k == 4 ? (p.skip ? 2 : 1) * SPX * p.nf * 2 : 0));
    for (int pc = 0; pc < npass; ++pc)
      nesr::tma_load_4d(st_s + pc * p.patch_bytes, &m.src, pc * KC, ox - 1,
                        oy - 1, n, full);
    if (p.k > 0)
      nesr::tma_load_4d(st_s + p.tile_off, &m.slots, p.k * p.g + c0, ox, oy,
                        n, full);
    if (p.k == 4) {
      nesr::tma_load_4d(st_s + p.res_off, &m.res, 0, ox, oy, n, full);
      if (p.skip)
        nesr::tma_load_4d(st_s + p.res_off + SPX * p.nf * 2, &m.skip, 0, ox,
                          oy, n, full);
    }
    return;
  }
  for (int pc = 0; pc < npass; ++pc)
    stage_pass<KS, 3, PROWS>(p, reinterpret_cast<bf16*>(st + pc *
                                                         p.patch_bytes),
                             n, oy, ox, pc, 1, lane, 32);
  if (p.k > 0)
    load_pixels(p, p.slots, p.cs, reinterpret_cast<bf16*>(st + p.tile_off),
                p.tp, n, oy, ox, p.k * p.g + c0, c1 - c0, lane);
  if (p.k == 4) {
    bf16* r = reinterpret_cast<bf16*>(st + p.res_off);
    load_pixels(p, p.res, p.nf, r, p.nf, n, oy, ox, 0, p.nf, lane);
    if (p.skip)
      load_pixels(p, p.skip, p.nf, r + SPX * p.nf, p.nf, n, oy, ox, 0, p.nf,
                  lane);
  }
  cp_async_arrive(full);
  nesr::mbar_arrive(full);
}

// The producer warp: each consumer's tiles in the block's order, sweep by
// sweep, into the consumer's stages in turn.
template <int N, int KS>
__device__ void produce_stages(const Params& p, const Maps& m,
                               unsigned char* smem, uint32_t full_s,
                               uint32_t empty_s, int lane) {
  const int it[2] = {tile_count(p, 0), tile_count(p, 1)};
  const int spc = p.stages / 2;   // stages a consumer
  STEP_TRACE_BEGIN
#pragma unroll 1
  for (int sw = 0; sw < p.sweeps; ++sw) {
    const int c0 = sw * p.nps * N, c1 = min(c0 + p.nps * N, p.Cout);
#pragma unroll 1
    for (int i = 0; i < it[0]; ++i) {
#pragma unroll 1
      for (int c = 0; c < 2; ++c) {
        if (i >= it[c]) continue;
        const int f = sw * it[c] + i;   // the consumer's tiles so far
        const int s = c * spc + f % spc, u = f / spc;
        if (u > 0) nesr::mbar_wait(empty_s + 8 * s, (u - 1) & 1);
        STEP_MARK(0);
        int n, oy, ox;
        origin(p, 2 * (blockIdx.x + i * gridDim.x) + c, n, oy, ox);
        load_stage<KS>(p, m, smem + p.stage_off + s * p.stage_bytes,
                       full_s + 8 * s, n, oy, ox, c0, c1, lane);
        STEP_MARK(1);
      }
    }
  }
  STEP_TRACE_END(2)
}

// The weight warp's lane 0: each sweep's packed weights, once an epoch
// of rounds, after both consumers released the last.
template <int N, int KS>
__device__ void produce_weights(const Params& p, uint32_t w_s,
                                uint32_t wfull_s, uint32_t wempty_s) {
  constexpr int SLAB = 16 * KS * N;   // elements
  const int per_nt = (p.kp / (16 * KS)) * 9;   // slabs an N tile
  const int it0 = tile_count(p, 0);
  int e = 0;
#pragma unroll 1
  for (int sw = 0; sw < p.sweeps; ++sw) {
    const int nts = min(p.nps, p.n_tiles - sw * p.nps);
    const bf16* w = p.wp + (size_t)sw * p.nps * per_nt * SLAB;
#pragma unroll 1
    for (int i = 0; i < it0; i += p.epoch, ++e) {
      if (e > 0) nesr::mbar_wait(wempty_s, (e - 1) & 1);
      nesr::mbar_expect_tx(wfull_s, nts * per_nt * SLAB * 2);
      for (int j = 0; j < nts * per_nt; ++j)
        bulk_copy(w_s + j * SLAB * 2, w + (size_t)j * SLAB, SLAB * 2,
                  wfull_s);
    }
  }
}

__device__ __forceinline__ float bf16_bits_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_bits_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// V bf16 values (8: one 16-byte vector; 1: a scalar) at element offset i
// of shared memory, as floats, and back to memory, rounded to nearest
// even.
template <int V>
__device__ __forceinline__ void load_v(const bf16* base, int i,
                                       float (&f)[V]) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(base + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = bf16_bits_lo(w[e]);
      f[2 * e + 1] = bf16_bits_hi(w[e]);
    }
  } else {
    f[0] = __bfloat162float(base[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(bf16* base, size_t i,
                                        const float (&f)[V]) {
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(base + i) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    base[i] = __float2bfloat16_rn(f[0]);
  }
}

// x_{k+1} = lrelu(v + b) (k < 4) and out = x + 0.2 * bf16(x5 + b), then
// skip + 0.2 * out (step 4), on V values with biases b, each op rounded
// as PyTorch's bf16 ops round (in float, 0.2 as 0.2f); xv and sv are x
// and skip.
template <int V>
__device__ __forceinline__ void assemble(const Params& p, float (&o)[V],
                                         const float (&b)[V],
                                         const float (&xv)[V],
                                         const float (&sv)[V]) {
  if (p.k < 4) {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = nesr::lrelu(__fadd_rn(o[e], b[e]));
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float t = nesr::round_bf16(__fadd_rn(o[e], b[e]));
    o[e] = nesr::round_bf16(
        __fadd_rn(xv[e], nesr::round_bf16(__fmul_rn(0.2f, t))));
    if (p.skip)
      o[e] = nesr::round_bf16(
          __fadd_rn(sv[e], nesr::round_bf16(__fmul_rn(0.2f, o[e]))));
  }
}

// The V biases of output channel co on.
template <int V>
__device__ __forceinline__ void load_bias(const Params& p, int co,
                                          float (&b)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) b[e] = __ldg(p.bias + p.k * p.g + co + e);
}


// The bulk path's epilogue, in two halves. First, once a sweep that holds
// x_{k+1}'s channels (c0 0) or out's: x_{k+1} or out, computed from the
// staging tile into a dense buffer in the stage's patch, dead by then
// (x_{k+1}: g channels a pixel; out: nf).
__device__ __forceinline__ void stage_out(const Params& p, unsigned char* st,
                                          int c0, int ct) {
  if (c0 != 0) return;
  const bf16* tile = reinterpret_cast<const bf16*>(st + p.tile_off);
  const bf16* res = reinterpret_cast<const bf16*>(st + p.res_off);
  bf16* ob = reinterpret_cast<bf16*>(st);
  const int wo = p.k < 4 ? p.g : p.nf, nv = wo / 8;
#pragma unroll 1
  for (int it = ct; it < SPX * nv; it += CTHREADS) {
    const int v = it % nv, px = it / nv;
    float o[8], b[8], xv[8], sv[8];
    load_v<8>(tile, px * p.tp + 8 * v, o);
    if (p.k == 4) {
      load_v<8>(res, px * p.nf + 8 * v, xv);
      if (p.skip) load_v<8>(res + SPX * p.nf, px * p.nf + 8 * v, sv);
    }
    load_bias<8>(p, 8 * v, b);
    assemble<8>(p, o, b, xv, sv);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(ob + px * wo + 8 * v) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Then, after a fence and the consumer's barrier, the copies: one a pixel
// of the sweep's slot channels [max(c0, g), c1) straight from the staging
// tile (threads 0-63), and one a tile row of the dense buffer (threads
// 64-67). They run on while the consumer goes on; the stage is given back
// once they have read it.
__device__ __forceinline__ void issue_stores(const Params& p,
                                             unsigned char* st, int n,
                                             int oy, int ox, int c0, int c1,
                                             int ct) {
  const bf16* tile = reinterpret_cast<const bf16*>(st + p.tile_off);
  const bf16* ob = reinterpret_cast<const bf16*>(st);
  const int wo = p.k < 4 ? p.g : p.nf;
  const size_t img = (size_t)n * p.H * p.W;
  const int s0 = max(c0, p.g);
  if (ct < SPX && p.k < 4 && c1 > s0) {
    const int gy = oy + ct / TW, gx = ox + ct % TW;
    if (gy < p.H && gx < p.W)
      bulk_store(p.slots + (img + (size_t)gy * p.W + gx) * p.cs + p.k * p.g +
                     s0,
                 nesr::smem_u32(tile + ct * p.tp + s0 - c0), (c1 - s0) * 2);
  } else if (ct >= SPX && ct < SPX + STH && c0 == 0) {
    const int r = ct - SPX, gy = oy + r, cols = min(TW, p.W - ox);
    bf16* dst = p.k < 4 ? p.xn : p.out;
    if (gy < p.H)
      bulk_store(dst + (img + (size_t)gy * p.W + ox) * wo,
                 nesr::smem_u32(ob + r * TW * wo), cols * wo * 2);
  }
  bulk_commit();
}

// The other path's epilogue: the staging tile out, V channels an item,
// consecutive threads on consecutive vectors of a pixel (16-byte stores
// when V is 8), for output channels [c0, c1) (tile column co - c0).
template <int V>
__device__ __forceinline__ void write_tile(const Params& p,
                                           const unsigned char* st, int n,
                                           int oy, int ox, int c0, int c1,
                                           int ct) {
  const bf16* tile = reinterpret_cast<const bf16*>(st + p.tile_off);
  const bf16* res = reinterpret_cast<const bf16*>(st + p.res_off);
  const size_t img = (size_t)n * p.H * p.W;
  // x_{k+1}'s channels, then the slots' (k < 4); out's (step 4)
  const int xe = p.k < 4 ? min(c1, p.g) : c1;
  const int s0 = p.k < 4 ? max(c0, p.g) : c1;
  const int nvx = max(xe - c0, 0) / V, nvs = max(c1 - s0, 0) / V;
#pragma unroll 1
  for (int it = ct; it < SPX * nvx; it += CTHREADS) {
    const int v = it % nvx, px = it / nvx, co = c0 + V * v;
    const int gy = oy + px / TW, gx = ox + px % TW;
    if (gy >= p.H || gx >= p.W) continue;
    float o[V], b[V], xv[V], sv[V];
    load_v<V>(tile, px * p.tp + co - c0, o);
    if (p.k == 4) {
      load_v<V>(res, px * p.nf + co, xv);
      if (p.skip) load_v<V>(res + SPX * p.nf, px * p.nf + co, sv);
    }
    load_bias<V>(p, co, b);
    assemble<V>(p, o, b, xv, sv);
    const size_t at = img + (size_t)gy * p.W + gx;
    if (p.k < 4) store_v<V>(p.xn, at * p.g + co, o);
    else store_v<V>(p.out, at * p.nf + co, o);
  }
#pragma unroll 1
  for (int it = ct; it < SPX * nvs; it += CTHREADS) {
    const int v = it % nvs, px = it / nvs, co = s0 + V * v;
    const int gy = oy + px / TW, gx = ox + px % TW;
    if (gy >= p.H || gx >= p.W) continue;
    const bf16* s = tile + px * p.tp + co - c0;
    bf16* d = p.slots + (img + (size_t)gy * p.W + gx) * p.cs + p.k * p.g + co;
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      *d = *s;
    }
  }
}

// Consumer c: sweep by sweep, its tiles, each the sweep's N tiles' MMAs
// (K1's tap MMAs on the resident weights), the sums rounded once and added
// into the slots the producer put in the staging tile (step 0: stored
// there), then the sweep's stores; the stage goes back to the producer,
// and a sweep's weights go back to the weight warp at the end of each
// epoch.
template <int N, int KS>
__device__ void consume(const Params& p, unsigned char* smem, int c,
                        uint32_t full_s, uint32_t empty_s, uint32_t wfull_s,
                        uint32_t wempty_s) {
  constexpr int SLAB = 16 * KS * N;   // elements
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int ct = threadIdx.x % CTHREADS;
  const int it0 = tile_count(p, 0), it1 = tile_count(p, 1);
  const int iters = c ? it1 : it0;
  const int npass = p.kp / (16 * KS);
  const int spc = p.stages / 2;
  const uint32_t w_s = nesr::smem_u32(smem);
  float acc[N / 2];
  // A fragments, double-buffered by tap parity (as K1's).
  uint32_t a[2][KS][4];
  const int frow = lane / 4, q = lane % 4;   // accumulator row, column pair
  int e = 0;   // weight epochs begun
  int pending = -1;   // a stage the last tile's copies still read
  // The stage goes back to the producer, whose next loads into it are the
  // async proxy's: one arrival a warp.
  auto release = [&](int stage) {
    bulk_wait_read();
    nesr::fence_proxy_async();
    __syncwarp();
    if (lane == 0) nesr::mbar_arrive(empty_s + 8 * stage);
  };
  STEP_TRACE_BEGIN
#pragma unroll 1
  for (int sw = 0; sw < p.sweeps; ++sw) {
    const int c0 = sw * p.nps * N, c1 = min(c0 + p.nps * N, p.Cout);
    const int nts = min(p.nps, p.n_tiles - sw * p.nps);
#pragma unroll 1
    for (int i = 0; i < it0; ++i) {
      // The epoch's weights, at its first round; given back after its
      // last round's MMAs.
      if (i % p.epoch == 0) nesr::mbar_wait(wfull_s, e & 1);
      const bool last = i % p.epoch == p.epoch - 1 || i == it0 - 1;
      if (i >= iters) {   // out of tiles: the round's epoch all the same
        if (last) {
          __syncwarp();
          if (lane == 0) nesr::mbar_arrive(wempty_s);
          ++e;
        }
        continue;
      }
      const int f = sw * iters + i;
      const int s = c * spc + f % spc;
      int n, oy, ox;
      origin(p, 2 * (blockIdx.x + i * gridDim.x) + c, n, oy, ox);
      unsigned char* st = smem + p.stage_off + s * p.stage_bytes;
      bf16* tile = reinterpret_cast<bf16*>(st + p.tile_off);
      const uint32_t a_s =
          lane_a_addr<KS, 3>(nesr::smem_u32(st), warp, lane);
      nesr::mbar_wait(full_s + 8 * s, (f / spc) & 1);
      STEP_MARK(0);
      // My turn at the tensor cores: consumer 0 after consumer 1's last
      // MMA phase of this sweep, consumer 1 after consumer 0's of this
      // round.
      if (c == 1 || i > 0) named_sync(c ? ORD1 : ORD0, 256);
      STEP_MARK(1);
#pragma unroll 1
      for (int nt = 0; nt < nts; ++nt) {
#pragma unroll
        for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
#pragma unroll 1
        for (int pc = 0; pc < npass; ++pc) {
          const uint32_t a_p = a_s + pc * p.patch_bytes;
          const uint32_t b0 = w_s + (nt * npass + pc) * 9 * SLAB * 2;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            mma_tap<N, KS, 3>(acc, a[t & 1], a_p, t, b0 + t * SLAB * 2);
            if (t > 0) nesr::wgmma_wait<1>();
          }
          nesr::wgmma_wait<0>();
        }
#pragma unroll
        for (int j = 0; j < N / 2; ++j) nesr::reg_fence(acc[j]);
        if (nt == nts - 1) {
          // The partner's turn, if it has one after this phase in the
          // sweep; the weights back at the epoch's end.
          if (c ? it0 > i + 1 : it1 > i) named_arrive(c ? ORD0 : ORD1, 256);
          if (last) {
            __syncwarp();
            if (lane == 0) nesr::mbar_arrive(wempty_s);
            ++e;
          }
          STEP_MARK(2);
          // The last tile's stage, its copies long since issued.
          if (pending >= 0) release(pending);
          pending = -1;
          STEP_MARK(3);
        }
        // Round the sums to bf16 once and add them into the slots the
        // producer put in the staging tile, in place (step 0 has none:
        // its values are the slots' first terms).
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
                tile + (warp * TW + frow + 8 * h) * p.tp + nt * N + 8 * j +
                2 * q);
            if (p.k > 0) {
              const __nv_bfloat162 sl = *o;
              v0 = __fadd_rn(__bfloat162float(sl.x), nesr::round_bf16(v0));
              v1 = __fadd_rn(__bfloat162float(sl.y), nesr::round_bf16(v1));
            }
            *o = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      STEP_MARK(4);
      named_sync(1 + c, CTHREADS);   // every warp's sums in the tile
      STEP_MARK(5);
      if (p.bulk) {
        stage_out(p, st, c0, ct);
        STEP_MARK(6);
        nesr::fence_proxy_async();   // the tile and the buffer, to the copies
        named_sync(1 + c, CTHREADS);
        STEP_MARK(7);
        issue_stores(p, st, n, oy, ox, c0, c1, ct);
        // Given back once the copies have read it: after the next tile's
        // MMAs, or now where that tile needs this very stage.
        if (spc > 1) pending = s;
        else release(s);
      } else {
        if (p.vec_out) write_tile<8>(p, st, n, oy, ox, c0, c1, ct);
        else write_tile<1>(p, st, n, oy, ox, c0, c1, ct);
        release(s);
      }
      STEP_MARK(8);
    }
  }
  bulk_wait();   // every copy done before the block exits
  if (pending >= 0) release(pending);
  STEP_TRACE_END(c)
}

template <int N, int KS>
__global__ void __launch_bounds__(STEP_THREADS, 1)
rdb_bf16_step_kernel(const __grid_constant__ Maps m, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  const uint32_t full_s = nesr::smem_u32(bars);
  const uint32_t empty_s = full_s + 8 * p.stages;
  const uint32_t wfull_s = empty_s + 8 * p.stages, wempty_s = wfull_s + 8;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      // the producer's lane 0 (TMA) or its 32 lanes; a consumer's warps
      nesr::mbar_init(&bars[s], p.bulk ? 1 : 32);
      nesr::mbar_init(&bars[p.stages + s], 4);
    }
    nesr::mbar_init(&bars[2 * p.stages], 1);
    nesr::mbar_init(&bars[2 * p.stages + 1], CWARPS);
    nesr::mbar_init_fence();
  }
  __syncthreads();
  if (warp == CWARPS) {
    if (!p.bulk || lane == 0)
      produce_stages<N, KS>(p, m, smem, full_s, empty_s, lane);
  } else if (warp == CWARPS + 1) {
    if (lane == 0)
      produce_weights<N, KS>(p, nesr::smem_u32(smem), wfull_s, wempty_s);
  } else {
    consume<N, KS>(p, smem, warp / 4, full_s, empty_s, wfull_s, wempty_s);
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so the library links against the CUDA runtime alone.
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* q = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &q,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      q = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(q);
  }();
  return fn;
}

// A 4-d map over an NHWC bf16 tensor (C, W, H, N) with boxes of (bc
// channels, bw pixels, bh rows, 1 image), unswizzled (a box lands at
// pixel pitch bc); zeros read past every edge, nothing written past one.
int make_map(CUtensorMap* map, const void* t, int C, int W, int H, int N,
             int bc, int bw, int bh) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(t), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// The maps of the producer's boxes for step k.
int make_maps(Maps& m, const Params& p, int N) {
  const int kc = p.Cin <= 16 ? 16 : p.Cin <= 32 ? 32 : 64;
  int err = make_map(&m.src, p.x, p.Cin, p.W, p.H, N, kc + 8, TW + 2, PROWS);
  if (!err && p.k > 0)
    err = make_map(&m.slots, p.slots, p.cs, p.W, p.H, N, p.tp, TW, STH);
  if (!err && p.k == 4)
    err = make_map(&m.res, p.res, p.nf, p.W, p.H, N, p.nf, TW, STH);
  if (!err && p.k == 4 && p.skip)
    err = make_map(&m.skip, p.skip, p.nf, p.W, p.H, N, p.nf, TW, STH);
  return err;
}

template <int N, int KS>
int launch(const Maps& m, const Params& p, int grid, int smem,
           cudaStream_t stream) {
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      rdb_bf16_step_kernel<N, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rdb_bf16_step_kernel<N, KS><<<grid, STEP_THREADS, smem, stream>>>(m, p);
  return (int)cudaGetLastError();
}

template <int N>
int launch_ks(const Maps& m, const Params& p, int ks, int grid, int smem,
              cudaStream_t stream) {
  switch (ks) {
    case 1: return launch<N, 1>(m, p, grid, smem, stream);
    case 2: return launch<N, 2>(m, p, grid, smem, stream);
    default: return launch<N, 4>(m, p, grid, smem, stream);
  }
}

}  // namespace

// One step k (0..4) of the bf16 RDB; see the header. n_width: the N tile
// width the weights were packed for (kernels/conv3x3.py:tile_width(Cout));
// a pass is 16, 32 or 64 input channels as Cin is at most 16, at most 32
// or more (kernels/conv3x3.py:pass_width). vec: g and nf multiples of 8
// and every pointer 16-byte aligned. grid, nps, stages, bulk and smem are
// the launch kernels/conv3x3_rdb.py:step_plan chose: blocks, N tiles a
// sweep, input stages, TMA loads and bulk stores (needs vec), and dynamic
// shared memory, which must be this layout's.
extern "C" int nesr_rdb_bf16_step(
    const void* src, const void* wp, const void* bias, void* slots, void* xn,
    const void* x, const void* skip, void* out, int N, int H, int W, int Cin,
    int Cout, int k, int g, int cs, int n_width, int vec, int grid, int nps,
    int stages, int bulk, int smem, void* stream) {
  const int ks = Cin <= 16 ? 1 : Cin <= 32 ? 2 : 4;
  Params p;
  p.x = (const bf16*)src;
  p.wp = (const bf16*)wp;
  p.bias = (const float*)bias;
  p.slots = (bf16*)slots;
  p.xn = (bf16*)xn;
  p.res = (const bf16*)x;
  p.skip = (const bf16*)skip;
  p.out = (bf16*)out;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kp = round_up(Cin, 16 * ks);
  p.k = k;
  p.g = g;
  p.cs = cs;
  p.nf = cs - 4 * g;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + STH - 1) / STH;
  p.tiles = N * p.tiles_x * p.tiles_y;
  p.vec = Cin % 8 == 0 ? 8 : Cin % 4 == 0 ? 4 : 1;
  p.vec_out = vec;
  p.n_tiles = (Cout + n_width - 1) / n_width;
  p.wave = 0;
  p.nps = nps;
  p.sweeps = nps > 0 ? (p.n_tiles + nps - 1) / nps : 0;
  p.stages = stages;
  p.tp = nps * n_width + 8;
  p.bulk = bulk;
  const int npass = p.kp / (16 * ks);
  const Layout l = layout(16 * ks, npass, n_width, nps, k, p.nf, stages);
  // The bulk path: 16-byte paths, boxes of at most 256 channels,
  // x_{k+1}'s channels (out's) all in the first sweep, and the dense
  // output within the patch.
  const bool ok =
      grid >= 1 && 2 * (grid - 1) < p.tiles && nps >= 1 &&
      nps <= p.n_tiles && (stages == 2 || stages == 4) &&
      (!bulk || (vec && p.tp <= 256 && p.nf <= 256 &&
                 (k < 4 ? min(nps * n_width, Cout) >= g : p.sweeps == 1) &&
                 SPX * (k < 4 ? g : p.nf) * 2 <= l.tile_off));
  if (!ok || l.total != smem) return (int)cudaErrorInvalidValue;
  p.epoch = (p.tiles + 2 * grid - 1) / (2 * grid);
  p.patch_bytes = l.patch;
  p.stage_bytes = l.stage;
  p.stage_off = l.stage_off;
  p.tile_off = l.tile_off;
  p.res_off = l.res_off;
  p.bar_off = l.bar_off;
  Maps m;
  if (bulk) {
    const int err = make_maps(m, p, N);
    if (err) return err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_width) {
    case 8: return launch_ks<8>(m, p, ks, grid, smem, s);
    case 16: return launch_ks<16>(m, p, ks, grid, smem, s);
    case 32: return launch_ks<32>(m, p, ks, grid, smem, s);
    case 64: return launch_ks<64>(m, p, ks, grid, smem, s);
    case 80: return launch_ks<80>(m, p, ks, grid, smem, s);
    case 96: return launch_ks<96>(m, p, ks, grid, smem, s);
    case 128: return launch_ks<128>(m, p, ks, grid, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
