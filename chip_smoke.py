"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Prints the machine's identity first (the card, its UUID, SMs, clocks
and NVIDIA driver, the CUDA runtime, cuDNN, nvcc; after the build the
kernel library's hash). Builds the port's hand-written kernels from ``csrc/``
(one nvcc per source, in parallel), checks in the library's SASS that every K1, K2 and K3
instantiation issues bf16 ``wgmma`` (HGMMA) and every K4 and K4 step one
the int8 form (IGMMA), prints the K4 step's registers, spills and
occupancy, and holds each kernel against its plain PyTorch version at the
shapes its path gives it: K1 and K2 on the ESRGAN path, K1 at SwinIR's
180-channel shapes, K3 (flash attention) on the diffusion path, K4 (the
standalone int8 conv) bit for bit at the int8 trunk's and the trained
fixture's shapes, and its redesign, the K4 step (``csrc/rdb_int8.cu``: one
launch a conv of the int8 RDB, the quantise in its patch load and the
dense-block assembly in its epilogue) with ``int8_amax``, bit for bit at
an RDB's five steps (x_{k+1} or out, the slots, the scale chain) on the
trunk's and the fixture's shapes, and timed an RDB at a time in turns with
the K4 composition, the fused trunk's RDB and K2. Beside each
kernel's time it prints its bound at the H100's peak rates and, for scale,
the PyTorch call that computes the same function (cuDNN's bf16 conv for
K1, SDPA for K3; none exists for K2, which is held against the default
trunk's RDB, five K1 convs and the elementwise assembly, as its
yardstick, nor for K4: PyTorch has no int8 conv on CUDA; K1's bf16 time
at the same shape stands beside it). K2, K3, K4, SDPA, the plain versions
and K2's yardstick are timed by device time (torch.profiler kernel
durations), with the wall a call beside it. Then, with seeded synthetic
weights:

* the full-width 12-channel RRDBNet x4 (64 features, 23 blocks, growth 32)
  on a 4-tile batch with the fused, dform and int8 trunks (int8: against
  its plain versions and the fused trunk, its trunk bit for bit against
  the plain trunk, 345 step, 1 int8_amax and 6 K1 launches with no
  quantize_int8, no plain call and no host sync, timed in turns with the
  K4 composition, the fused and the dform trunk, each split by kernel
  family); the int8 quality gate of tests/test_quality.py on the trained
  fixture;
* the full-width SD x4 upscaler (written as a diffusers-layout snapshot):
  one UNet pass at a 128^2 latent and one VAE decode, with K3 against the
  same forward on the plain attention;
* SegFormer-b0 (no kernel; written as an HF-layout snapshot) at 512x512
  in bf16 against the CPU; NL-means' kernel (``csrc/nlmeans.cu``: one
  launch a call) against its plain version on the card at five shapes
  (a 32-tile chunk of the denoise path, a whole 768x576 image, a ragged
  batch, a 9x11 image, the one-field form with sigma on a float image),
  each with its time, launches a call, the plain version's time, the
  bound and the SFU floor of the exps, then the denoise on the card
  against the CPU;
* the ESRGAN-only product path (the CLI in a subprocess, ``enhance_image``
  in process), then ESRGAN + diffusion ensembled (the CLI at 128x128 and
  ``enhance_image`` on a ragged 104x72 input for two iterations), then the
  JAX package's default config (the CLI at 128x128: NL-means denoise,
  segmentation, ESRGAN and diffusion) and a 1024x768 ESRGAN request with
  denoise and segmentation on their tiled path (then in turns with the
  plain NL-means), each path with the launch counts zeroed before it and
  read after it, every denoise path on NL-means' kernel and never its
  plain version;
* SwinIR-M x4 (embed 180, 6 x 6 STLs, window 8; written as an official
  .pth and loaded with its config inferred) on one 268^2 tile against the
  same model on K1's plain version, with device time, wall, launches, the
  split by kernel family and the bound, and against the port on the CPU
  in float32 at 60x44; a 1024x768 ESRGAN + SwinIR request (12 SwinIR
  tiles) and the 128x128 default config plus SwinIR (three branches into
  the ensemble), in process; one CLI process over a directory of three
  images with ``--use_swinir --no_diffusion`` (batch mode);
* the two config modes through the entry points: an int8-trunk request
  at 1024x768 in process and as a CLI process, and a parity-tiling request
  (``memory_efficient``) at 1024x768;
* the paths on small inputs against the CPU in float32 (ESRGAN alone and
  with denoise and segmentation, a parity-tiling request, diffusion);
* ``tools/torch_precompile.py`` in a subprocess first (it does the build);
  a 1600x1200 request (35 tiles, three chunks) on the overlapped streamed
  final against the blocking per-chunk copy, bit for bit, with both stage
  times and the device-busy share; the full-width ``vae_encode`` of a
  512^2 image (one K3 launch an encode) against the plain attention;
* ``precision: "float32"`` (the parity mode) on the card: an ESRGAN
  request against the CPU's, and an ESRGAN + diffusion request against
  the same request on the plain attention, both on the float32 forms of
  K1 and K3 (K1f, K3f) and the float32 RDB step; the full-width RRDBNet x4
  in float32 on the 4-tile batch (345 step and 2 K1f launches) against
  the same forward on the plain versions, against itself run again (bit
  for bit) and, on a crop of one tile, against the plain forward in
  float64, with its device time split by kernel family; before it the
  step's scalar forms and K1f's forms with every pointer 4 bytes off a
  16-byte boundary; then K1f against its plain version at the shapes of that
  forward, of the requests and of the step phase's composition, and
  K3f at every FLASH_SHAPES row and the request's shapes (with the split
  count of each);
* the multi-device layer over a mesh of every card, or of the one card
  listed four times (a one-card rehearsal: no time is a multi-card
  speed): tile-batch DP of the full-width RRDBNet x4 on 1024x768 against
  one device bit for bit, with its K1 launches (forwards x 351) and no
  host sync in the shard dispatch loop (sync debug mode "error"); strips
  against a sequential emulation; the member ensemble of two RRDBNets;
  split CFG of the full-width SD x4 UNet against ``cfg_split`` bit for
  bit; a TP UNet pass at tp 2 against the replicated pass; the default
  config and a strips request through ``enhance_array`` with
  ``data_parallel: "auto"`` (the pipeline sees the mesh through a
  replaced ``runtime.device.visible_devices``); ``init_multihost`` on
  NCCL at world size 1 with one ``all_gather``; and the dry run of
  ``parallel/dryrun.py``, one PASS line a step;
* training and the entry points that mirror the JAX package's scripts:
  ``examples/torch_quickstart.py``, ``standalone/torch_direct_esrgan.py``,
  ``standalone/torch_superres_project.py`` (the full-width 3-channel x2plus
  form, stock trunk, bf16) and ``tools/torch_compare_reference.py --check``
  (on esrgan goldens recorded with the plain convs standing in for the
  reference stack) as subprocesses, with their K1 launches;
  ``tools/torch_train_tiny_esrgan.py`` at its defaults (s/step, the loss
  falls) and its checkpoint against bicubic through the pipeline; the
  x2plus forward and K1 at its stock-trunk shapes against the plain
  versions; the differentiable conv (K1f forward and input gradient) at
  every conv of a full-width step against autograd through the plain
  version, with each input gradient's time beside cuDNN's conv2d_input;
  and three Adam steps of the full-width RRDBNet x4 in float32 through K1f
  against the same steps on the plain convs (losses, first-step
  gradients, 701 K1f launches a step, step time, busy share, peak memory).

The fused trunk's RDB in bf16 runs on the K1 step
(``csrc/rdb_bf16.cu``: five launches an RDB, each K1's conv with its share
of the dense-block assembly in its epilogue, the RRDB residual folded into
the third RDB's last step): ``check_conv3x3_rdb`` holds it at every step
against its plain version and, an RDB at a time, against the composition
it replaced (five K1 convs with the assembly in PyTorch: the count of
unequal bf16 values, target none), times an RDB in turns with the
composition, K2 and the K4 step, each step beside its bound and K1's bare
conv, and shows with torch.profiler that an RDB launches nothing else;
every path that runs the fused trunk in bf16 counts the step's launches
(RDB_STEPS a forward) and its plain calls (none); the forward timings add
the fused trunk on the composition.

The float32 trunk (the parity mode) runs the float32 RDB step
(``csrc/rdb_f32.cu``: K1f's mainloop, shared through
``csrc/conv3x3_f32_body.cuh``, with the same share of the assembly in its
epilogue): ``check_conv3x3_rdb_f32`` holds each of an RDB's five steps
bit for bit against the composition's step on K1f and within TOL_F32 of
the plain step, at full width on TILE_BATCH with and without the skip, at
nf 16 / g 8, at g 4 and on a ragged 1 x 13 x 9, the RDB and the RRDB fold
bit for bit against the composition, shows by torch.profiler that an RDB
launches five of its kernels and nothing else, and times an RDB and each
step in turns with the composition (CUDA events) beside the bounds; the
full-width float32 forward runs RDB_STEPS step launches and 2 K1f SAME
convs, never the composition, its device time split into the step, K1f,
the head forms and the rest, in turns with the trunk on the
composition.

Since PR 16 the forward checks hold the folded head (the JAX package's
``_head_forward`` under ``fuse_rdb: true``: K1's head 3x3 form for up1
and up2, its 2x2 form for hr and last; K1f's forms in float32) on every
trunk: against its plain versions, four launches a call and no other
kernel, and timed in turns with the stock head on the same trunk output;
``check_conv3x3`` and ``check_conv3x3_f32`` hold the forms at the head's
shapes beside cuDNN's conv and the bound; every path counts the 2x2
form's launches beside K1's.

The folded head's 3x3 forms are persistent kernels of their own
(``csrc/conv3x3_head.cu`` in bf16, ``csrc/conv3x3_head_f32.cu`` in
float32, counted by ``conv3x3_head`` and ``conv3x3_head_f32``): every
path counts them apart from K1 and K1f, ``check_conv3x3`` also holds the
bf16 form bit for bit against K1's SAME conv with the bias, LeakyReLU in
bf16 and depth-to-space at up1, up2 and a ragged 1 x 17 x 9, and the
``kernels`` line has a row for each. ``int8_amax`` is timed with the L2
flushed before each launch.

Prints the card, every measurement, a JSON line of per-kernel results and,
last, a JSON status line. Any failure exits non-zero without the status
line. Needs no JAX and no network; writes only under ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
PKG = "neural_enhanced_super_resolution_torch"
ARCH = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=64, num_block=23,
            num_grow_ch=32)
TILE_BATCH = (4, 268, 268)   # 4 tiles of 256 + 2 * 6 halo (cuda overlay)
# K1 launches a full-width bf16 forward on the fused trunk: conv_first and
# conv_body; the trunk's 345 convs run as RDB_STEPS launches of the K1
# step (five an RDB, each with its share of the dense-block assembly). The
# folded head adds two launches of K1's head 3x3 form (up1, up2; K1_HEAD)
# and two of its 2x2 form (hr, last). In float32 (the parity mode) the same
# trunk runs RDB_STEPS launches of the float32 RDB step (conv3x3_rdb_f32),
# K1f conv_first and conv_body (K1F_FOLDED), and the head K1f's forms. The
# stock head (stock trunk, fuse_rdb false) takes four K1 launches and
# neither form.
K1_FOLDED = 2
K1_HEAD = 2
RDB_STEPS = 15 * ARCH["num_block"]
K1F_FOLDED = 2
K1_2X2 = 2
K1_STOCK = 15 * ARCH["num_block"] + 6
TOL_KERNEL = 1e-2            # max|err| / max(1, max|ref|), per kernel
TOL_FORWARD = 3e-2           # the same for the full forward
TOL_FLASH = 2e-2             # K3: max|err| / max|ref|, no floor
# K3 at the diffusion path's shapes: (label, B, H, Sq, Skv, d). The UNet's
# self-attention at a 128^2 latent (64^2, 32^2, 16^2 grids), the VAE
# mid-block (one head, d 512, the whole latent), the ragged lengths of a
# 104x72 input (52x36 and 13x9 grids) and a VAE-like ragged one, and a
# cross length.
FLASH_SHAPES = [("unet 64^2 d64", 1, 8, 4096, 4096, 64),
                ("unet 32^2 d64", 1, 8, 1024, 1024, 64),
                ("unet 16^2 d128", 1, 8, 256, 256, 128),
                ("vae 128^2 d512", 1, 1, 16384, 16384, 512),
                ("ragged 52x36 d64", 1, 8, 1872, 1872, 64),
                ("ragged 13x9 d128", 1, 8, 117, 117, 128),
                ("ragged 4000 d512", 1, 1, 4000, 4000, 512),
                ("cross 200x330 d64", 1, 8, 200, 330, 64)]
SEED = 0
# K4 at the int8 trunk's five convs on TILE_BATCH and at the trained
# fixture's (nf 16, growth 8) on the quality gate's 80x80 input.
INT8_SHAPES = [("trunk w0 64->192", *TILE_BATCH, 64, 192),
               ("trunk w1 32->160", *TILE_BATCH, 32, 160),
               ("trunk w2 32->128", *TILE_BATCH, 32, 128),
               ("trunk w3 32->96", *TILE_BATCH, 32, 96),
               ("trunk w4 32->64", *TILE_BATCH, 32, 64),
               ("fixture w0 16->48", 1, 80, 80, 16, 48),
               ("fixture w1 8->40", 1, 80, 80, 8, 40),
               ("fixture w2 8->32", 1, 80, 80, 8, 32),
               ("fixture w3 8->24", 1, 80, 80, 8, 24),
               ("fixture w4 8->16", 1, 80, 80, 8, 16)]
FIXTURE_CKPT = os.path.join(ROOT, "tests", "fixtures",
                            "tiny_trained_x4.safetensors")
FIXTURE_ARCH = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=16,
                    num_block=2, num_grow_ch=8)
SWIN_TILE = (1, 272, 272)    # a 256 + 2 * 6 tile reflect-padded to window 8
SWIN_REQUEST = (768, 1024)   # 12 tiles of 256 px on the cuda overlay
SWIN_K1_PER_FORWARD = 13     # conv_first, 6 RSTB, after_body, before_up,
                             # up1, up2, hr, last
TOL_SD = 3e-2                # full-width UNet / VAE, K3 vs plain attention
TOL_F32 = 1e-5               # K1f, K3f: float32 sums in another order
# The full-width float32 forward against the same forward on the plain
# convs (cuDNN, TF32 off): max|err| / max(1, max|ref|). Each conv's float32
# sums run in another order (~1e-6 of its output); the 69 RDBs and the head
# carry that through 351 convs, so the bar is ten times one conv's.
TOL_F32_FORWARD = 1e-4
# The float32 forward's 64 x 64 crop (the centre of tile 0's output)
# against the same forward of that tile on the plain path in float64
# (cuDNN's float64 convs, whose algorithm choice moves nothing at this
# bar): max|err| / max(1, max|ref|). The float32 forward's sums round at
# ~1e-7 of each conv's output, carried through the same 351 convs as
# against the plain forward: the same bar.
F64_CROP = 64
TOL_F64_CROP = TOL_F32_FORWARD
F32_VAE_SHAPE = (1, 1, 1920, 1920, 512)   # the 48x40 request's VAE mid-block
# K1f's JSON row: conv_body of the full-width float32 forward on TILE_BATCH
# (since the float32 trunk runs the float32 RDB step, K1f's trunk shapes
# are the yardstick's; trunk w0 is still checked and timed there).
F32_CONV_BODY = (*TILE_BATCH, 64, 64, True, False, False)
# The 2x2 form's JSON row: hr of the full-width float32 forward's head.
# The head 3x3 form's JSON row: up2 of that head (K1f's and K1's).
F32_HEAD_UP2 = (TILE_BATCH[0], 2 * TILE_BATCH[1], 2 * TILE_BATCH[2], 64,
                256, True, True, False)
F32_HEAD_HR = (TILE_BATCH[0], 2 * TILE_BATCH[1], 2 * TILE_BATCH[2], 256,
               256, True, 1, True, False)
TOL_SD_CPU = 5e-2            # tiny snapshot latents, card bf16 vs CPU f32
SD_STEPS = 20                # the cuda tier of num_inference_steps
SD_ATTN_PER_PASS = 16        # self-attentions per SD x4 UNet pass
PROMPT = "a photo of a lighthouse on a cliff"
# The CLI in a subprocess, as `python -m <package>` runs it, printing the
# kernels' launch counts after it returns.
CLI_COUNTED = (
    "import json, runpy, sys\n"
    "from neural_enhanced_super_resolution_torch.kernels import (\n"
    "    conv2x2_s2d, conv2x2_s2d_plain, conv3x3, conv3x3_head,\n"
    "    conv3x3_head_f32, conv3x3_int8,\n"
    "    conv3x3_int8_plain, conv3x3_int8_rdb, conv3x3_int8_rdb_plain,\n"
    "    conv3x3_plain, conv3x3_rdb, conv3x3_rdb_f32, conv3x3_rdb_plain,\n"
    "    flash_attention,\n"
    "    flash_attention_plain, int8_amax, int8_amax_plain,\n"
    "    nl_means_fields, nl_means_fields_plain)\n"
    "sys.argv = ['neural_enhanced_super_resolution_torch'] + sys.argv[1:]\n"
    "rc = 0\n"
    "try:\n"
    "    runpy.run_module('neural_enhanced_super_resolution_torch',\n"
    "                     run_name='__main__', alter_sys=True)\n"
    "except SystemExit as exc:\n"
    "    rc = exc.code\n"
    "print('COUNTS ' + json.dumps({\n"
    "    'conv3x3': conv3x3.launches,\n"
    "    'conv3x3_head': conv3x3_head.launches,\n"
    "    'conv3x3_head_f32': conv3x3_head_f32.launches,\n"
    "    'conv3x3_rdb': conv3x3_rdb.launches,\n"
    "    'conv3x3_rdb_f32': conv3x3_rdb_f32.launches,\n"
    "    'conv3x3_rdb_plain': conv3x3_rdb_plain.calls,\n"
    "    'conv2x2_s2d': conv2x2_s2d.launches,\n"
    "    'conv2x2_s2d_plain': conv2x2_s2d_plain.calls,\n"
    "    'flash_attention': flash_attention.launches,\n"
    "    'conv3x3_plain': conv3x3_plain.calls,\n"
    "    'conv3x3_int8': conv3x3_int8.launches,\n"
    "    'conv3x3_int8_plain': conv3x3_int8_plain.calls,\n"
    "    'conv3x3_int8_rdb': conv3x3_int8_rdb.launches,\n"
    "    'conv3x3_int8_rdb_plain': conv3x3_int8_rdb_plain.calls,\n"
    "    'int8_amax': int8_amax.launches,\n"
    "    'int8_amax_plain': int8_amax_plain.calls,\n"
    "    'flash_attention_plain': flash_attention_plain.calls,\n"
    "    'nl_means_fields': nl_means_fields.launches,\n"
    "    'nl_means_fields_plain': nl_means_fields_plain.calls}))\n"
    "sys.exit(rc)\n")


def log(*args):
    print(*args, flush=True)


def _zero_steps():
    """Zeroes the launches of the K1 step and its float32 form, of the
    folded head's 3x3 forms (K1's, K1f's) and of NL-means' kernel, and the
    step's and NL-means' plain versions' calls."""
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3_head, conv3x3_head_f32, conv3x3_rdb, conv3x3_rdb_f32,
        conv3x3_rdb_plain, nl_means_fields, nl_means_fields_plain)
    conv3x3_rdb.launches = conv3x3_rdb_plain.calls = 0
    conv3x3_rdb_f32.launches = 0
    conv3x3_head.launches = conv3x3_head_f32.launches = 0
    nl_means_fields.launches = nl_means_fields_plain.calls = 0


def _step_counts() -> dict:
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3_head, conv3x3_head_f32, conv3x3_rdb, conv3x3_rdb_f32,
        conv3x3_rdb_plain, nl_means_fields, nl_means_fields_plain)
    return {"conv3x3_rdb": conv3x3_rdb.launches,
            "conv3x3_rdb_f32": conv3x3_rdb_f32.launches,
            "conv3x3_rdb_plain": conv3x3_rdb_plain.calls,
            "conv3x3_head": conv3x3_head.launches,
            "conv3x3_head_f32": conv3x3_head_f32.launches,
            "nl_means_fields": nl_means_fields.launches,
            "nl_means_fields_plain": nl_means_fields_plain.calls}


def _nlm_ran(counts: dict) -> bool:
    """NL-means denoise ran on its kernel: launched, its plain version
    never called."""
    return (counts["nl_means_fields"] > 0
            and counts["nl_means_fields_plain"] == 0)


def _steps_ran(counts: dict) -> bool:
    """The fused trunk ran on the K1 step: launched, its plain version
    never called."""
    return counts["conv3x3_rdb"] > 0 and not counts["conv3x3_rdb_plain"]


# The least time an H100 SXM could take for a function (NVIDIA's data sheet:
# 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM): the larger
# of its operations over the peak rate and its bytes (each input read once,
# each output written once) over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# K4 runs int8 on the tensor cores: 1,979 TOP/s dense on the data sheet.
PEAK_INT8_OPS = 1979e12
# NL-means runs on the CUDA cores in float32: 67 TFLOP/s on the data sheet.
PEAK_FP32_FLOPS = 67e12
# Operations a pixel and search offset in the colored NL-means
# (_nl_means_lab_joint): 3 differences, 3 squares, the (a, b) field sum,
# two 7x7 box sums as 2 x 12 shift-adds, 2 divisions, 2 scalings, 2 exps,
# 3 weighted products, 3 numerator and 2 denominator sums.
NLM_OPS_PER_OFFSET = 3 + 3 + 1 + 24 + 2 + 2 + 2 + 3 + 3 + 2
# The one-field form over 3 channels with sigma (_nl_means_f32): 3
# differences, 3 squares, 2 channel sums, one 7x7 box sum as 2 x 12 adds,
# a division, the sigma subtraction and clamp, a scaling, an exp, 3
# weighted products, 3 numerator sums and a denominator sum.
NLM_OPS_ONE_FIELD = 3 + 3 + 2 + 24 + 1 + 2 + 1 + 1 + 3 + 3 + 1
NLM_OFFSETS = 21 * 21
NLM_BATCH = (32, 544, 544)   # one 32-tile chunk of the 512 + 2 * 16 tiles
NLM_IMAGE = (576, 768)       # a whole image, under the 768-px tile threshold
# The kernel's exps run on the SFUs: 16 a clock an SM (CUDA programming
# guide, compute capability 9.0), 132 SMs at the 1.98 GHz boost clock of
# the 67 TFLOP/s figure (128 FMA lanes x 2 x 132 x 1.98 GHz).
PEAK_SFU_OPS = 16 * 132 * 1.98e9
TOL_NLM = 1e-5               # the kernel's float32 against its plain version
SEG_INPUT = 512              # SegFormer's input size


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, ref) -> tuple[float, float]:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(1.0, ref.float().abs().max().item())


def cuda_ms(fn, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def best_ms(fn, tries: int = 3, reps: int = 5) -> float:
    """The least of ``tries`` cuda_ms windows: a window the host stalls
    in (the GPU idle between launches) does not stand for a short
    kernel's time."""
    return min(cuda_ms(fn, reps) for _ in range(tries))


def device_ms(fn, reps: int = 10, floor_ms: float = 0.0) -> float:
    """Device time a call: the durations of the kernels (and copies) that
    ``reps`` calls ran on the card, from torch.profiler, over ``reps``.
    Host dispatch and the gaps between kernels are not in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # A profiling run now and then comes back without device events
    # (CUPTI), wholly or in part; the measurement is taken again, at most
    # three times, while it is empty or under ``floor_ms`` (the bound).
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0 and us / 1e3 / reps >= floor_ms:
            return us / 1e3 / reps
    # Still none: the calls are timed by CUDA events instead, which
    # counts the gaps between a call's kernels too.
    ms = cuda_ms(fn, reps)
    log(f"torch.profiler lost device time ({us / 1e3 / reps} ms a call "
        f"against a floor of {floor_ms}); CUDA events: {ms:.4f} ms a call")
    if not ms >= floor_ms:
        raise AssertionError(f"{ms} ms a call by CUDA events, under the "
                             f"floor {floor_ms}")
    return ms


def device_ms_named(fa, fb, needle, reps: int = 10,
                    floor_ms: tuple = (0.0, 0.0)) -> tuple:
    """Device time a call in the kernels whose name holds ``needle`` (a
    string, or a tuple of strings any of which) and in every other kernel, from one torch.profiler window that runs ``fa``
    and then ``fb`` ``reps`` times each (``fa`` a kernel's wrapper and
    ``fb`` its library call, or ``fa`` a model and ``fb`` nothing). A
    window sometimes loses device events (CUPTI), wholly or in part, so it
    is taken again, at most five times, while either sum is empty or under
    its ``floor_ms`` (the least time the card could take: the bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fa()
    fb()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fa()
            for _ in range(reps):
                fb()
            torch.cuda.synchronize()
        us = [0, 0]
        needles = (needle,) if isinstance(needle, str) else needle
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us[not any(k in e.name for k in needles)] += (
                    e.time_range.elapsed_us())
        ms = (us[0] / 1e3 / reps, us[1] / 1e3 / reps)
        if min(us) > 0 and ms[0] >= floor_ms[0] and ms[1] >= floor_ms[1]:
            return ms
    raise AssertionError(f"torch.profiler lost device time: {ms} ms a call "
                         f"against floors {floor_ms}")


def device_ms_split(fn, groups: dict, reps: int = 2,
                    floor_ms: float = 0.0) -> dict:
    """Device time a call of ``fn`` by kernel family, from one
    torch.profiler window of ``reps`` calls: each group's kernels (names
    holding any of its strings) and "rest", every other kernel or copy. A
    window that loses device events (CUPTI) is taken again, at most five
    times, while a group is empty or the sum is under ``floor_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys([*groups, "rest"], 0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = next((g for g, needles in groups.items()
                            if any(k in e.name for k in needles)), "rest")
                us[key] += e.time_range.elapsed_us()
        ms = {k: v / 1e3 / reps for k, v in us.items()}
        if (all(us[g] > 0 for g in groups)
                and sum(ms.values()) >= floor_ms):
            return ms
    raise AssertionError(f"torch.profiler lost device time: {ms} ms a call "
                         f"against a floor of {floor_ms}")


def launches_per_call(fn, reps: int = 2) -> float:
    """Kernels (and copies) a call puts on the card, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA
               for e in prof.events()) / reps


def aten_ops(fn) -> list[str]:
    """The PyTorch operators one call of ``fn`` dispatches (every ATen op
    below autograd, by a TorchDispatchMode): the port's kernels launch
    through ctypes and dispatch none, so a call that dispatches nothing
    but allocations puts no kernel or copy on the card besides them."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen: list[str] = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return seen


def wall_ms(fn, reps: int = 10) -> float:
    """Host clock a call over ``reps`` calls ended by a synchronize: what
    a caller waits, dispatch included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def machine_line(torch) -> str:
    """What tells this machine from another: the card (name, UUID, PCI
    bus, SMs, power limit, the SM and memory clocks now and at most), the
    NVIDIA driver and the CUDA version it supports, the CUDA runtime,
    cuDNN and torch in this process, and the nvcc that builds the
    kernels."""
    import ctypes
    from neural_enhanced_super_resolution_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,uuid,pci.bus_id,power.limit,"
         "clocks.sm,clocks.max.sm,clocks.mem,clocks.max.mem,driver_version",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, uuid, bus, power, sm, sm_max, mem, mem_max, driver = (
        v.strip() for v in smi.split(","))
    version = ctypes.c_int()
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(version))
    nvcc = subprocess.run([_build.cuda_tool("nvcc"), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    release = next((ln.split("release", 1)[1].strip() for ln in
                    nvcc.splitlines() if "release" in ln), "unknown")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"machine: {name} uuid {uuid} pci {bus}, {sms} SMs, power "
            f"limit {power}, SM clock {sm} (max {sm_max}),"
            f" memory clock {mem} (max {mem_max}); driver {driver} (CUDA "
            f"{version.value // 1000}.{version.value % 1000 // 10}); CUDA "
            f"runtime {torch.version.cuda}, cuDNN "
            f"{torch.backends.cudnn.version()}, torch {torch.__version__}, "
            f"python {sys.version.split()[0]}; nvcc release {release}")


def library_line() -> str:
    """The kernel library this process loaded: its file (named by the
    hash of the sources it was built from) and the hash of its bytes."""
    import hashlib
    from neural_enhanced_super_resolution_torch.kernels import _build
    path = _build.library_path()
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return (f"kernel library: {os.path.basename(path)} (named by the hash "
            f"of csrc/), sha256 of the file {digest}")


def build_kernels() -> None:
    """Builds the kernels; prints K2's, K4's, K4 step's and the folded
    head's forms' (K1's and K1f's) registers and spills from the build log
    and fails on any wgmma that ptxas serialized; checks in the SASS that
    every instantiation of K1 (21), of its head 3x3 form (4:
    conv3x3_head_kernel<8>, <16>, <64>, <128>, csrc/conv3x3_head.cu), of
    its 2x2 form (3: conv2x2_kernel<16>, <64>, <128>, csrc/conv2x2.cu), of
    the K1 step (21, csrc/rdb_bf16.cu), K2 (1) and K3 (6) issues bf16 wgmma
    (HGMMA) and every one of K4 (14) and of its redesign, the step (14),
    the int8 form (IGMMA); prints the K1 step's registers and spills."""
    from neural_enhanced_super_resolution_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernel build+load: {time.perf_counter() - t0:.3f} s "
        f"(nvcc sm_90a, {_build.build_dir()})")
    tag = os.path.basename(_build.library_path())[len("libnesr_torch_"):-3]
    build_log = os.path.join(_build.build_dir(), f"build_{tag}.log")
    if os.path.exists(build_log):
        with open(build_log) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "rdb_fused" in line:
                log("K2 ptxas: " + " | ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i:i + 4]))
            if ("Compiling entry function" in line
                    and ("conv3x3_f32_kernel" in line
                         or "conv2x2_f32_kernel" in line
                         or "conv3x3_head_f32_kernel" in line
                         or "attn_f32_kernel" in line)):
                log("K1f/K3f ptxas " + line.split("'")[1] + ": " + " | ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]))
            for kernel, tag in (("conv3x3_int8_kernel", "K4"),
                                ("rdb_int8_step_kernel", "K4 step"),
                                ("rdb_bf16_step_kernel", "K1 step"),
                                ("conv2x2_kernel", "K1 2x2"),
                                ("conv3x3_head_kernel", "K1 head 3x3"),
                                ("nlmeans_kernel", "NL-means")):
                if "Compiling entry function" in line and kernel in line:
                    rest = line.split("'")[1].split(kernel, 1)[1]
                    args = [p.split("E")[0] for p in rest.split("Li")[1:3]
                            ] if rest.startswith("I") else []
                    log(f"{tag} ptxas <{','.join(args)}>: " + " | ".join(
                        x.split(":", 1)[-1].strip()
                        for x in lines[i + 1:i + 4]))
        serialized = [line for line in lines if "serialized" in line]
        if serialized:
            raise AssertionError("ptxas serialized wgmma: "
                                 + "\n".join(serialized))
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "--dump-sass",
         _build.library_path()], capture_output=True, text=True, check=True,
        timeout=300).stdout
    # K1-K3 issue bf16 wgmma (HGMMA in SASS), K4 the 8-bit integer form
    # (IGMMA).
    hgmma = {"K1": {}, "K1 head 3x3": {}, "K1 2x2": {}, "K1 step": {},
             "K2": {}, "K3": {}, "K4": {}, "K4 step": {}}
    for func in sass.split("Function : ")[1:]:
        name = func.split(None, 1)[0]
        for kernel, tag in (("conv3x3_kernel", "K1"),
                            ("conv3x3_head_kernel", "K1 head 3x3"),
                            ("conv2x2_kernel", "K1 2x2"),
                            ("rdb_bf16_step_kernel", "K1 step"),
                            ("rdb_fused_kernel", "K2"), ("flash_narrow", "K3"),
                            ("flash_wide", "K3"),
                            ("conv3x3_int8_kernel", "K4"),
                            ("rdb_int8_step_kernel", "K4 step")):
            if kernel in name:
                # kernel<A, B>: ..._kernelILi<A>ELi<B>E...
                rest = name.split(kernel, 1)[1]
                args = [p.split("E")[0] for p in rest.split("Li")[1:]
                        ] if rest.startswith("I") else []
                hgmma[tag][f"{kernel}<{','.join(args)}>"] = func.count(
                    "IGMMA" if tag.startswith("K4") else "HGMMA")
    for tag, want in (("K1", 21), ("K1 head 3x3", 4), ("K1 2x2", 3),
                      ("K1 step", 21), ("K2", 1), ("K3", 6), ("K4", 14), ("K4 step", 14)):
        log(f"{tag} SASS: {'IGMMA' if tag.startswith('K4') else 'HGMMA'} "
            f"instructions per instantiation {hgmma[tag]}")
        if len(hgmma[tag]) != want or min(hgmma[tag].values()) == 0:
            raise AssertionError(f"{tag}: {want} instantiations must issue "
                                 f"wgmma: {hgmma[tag]}")
    # The K4 step's occupancy at the trunk's and the fixture's convs.
    import ctypes
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        tile_width)
    occ = {}
    for cin, cout in ((64, 192), (32, 160), (32, 128), (32, 96), (32, 64),
                      (16, 48), (8, 40), (8, 32), (8, 24), (8, 16)):
        nw, blocks, smem = tile_width(cout)[0], ctypes.c_int(), ctypes.c_int()
        _build.check("nesr_rdb_int8_occupancy",
                     _build.load_library().nesr_rdb_int8_occupancy(
                         nw, cin, ctypes.byref(blocks), ctypes.byref(smem)))
        occ[f"{cin}->{cout} <{nw},{1 if cin <= 32 else 2}>"] = (
            f"{blocks.value} blocks/SM, {smem.value} B")
    log(f"K4 step occupancy (256 threads a block): {occ}")


def _rnd(torch, gen, *shape, scale=1.0, dtype=None):
    return (torch.randn(*shape, generator=gen) * scale).to(
        "cuda", dtype or torch.bfloat16).contiguous()


# The folded head's four convs on TILE_BATCH (n, h, w): (label, taps, H,
# W, Cin, Cout, lrelu, pad, mask, d2s), H and W in units of h and w plus
# a pixel; JAX rounding (bf16 before the LeakyReLU) on all four.
HEAD_SHAPES = [("head up1 64->256 d2s", 3, (1, 0), (1, 0), 64, 256, True, 1,
                False, True),
               ("head up2 2x 64->256", 3, (2, 0), (2, 0), 64, 256, True, 1,
                False, False),
               ("head hr 2x2 2x 256->256 pad 1 mask", 2, (2, 0), (2, 0), 256,
                256, True, 1, True, False),
               ("head last 2x2 2x+1 256->12 VALID d2s", 2, (2, 1), (2, 1),
                256, 12, False, 0, False, True)]


def conv_bound(n, hh, ww, taps, cin, cout, pad, nbytes: int,
               peak: float = PEAK_BF16_FLOPS,
               bias: bool = True) -> tuple[float, str]:
    """The bound of a taps x taps conv at padding ``pad`` on (n, hh, ww,
    cin): its output pixels x Cout x taps^2 x Cin multiply-adds; its
    input, weights and output in ``nbytes`` a value, and the fp32 bias.
    A depth-to-space store moves the same bytes."""
    ho, wo = hh + 2 * pad - taps + 1, ww + 2 * pad - taps + 1
    return bound(2.0 * n * ho * wo * cout * taps * taps * cin,
                 nbytes * (n * hh * ww * cin + n * ho * wo * cout
                           + taps * taps * cin * cout)
                 + (4.0 * cout if bias else 0.0), peak)


def check_conv3x3(torch, gen) -> tuple:
    """K1 at every conv shape of the path, against conv3x3_plain; then the
    folded head's four convs (K1's head 3x3 form for up1, stored
    depth-to-space, and up2; its 2x2 form for hr and last) against
    conv3x3_plain / conv2x2_s2d_plain, each with cuDNN's bf16 conv at its
    shape (padding 1 or 0) and its bound; each time the best of three
    event windows (best_ms). The head 3x3 form at up1, up2 and a ragged 1
    x 17 x 9 must also equal, in every bf16 value, K1's SAME conv with the
    bias, then F.leaky_relu in bf16, then depth-to-space (the count of
    differing values is printed). Returns K1's JSON row (conv_body, a
    shape the main path gives K1 on every trunk), the 2x2 form's (hr) and
    the head 3x3 form's (up2)."""
    import torch.nn.functional as F
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv2x2_s2d, conv2x2_s2d_plain, conv3x3, conv3x3_head,
        conv3x3_plain, d2s as depth_to_space, pack_conv2x2_weights,
        pack_conv3x3_weights)

    n, h, w = TILE_BATCH
    result = {}
    # (label, N, H, W, Cin, Cout, bias, lrelu): conv_first, the fused
    # trunk's five convs w0..w4, conv_body, the head at 2x and 4x,
    # conv_last.
    shapes = [("conv_first 12->64", n, h, w, 12, 64, True, False),
              ("trunk w0 64->192", n, h, w, 64, 192, False, False),
              ("trunk w1 32->160", n, h, w, 32, 160, False, False),
              ("trunk w2 32->128", n, h, w, 32, 128, False, False),
              ("trunk w3 32->96", n, h, w, 32, 96, False, False),
              ("trunk w4 32->64", n, h, w, 32, 64, False, False),
              ("conv_body 64->64", n, h, w, 64, 64, True, False),
              ("conv_up1 2x 64->64", n, 2 * h, 2 * w, 64, 64, True, True),
              ("conv_up2 4x 64->64", n, 4 * h, 4 * w, 64, 64, True, True),
              ("conv_last 4x 64->3", n, 4 * h, 4 * w, 64, 3, True, False),
              # SwinIR-M x4 on one 268^2 tile padded to 272^2: conv_first,
              # the RSTB convs and conv_after_body, conv_before_upsample.
              ("swinir conv_first 3->180", *SWIN_TILE, 3, 180, True, False),
              ("swinir rstb 180->180", *SWIN_TILE, 180, 180, True, False),
              ("swinir before_up 180->64", *SWIN_TILE, 180, 64, True, True)]
    k1_err = 0.0
    for label, nn_, hh, ww, cin, cout, bias, act in shapes:
        x = _rnd(torch, gen, nn_, hh, ww, cin)
        wt = _rnd(torch, gen, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        b = (_rnd(torch, gen, cout, scale=0.1, dtype=torch.float32)
             if bias else None)
        # Packed once, as the model does at build; timed without packing.
        wpk = pack_conv3x3_weights(wt)
        got = conv3x3(x, wt, b, act, packed=wpk)
        ref = conv3x3_plain(x, wt, b, act)
        d, r = rel_err(got, ref)
        ms = best_ms(lambda: conv3x3(x, wt, b, act, packed=wpk))
        pms = best_ms(lambda: conv3x3_plain(x, wt, b, act))
        # For scale only: the library's bf16 conv (cuDNN, channels_last).
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = b.to(torch.bfloat16) if bias else None
        cms = best_ms(lambda: F.conv2d(xc, wc, bc, padding=1))
        pix = nn_ * hh * ww
        bms, by = bound(2.0 * pix * cout * 9 * cin,
                        2.0 * (pix * (cin + cout) + 9 * cin * cout)
                        + (4.0 * cout if bias else 0.0))
        log(f"K1 conv3x3 {label} {tuple(x.shape)}: max_abs_err {d:.6g} "
            f"rel {r:.3g} (tol {TOL_KERNEL}) kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms cuDNN bf16 conv {cms:.4f} ms bound "
            f"{bms:.4f} ms ({by}); kernel/cuDNN {ms / cms:.3f}, "
            f"bound/kernel {bms / ms:.3f}")
        if not r <= TOL_KERNEL:
            raise AssertionError(f"K1 {label}: rel err {r} > {TOL_KERNEL}")
        k1_err = max(k1_err, d)
        if label.startswith("conv_body"):
            result = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                      "bound_by": by, "library_ms": cms}
        del x, got, ref
    head, head3, errs, sums = {}, {}, [0.0, 0.0], [0.0, 0.0, 0.0]
    unequal = {}

    def composition(x, wt, b, wsame, d2s):
        """K1's SAME conv with the bias, then LeakyReLU in bf16, then
        depth-to-space: what the head 3x3 form equals bit for bit."""
        y = F.leaky_relu(conv3x3(x, wt, b, False, packed=wsame), 0.2)
        return depth_to_space(y) if d2s else y

    for (label, taps, (ah, bh), (aw, bw), cin, cout, act, pad, mask,
         d2s) in HEAD_SHAPES:
        hh, ww = ah * h + bh, aw * w + bw
        x = _rnd(torch, gen, n, hh, ww, cin)
        wt = _rnd(torch, gen, taps, taps, cin, cout,
                  scale=(2.0 / (taps * taps * cin)) ** 0.5)
        b = _rnd(torch, gen, cout, scale=0.1, dtype=torch.float32)
        if taps == 3:
            wpk = pack_conv3x3_weights(wt, head=True)
            run = (lambda: conv3x3_head(x, wt, b, act, packed=wpk, d2s=d2s,
                                        round_first=True))
            plain = lambda: conv3x3_plain(x, wt, b, act, d2s, True)
            unequal[label] = int((run().view(torch.int16) != composition(
                x, wt, b, pack_conv3x3_weights(wt), d2s).view(
                torch.int16)).sum())
        else:
            wpk = pack_conv2x2_weights(wt)
            run = lambda: conv2x2_s2d(x, wt, b, act, pad, mask, d2s,
                                      packed=wpk)
            plain = lambda: conv2x2_s2d_plain(x, wt, b, act, pad, mask, d2s)
        got, ref = run(), plain()
        d, r = rel_err(got, ref)
        ms, pms = best_ms(run), best_ms(plain)
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = b.to(torch.bfloat16)
        cms = best_ms(lambda: F.conv2d(xc, wc, bc, padding=pad))
        bms, by = conv_bound(n, hh, ww, taps, cin, cout, pad, 2)
        for i, t in enumerate((ms, pms, cms)):
            sums[i] += t
        log(f"K1 {'2x2 form' if taps == 2 else 'head 3x3 form'} {label} "
            f"{tuple(x.shape)} -> {tuple(got.shape)}: max_abs_err {d:.6g} "
            f"rel {r:.3g} (tol {TOL_KERNEL}) kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms cuDNN bf16 conv {cms:.4f} ms bound {bms:.4f} ms "
            f"({by}); kernel/cuDNN {ms / cms:.3f}, bound/kernel "
            f"{bms / ms:.3f}" + (f"; bf16 values unlike K1's SAME conv + "
                                 f"LeakyReLU{' + d2s' if d2s else ''}: "
                                 f"{unequal[label]} of {got.numel()}"
                                 if taps == 3 else ""))
        if not (r <= TOL_KERNEL and got.shape == ref.shape):
            raise AssertionError(f"K1 {label}: rel err {r} > {TOL_KERNEL}")
        errs[taps == 2] = max(errs[taps == 2], d)
        row = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
               "library_ms": cms}
        if label.startswith("head hr"):
            head = row
        if label.startswith("head up2"):
            head3 = row
        del x, got, ref
    log(f"K1 folded head, four convs one at a time: kernels {sums[0]:.4f} ms,"
        f" plain {sums[1]:.4f} ms, cuDNN {sums[2]:.4f} ms")
    # The persistent walk's edges: 5 tiles of 4 x 16 pixels over 3 blocks
    # an N tile, a ragged row and column, with and without depth-to-space.
    for d2s in (True, False):
        x = _rnd(torch, gen, 1, 17, 9, 64)
        wt = _rnd(torch, gen, 3, 3, 64, 256, scale=(2.0 / 576) ** 0.5)
        b = _rnd(torch, gen, 256, scale=0.1, dtype=torch.float32)
        got = conv3x3_head(x, wt, b, True, d2s=d2s, round_first=True)
        label = f"ragged 1x17x9 64->256{' d2s' if d2s else ''}"
        unequal[label] = int((got.view(torch.int16) != composition(
            x, wt, b, pack_conv3x3_weights(wt), d2s).view(torch.int16)).sum())
        d, r = rel_err(got, conv3x3_plain(x, wt, b, True, d2s, True))
        errs[0] = max(errs[0], d)
        log(f"K1 head 3x3 form {label} {tuple(x.shape)} -> "
            f"{tuple(got.shape)}: max_abs_err {d:.6g} rel {r:.3g} (tol "
            f"{TOL_KERNEL}); bf16 values unlike K1's SAME conv + LeakyReLU"
            f"{' + d2s' if d2s else ''}: {unequal[label]} of {got.numel()}")
        if not r <= TOL_KERNEL:
            raise AssertionError(f"K1 head 3x3 {label}: rel err {r}")
    if any(unequal.values()):
        raise AssertionError(f"K1's head 3x3 form differs from K1's SAME "
                             f"conv + LeakyReLU (+ d2s): {unequal}")
    result["max_abs_err"] = k1_err
    head["max_abs_err"] = errs[1]
    head3["max_abs_err"] = errs[0]
    return result, head, head3


def check_rdb_fused(torch, gen) -> dict:
    """K2 on a tile batch against rdb_fused_plain, by device time with the
    wall a call beside it, and its yardstick: the composition of the
    default trunk's RDB (``FusedRDB._composition``: five K1 convs and the
    elementwise assembly, the fused trunk's RDB until the K1 step) on the
    same batch and weights, with the five K1 convs alone.

    The weights (std 0.05, bias std 0.1) are large enough that each conv
    of the dense chain moves the output by more than the bar: a kernel
    that drops one stage's conv or one slot add fails. At the trained-like
    scale of init_rrdbnet (0.1 x Kaiming) the whole dense branch would sit
    under the bar and such a kernel would pass. The error is also printed
    against the size of the residual branch 0.2 * x5 alone.
    """
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv3x3)
    from neural_enhanced_super_resolution_torch.kernels.rdb_fused import (
        rdb_fused, rdb_fused_plain)
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)

    n, h, w = TILE_BATCH
    x = _rnd(torch, gen, n, h, w, 64, scale=0.5)
    ws = [_rnd(torch, gen, 3, 3, cin, cout, scale=0.05)
          for cin, cout in ((64, 192), (32, 160), (32, 128), (32, 96),
                            (32, 64))]
    bb = _rnd(torch, gen, 192, scale=0.1, dtype=torch.float32)
    trunk = FusedRDB(ws, bb, torch.bfloat16, "cuda", kernel=False)
    packed = trunk.packed()
    ref = rdb_fused_plain(x, ws, bb)
    d, r = rel_err(rdb_fused(x, ws, bb, packed=packed), ref)
    branch = (ref.float() - x.float()).abs().max().item()
    # Packed once, as the model does at build; timed without packing.
    ms = device_ms(lambda: rdb_fused(x, ws, bb, packed=packed))
    wms = wall_ms(lambda: rdb_fused(x, ws, bb, packed=packed))
    pms = device_ms(lambda: rdb_fused_plain(x, ws, bb), reps=3)
    yms = device_ms(lambda: trunk._composition(x))
    ywms = wall_ms(lambda: trunk._composition(x))
    x32 = x[..., :32].contiguous()
    cms = device_ms(lambda: [conv3x3(x if i == 0 else x32, wi, packed=pi)
                             for i, (wi, pi) in enumerate(zip(ws, packed))])
    # The RDB's own work: its five convs' operations (not the kernel's
    # halo recompute); x in and out, the weights and biases once.
    pix = n * h * w
    bms, by = bound(2.0 * pix * 9 * sum(t.shape[2] * t.shape[3] for t in ws),
                    2.0 * (2 * pix * 64 + sum(t.numel() for t in ws))
                    + 4.0 * 192)
    log(f"K2 rdb_fused {tuple(x.shape)}: max_abs_err {d:.6g} rel {r:.3g} "
        f"(tol {TOL_KERNEL}; max|ref| {ref.float().abs().max().item():.4g},"
        f" max|0.2*x5| {branch:.4g}, err/branch {d / branch:.3g}) "
        f"device ms: kernel {ms:.4f} plain {pms:.4f} bound {bms:.4f} ({by});"
        f" bound/kernel {bms / ms:.3f}; wall ms a call: kernel {wms:.4f}")
    log(f"K2 yardstick, the default trunk's RDB as a composition "
        f"(FusedRDB._composition: five K1 convs + elementwise assembly) on "
        f"the same batch: device "
        f"{yms:.4f} ms (the five K1 convs alone {cms:.4f}), wall "
        f"{ywms:.4f} ms a call; kernel/yardstick {ms / yms:.3f} by device "
        "time; no single PyTorch call computes a whole RDB")
    if not r <= TOL_KERNEL:
        raise AssertionError(f"K2: rel err {r} > {TOL_KERNEL}")
    return {"ms": ms, "plain_ms": pms, "max_abs_err": d, "bound_ms": bms,
            "bound_by": by, "library_ms": None}


def check_flash_attention(torch, gen) -> dict:
    """K3 against flash_attention_plain at every FLASH_SHAPES shape.

    q and k are drawn with std 2, so the scores have std 4 and each row's
    softmax is peaked: with std-1 inputs the softmax over thousands of keys
    is nearly flat, the output is about mean(v), and a kernel that ignored
    the scores would pass. The error is taken against max|ref| with no
    floor. One more case puts every real score at -2048 on a ragged Skv: a
    key past Skv that escaped the bound check (a zero row, score 0) would
    take all the weight. All shapes are measured before any failure is
    raised, so a faulty kernel's readings are all printed.
    """
    from neural_enhanced_super_resolution_torch.kernels.attention import (
        flash_attention, flash_attention_plain)

    cases = []
    for label, b, h, sq, skv, d in FLASH_SHAPES:
        cases.append((label, _rnd(torch, gen, b, h, sq, d, scale=2.0),
                      _rnd(torch, gen, b, h, skv, d, scale=2.0),
                      _rnd(torch, gen, b, h, skv, d)))
    bh, sq, skv, d = (1, 2), 100, 100, 64
    cases.append(("padded keys, scores -2048",
                  torch.full((*bh, sq, d), 16.0, device="cuda",
                             dtype=torch.bfloat16),
                  torch.full((*bh, skv, d), -16.0, device="cuda",
                             dtype=torch.bfloat16),
                  _rnd(torch, gen, *bh, skv, d)))
    import torch.nn.functional as F
    worst, timed, failed = 0.0, {}, []
    for label, q, k, v in cases:
        got = flash_attention(q, k, v)
        ref = flash_attention_plain(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        # Device time (kernel durations) and the wall a call, each beside
        # PyTorch's fused attention on the same tensors (for scale only).
        ms = device_ms(lambda: flash_attention(q, k, v))
        wms = wall_ms(lambda: flash_attention(q, k, v))
        pms = device_ms(lambda: flash_attention_plain(q, k, v), reps=3)
        sms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        swms = wall_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        (b, hh, sq, d), skv = q.shape, k.shape[2]
        bms, by = bound(4.0 * b * hh * sq * skv * d,
                        2.0 * b * hh * d * (2 * sq + 2 * skv))
        log(f"K3 flash_attention {label} q {tuple(q.shape)} Skv "
            f"{skv}: max_abs_err {err:.6g} rel {rel:.3g} (tol "
            f"{TOL_FLASH}, of max|ref| {ref.float().abs().max().item():.4g})"
            f" device ms: kernel {ms:.4f} SDPA {sms:.4f} plain {pms:.4f} "
            f"bound {bms:.4f} ({by}); kernel/SDPA {ms / sms:.3f}, "
            f"bound/kernel {bms / ms:.3f}; wall ms a call: kernel {wms:.4f} "
            f"SDPA {swms:.4f}")
        if not rel <= TOL_FLASH:
            failed.append(f"{label}: rel {rel}")
        worst = max(worst, err)
        timed[label] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                        "bound_by": by, "library_ms": sms}
        del got, ref
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K3 disagrees with its plain version: {failed}")
    return dict(timed["unet 64^2 d64"], max_abs_err=worst)


def check_head(torch, model, x, tol: float, name: str) -> dict:
    """The folded head of ``model`` on its trunk's output for ``x``:
    against the head on its plain versions (``tol``) and against the stock
    head on the same output (printed); its launches a call: two of K1's
    (or K1f's) head 3x3 form (conv3x3_head, conv3x3_head_f32) and two of
    its 2x2 form, by the wrappers' counts, and no other kernel or copy on
    the card (no PyTorch op but
    its outputs' allocations, ``aten_ops``); its time (CUDA events over 5 calls, the head's
    calls being device work alone) in turns with the stock head's (folded,
    stock, stock, folded)."""
    from neural_enhanced_super_resolution_torch.kernels import (
        conv2x2_s2d, conv2x2_s2d_f32, conv3x3_head, conv3x3_head_f32)
    f32 = model.dtype == torch.float32
    k3, k2 = ((conv3x3_head_f32, conv2x2_s2d_f32) if f32
              else (conv3x3_head, conv2x2_s2d))
    head = model.folded_head
    with torch.no_grad():
        feat = model.conv_first(x.to(model.dtype))
        feat = feat + model.conv_body(model.body_forward(feat))
        before = (k3.launches, k2.launches)
        out = head(feat)
        launches = (k3.launches - before[0], k2.launches - before[1])
        d, r = rel_err(out, head(feat, plain=True))
        ds, rs = rel_err(out, model.stock_head(feat))
        # Besides its four launches the folded head dispatches nothing
        # but its outputs' allocations: no copy, no depth-to-space.
        ops = aten_ops(lambda: head(feat))
        stock_ops = aten_ops(lambda: model.stock_head(feat))
        foreign = [op for op in ops if not op.startswith("aten.empty")]
        runs = {"folded": lambda: head(feat),
                "stock": lambda: model.stock_head(feat)}
        ms = {"folded": [], "stock": []}
        for key in ("folded", "stock", "stock", "folded"):
            ms[key].append(cuda_ms(runs[key], reps=5))
    log(f"folded head ({model.trunk} trunk, {str(model.dtype)[6:]}) on "
        f"{tuple(feat.shape)} -> {tuple(out.shape)}: max_abs_err {d:.6g} rel "
        f"{r:.3g} vs its plain versions (tol {tol}); vs the stock head "
        f"max_abs_err {ds:.6g} rel {rs:.3g}; launches a call "
        f"{'K1f' if f32 else 'K1'} head 3x3 form {launches[0]}, 2x2 form "
        f"{launches[1]}; "
        f"PyTorch ops a call {sorted(set(ops))} (the stock head's "
        f"{sorted(set(stock_ops))}); ms (CUDA events) in turns (folded, "
        f"stock, stock, folded) {ms} on {name}")
    if not (r <= tol and launches == (2, 2) and not foreign
            and torch.isfinite(out).all()):
        raise AssertionError(f"folded head ({model.trunk}): rel err {r}, "
                             f"launches {launches}, PyTorch ops {ops}")
    return ms


def check_forward(torch, gen, sd, name: str) -> None:
    """Both trunks' full-width forward against the plain trunk, and the
    folded head on each (check_head).

    At init_rrdbnet's scale each RDB's dense branch is a few percent of its
    output, so this holds the model's wiring (head, trunk order, weights),
    not each RDB's dense chain: a K2 that drops one conv passes here and
    fails check_rdb_fused.
    """
    from neural_enhanced_super_resolution_torch.kernels import (
        conv2x2_s2d, conv3x3, conv3x3_head, conv3x3_rdb, rdb_fused)
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig)

    cfg = RRDBNetConfig(**ARCH)
    n, h, w = TILE_BATCH
    x = torch.rand((n, h, w, 12), generator=gen).to("cuda")
    mp_out = n * (4 * h) * (4 * w) / 1e6
    ref = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "fused")(x, plain=True)
    torch.cuda.empty_cache()
    counters = (conv3x3, conv3x3_head, conv2x2_s2d, rdb_fused, conv3x3_rdb)
    # K1, its head 3x3 and 2x2 forms, K2 and the K1 step a forward
    wants = {"fused": (K1_FOLDED, K1_HEAD, K1_2X2, 0, RDB_STEPS),
             "dform": (K1_FOLDED, K1_HEAD, K1_2X2, 3 * cfg.num_block, 0)}
    for trunk in ("fused", "dform"):
        model = RRDBNet(cfg, sd, torch.bfloat16, "cuda", trunk)
        before = [c.launches for c in counters]
        out = model(x)
        launches = tuple(c.launches - b for c, b in zip(counters, before))
        d, r = rel_err(out, ref)
        ms = cuda_ms(lambda: model(x), reps=3)
        log(f"forward {trunk} trunk "
            f"({'K1 step+K1' if trunk == 'fused' else 'K2+K1'})"
            f" 12ch x4 nf64 nb23 gc32 on {tuple(x.shape)}: max_abs_err "
            f"{d:.6g} rel {r:.3g} vs plain trunk (tol {TOL_FORWARD}); "
            f"launches K1, head 3x3 form, 2x2 form, K2, K1 step {launches} "
            f"(want "
            f"{wants[trunk]}); "
            f"{ms:.2f} ms/batch = {mp_out / (ms / 1e3):.3f} MP_out/s "
            f"(output incl. halo) on {name}")
        if not (r <= TOL_FORWARD and torch.isfinite(out).all()
                and launches == wants[trunk]):
            raise AssertionError(f"forward {trunk}: rel err {r}, launches "
                                 f"{launches}")
        del out
        check_head(torch, model, x, TOL_FORWARD, name)
        del model
        torch.cuda.empty_cache()
    plain = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "fused")
    pms = cuda_ms(lambda: plain(x, plain=True), reps=1)
    log(f"forward plain trunk: {pms:.2f} ms/batch = "
        f"{mp_out / (pms / 1e3):.3f} MP_out/s on {name}")


def write_segformer_snapshot(torch) -> str:
    """SegFormer-b0 (the published config, 150 labels) with seeded weights,
    as an HF-layout snapshot."""
    from neural_enhanced_super_resolution_torch.models.segformer import (
        SegFormerConfig, write_synthetic_segformer)
    return write_synthetic_segformer(
        os.path.join(OUT, "segformer_b0_synthetic"), SegFormerConfig(),
        torch.Generator().manual_seed(SEED))


def check_segformer(torch, snap: str, name: str) -> None:
    """SegFormer-b0 at 1 x 512 x 512 on the card in bf16 against the same
    forward on the CPU in float32: logits by rel_err, bar TOL_FORWARD."""
    from neural_enhanced_super_resolution_torch.models.segformer import (
        load_segformer)
    x = torch.randn((1, SEG_INPUT, SEG_INPUT, 3),
                    generator=torch.Generator().manual_seed(SEED + 5))
    with torch.no_grad():
        ref = load_segformer(snap, "float32", "cpu").model(x)
        model = load_segformer(snap, "bfloat16", "cuda").model
        xc = x.to("cuda")
        got = model(xc)
        d, r = rel_err(got.cpu(), ref)
        dev = device_ms(lambda: model(xc))
        wms = wall_ms(lambda: model(xc))
        launches = launches_per_call(lambda: model(xc))
    log(f"SegFormer-b0 1x{SEG_INPUT}x{SEG_INPUT} bf16 card vs CPU f32: "
        f"logits {tuple(got.shape)} max_abs_err {d:.6g} rel {r:.3g} (tol "
        f"{TOL_FORWARD}; max|ref| {ref.abs().max().item():.4g}); device "
        f"{dev:.4f} ms, wall {wms:.4f} ms a call, {launches:.0f} launches a "
        f"call on {name}")
    if not (r <= TOL_FORWARD and torch.isfinite(got).all()):
        raise AssertionError(f"SegFormer-b0: rel err {r}")


def _noisy_images(np, n, h, w, seed):
    """Smooth seeded content (upsampled noise) with Gaussian noise, std 12."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (n, h // 16 + 1, w // 16 + 1, 3))
    img = np.kron(small, np.ones((1, 16, 16, 1)))[:, :h, :w]
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def nlmeans_agreement(lab, ref_lab, rgb, ref_rgb) -> tuple:
    """NL-means on the card against the CPU. The uint8 Lab of the joint
    pass: max|diff| <= 1 on <= 1e-3 of the values (a float32 weighted
    mean within an ulp of .5 rounds either way). The RGB output: <= 1e-3
    of the values differ, and by <= 1 wherever the pixel's Lab agrees (one
    Lab level spans up to ~5 linear-light RGB levels, so a Lab flip shows
    as that). Returns (ok, summary)."""
    dlab = (lab.int() - ref_lab.int()).abs()
    drgb = (rgb.int() - ref_rgb.int()).abs().reshape(dlab.shape)
    same_lab = (dlab == 0).all(-1, keepdim=True)
    vals = [dlab.max().item(), (dlab > 0).float().mean().item(),
            drgb.max().item(), (drgb > 0).float().mean().item(),
            (drgb * same_lab).max().item()]
    ok = (vals[0] <= 1 and vals[1] <= 1e-3 and vals[3] <= 1e-3
          and vals[4] <= 1)
    return ok, (f"Lab max|diff| {vals[0]} on a share {vals[1]:.3g} (bar 1 "
                f"on 1e-3); RGB max|diff| {vals[2]} on a share {vals[3]:.3g}"
                f" (bar 1e-3), {vals[4]} where the Lab agrees (bar 1)")


def _nlm_case(torch, np, kind: str, shape: tuple, seed: int):
    """The kernel's float32 input for one check_nlmeans case on the card,
    and the uint8 image behind it (None for the float case): the linear
    Lab of seeded noisy images as _denoised_lab makes it, or a float image
    of the same content."""
    from neural_enhanced_super_resolution_torch.ops.color import rgb_to_lab
    img = _noisy_images(np, *shape, seed)
    if kind == "one field, sigma 6":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(np.clip(img + rng.uniform(
            -0.5, 0.5, img.shape), 0, 255).astype(np.float32)).to(
                "cuda"), None
    x = torch.from_numpy(img).to("cuda")
    return rgb_to_lab(x.flip(-1), srgb=False).float().contiguous(), x


# check_nlmeans' cases: (label, kind, (B, H, W)).
NLM_CASES = [("32-tile chunk", "Lab", NLM_BATCH),
             ("768x576 image", "Lab", (1, *NLM_IMAGE)),
             ("ragged batch", "Lab", (2, 37, 23)),
             ("9x11 image (reflects twice)", "Lab", (1, 9, 11)),
             ("float image", "one field, sigma 6", (1, 96, 80))]


def check_nlmeans(torch, np, name: str) -> dict:
    """NL-means' kernel (csrc/nlmeans.cu, nl_means_fields) against its
    plain version on the card at NLM_CASES: the Lab joint pass (h =
    h_color = 5, denoise_level 0.5) on one 32-tile chunk of the denoise
    path, a whole 768x576 image, a ragged batch and an image narrower than
    the 13-pixel reach, and the one-field form (h 9, sigma 6) on a float
    image. Bars: float32 max|kernel - plain| <= TOL_NLM max|plain| (the
    offsets summed in another order); for the Lab cases the rounded uint8
    Lab and the RGB output by nlmeans_agreement. Each case prints the
    kernel's time a call and the plain version's (CUDA events), the
    kernel's launches a call (its counter, and the PyTorch ops a call
    dispatches: allocations only), the bound max(FLOPs / PEAK_FP32_FLOPS,
    bytes / PEAK_HBM_BYTES) (FLOPs = offsets x pixels x operations an
    offset, bytes = the float32 input read once and output written once)
    and beside it the SFU floor of the exps. Then the denoise itself (nl_means_colored, on the kernel)
    against the same function on the CPU: the chunk's first tile and the
    whole image. Returns the chunk's row of the kernels line."""
    from neural_enhanced_super_resolution_torch.kernels import (
        nl_means_fields, nl_means_fields_plain)
    from neural_enhanced_super_resolution_torch.ops.blur import saturate_like
    from neural_enhanced_super_resolution_torch.ops.nlmeans import (
        _denoised_lab, _lab_to_output, nl_means_colored)

    failed, row = [], None
    for i, (label, kind, shape) in enumerate(NLM_CASES):
        x, img = _nlm_case(torch, np, kind, shape, SEED + 20 + i)
        lab = kind == "Lab"
        fields = ((((0,), 5.0), ((1, 2), 5.0)) if lab
                  else (((0, 1, 2), 9.0),))
        sigma = 0.0 if lab else 6.0

        def kern():
            return nl_means_fields(x, fields, sigma)

        def plain():
            return nl_means_fields_plain(x, fields, sigma, 7, 21)

        launched = nl_means_fields.launches
        got = kern()
        ref = plain()
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ok = (nl_means_fields.launches == launched + 1
              and tuple(got.shape) == tuple(x.shape)
              and bool(torch.isfinite(got).all()) and rel <= TOL_NLM)
        summary = f"float32 max|err| {err:.3g}, rel {rel:.3g} (bar {TOL_NLM})"
        if lab:
            lab_k, lab_p = (saturate_like(t, torch.uint8) for t in (got, ref))
            agree, text = nlmeans_agreement(
                lab_k.cpu(), lab_p.cpu(),
                _lab_to_output(lab_k, img.shape).cpu(),
                _lab_to_output(lab_p, img.shape).cpu())
            ok, summary = ok and agree, summary + "; " + text
        pix = x.numel() // x.shape[-1]
        ops = NLM_OPS_PER_OFFSET if lab else NLM_OPS_ONE_FIELD
        bms, by = bound(NLM_OFFSETS * pix * ops, 2.0 * 4 * x.numel(),
                        PEAK_FP32_FLOPS)
        sfu_ms = NLM_OFFSETS * pix * (2 if lab else 1) / PEAK_SFU_OPS * 1e3
        # CUDA events: torch.profiler lost this kernel's events late in a
        # full run (0 launches, part of the time). A call is one launch,
        # and the PyTorch ops it dispatches are allocations only.
        dev = best_ms(kern, tries=3, reps=5)
        plain_ms = cuda_ms(plain, reps=1)
        launched = nl_means_fields.launches
        dispatched = sorted(set(aten_ops(kern)))
        per_call = nl_means_fields.launches - launched
        plain_calls = launches_per_call(plain, reps=1)
        ok = ok and per_call == 1 and all(
            op.startswith("aten.empty") for op in dispatched)
        log(f"NL-means kernel {label} {kind} {tuple(x.shape)}: {summary}; "
            f"{dev:.4f} ms a call (CUDA events), {per_call} launch a call "
            f"(the counter; PyTorch ops dispatched {dispatched}); plain "
            f"{plain_ms:.3f} ms (events) in {plain_calls:.0f} launches "
            f"(torch.profiler) ({plain_ms / dev:.1f}x); bound {bms:.4f} ms "
            f"({by}: {ops} ops "
            f"x {NLM_OFFSETS} offsets x {pix} px at "
            f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32), bound/device "
            f"{bms / dev:.4f}; SFU floor of the exps {sfu_ms:.4f} ms "
            f"({'the FLOP bound sets it' if bms >= sfu_ms else 'the SFUs set it'}"
            f") on {name}")
        if not ok:
            failed.append(f"{label}: {summary}")
        if label == "32-tile chunk":
            row = {"max_abs_err": err, "ms": dev, "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by, "library_ms": None}
        del x, got, ref
        torch.cuda.empty_cache()

    cases = [("tile batch", _noisy_images(np, *NLM_BATCH, SEED + 6), 1),
             ("whole image", _noisy_images(np, 1, *NLM_IMAGE, SEED + 7)[0],
              None)]
    for label, img, cpu_tiles in cases:
        x = torch.from_numpy(img).to("cuda")
        lab = _denoised_lab(x, 5.0, 5.0)
        got = _lab_to_output(lab, x.shape).cpu()
        host = torch.from_numpy(img[:cpu_tiles] if cpu_tiles else img)
        t0 = time.perf_counter()
        ref_lab = _denoised_lab(host, 5.0, 5.0)
        ref = _lab_to_output(ref_lab, host.shape)
        cpu_s = time.perf_counter() - t0
        n = cpu_tiles or 1
        ok, summary = nlmeans_agreement(lab[:n].cpu(), ref_lab,
                                        got[:n] if cpu_tiles else got, ref)

        def fn():
            return nl_means_colored(x, h=5.0, h_color=5.0)

        launched = nl_means_fields.launches
        wms = wall_ms(fn, reps=2)
        log(f"NL-means {label} {img.shape} uint8: card (kernel) vs CPU "
            f"({'first tile' if cpu_tiles else 'whole'}, {cpu_s:.2f} s on "
            f"the CPU): {summary}; nl_means_colored wall {wms:.3f} ms a "
            f"call, {nl_means_fields.launches - launched} kernel launches "
            f"in 3 calls on {name}")
        if (tuple(got.shape) != img.shape or not ok
                or nl_means_fields.launches - launched != 3):
            failed.append(f"{label} vs CPU: {summary}")
        del x, lab, got
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"NL-means: {failed}")
    return row


def drive_product_path(torch, np, ckpt: str) -> dict:
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv2x2_s2d, conv2x2_s2d_plain, conv3x3, conv3x3_plain)
    from neural_enhanced_super_resolution_torch.kernels.rdb_fused import (
        rdb_fused, rdb_fused_plain)
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)

    base = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "esrgan_model_path": ckpt,
            "output_dir": os.path.join(OUT, "out")}
    rng = np.random.default_rng(SEED)
    inputs = {}
    for label, (hh, ww) in (("seeded_512x384", (384, 512)),
                            ("odd_301x257", (257, 301)),
                            ("small_96", (96, 96))):
        # smooth random content: upsampled noise, so ESRGAN sees structure
        small = rng.integers(0, 256, (hh // 8 + 1, ww // 8 + 1, 3),
                             dtype=np.uint8)
        img = np.kron(small, np.ones((8, 8, 1), np.uint8))[:hh, :ww]
        path = os.path.join(OUT, f"{label}.png")
        imwrite_rgb(path, img)
        inputs[label] = path
    fixture = os.path.join(ROOT, "tests", "fixtures", "test.jpeg")

    cli_cfg = os.path.join(OUT, "cli_config.json")
    with open(cli_cfg, "w") as f:
        json.dump(base, f)
    cli_out = os.path.join(OUT, "cli", "result.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", PKG, "--cli", "-i", fixture, "-c", cli_cfg,
         "-n", "1", "-o", cli_out, "-d", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    log(f"CLI subprocess: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        raise AssertionError("CLI failed:\n" + proc.stdout[-3000:]
                             + proc.stderr[-3000:])
    got = imread_rgb(cli_out)
    if got.shape != (640, 640, 3) or got.std() == 0:
        raise AssertionError(f"CLI output {got.shape} std {got.std()}")

    requests = [("K1 trunk", fixture, 1, None),
                ("K1 trunk", inputs["seeded_512x384"], 1, None),
                ("K2 trunk", inputs["odd_301x257"], 1, "dform"),
                ("K2 trunk", inputs["small_96"], 2, "dform")]
    pipes = {trunk: SuperResolutionPipeline(
        device="cuda", config=dict(base, esrgan_trunk=trunk))
        for trunk in (None, "dform")}
    for p in pipes.values():
        p._load_models()   # set-up: weights to the card before the window
        if "esrgan" not in p.models:
            raise AssertionError("ESRGAN did not load")

    conv3x3.launches = rdb_fused.launches = conv2x2_s2d.launches = 0
    conv3x3_plain.calls = rdb_fused_plain.calls = conv2x2_s2d_plain.calls = 0
    _zero_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for label, path, iters, trunk in requests:
        pipe = pipes[trunk]
        pipe.config["iterations"] = iters
        t1 = time.perf_counter()
        out_path = pipe.enhance_image(path)
        dt = time.perf_counter() - t1
        src, out = imread_rgb(path), imread_rgb(out_path)
        want = (src.shape[0] * 4 ** iters, src.shape[1] * 4 ** iters, 3)
        log(f"request {os.path.basename(path)} -n {iters} ({label}): "
            f"{src.shape[:2]} -> {out.shape[:2]} in {dt:.3f} s; "
            f"output {os.path.basename(out_path)}")
        if out.shape != want or out.std() == 0:
            raise AssertionError(f"{path}: output {out.shape} (want {want}),"
                                 f" std {out.std()}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"conv3x3": conv3x3.launches, "rdb_fused": rdb_fused.launches,
              "conv2x2_s2d": conv2x2_s2d.launches,
              "conv3x3_plain": conv3x3_plain.calls,
              "rdb_fused_plain": rdb_fused_plain.calls,
              "conv2x2_s2d_plain": conv2x2_s2d_plain.calls,
              **_step_counts()}
    log(f"product path: {len(requests)} requests in {wall:.3f} s; "
        f"counts {counts}")
    if (counts["conv3x3"] == 0 or counts["rdb_fused"] == 0
            or counts["conv2x2_s2d"] == 0 or not _steps_ran(counts)):
        raise AssertionError(f"a kernel was not launched: {counts}")
    if (counts["conv3x3_plain"] or counts["rdb_fused_plain"]
            or counts["conv2x2_s2d_plain"]):
        raise AssertionError(f"plain versions ran on the card: {counts}")
    for trunk, p in pipes.items():
        log(f"StageTimer ({trunk or 'fused'} trunk pipeline):")
        for line in p.timer.summary_lines():
            log(line)
    return counts


def check_against_cpu(torch, np, ckpt: str, seg: str | None = None) -> None:
    """The product path on a small input agrees with the same path on the
    CPU in float32 (plain versions): PSNR of the uint8 outputs. With a
    segmentation snapshot the path is the default config's without
    diffusion: NL-means denoise and segmentation before ESRGAN."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    base = {"use_diffusion": False, "esrgan_model_path": ckpt,
            "iterations": 1, "output_dir": os.path.join(OUT, "ref")}
    if seg is None:
        base.update(segment_enhancement=False, denoise_level=0)
        what = "ESRGAN"
    else:
        base["segmentation_model_path"] = seg
        what = "denoise + segmentation + ESRGAN"
    rng = np.random.default_rng(SEED + 1)
    img = np.kron(rng.integers(0, 256, (7, 7, 3), dtype=np.uint8),
                  np.ones((8, 8, 1), np.uint8))
    ref = SuperResolutionPipeline("cpu", base).enhance_array(img).astype(
        np.float64)
    for trunk in (None, "dform"):
        pipe = SuperResolutionPipeline("cuda", dict(base, esrgan_trunk=trunk))
        got = pipe.enhance_array(img).astype(np.float64)
        if seg is not None and "segmentation" not in pipe.timer.totals:
            raise AssertionError("the segmentation stage did not run")
        mse = float(np.mean((got - ref) ** 2))
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
        log(f"small input 56x56, {what} ({trunk or 'fused'} trunk, bf16 "
            f"card) vs CPU float32 plain: PSNR {psnr:.2f} dB, max diff "
            f"{np.abs(got - ref).max():.0f} (bar 30 dB)")
        if got.shape != ref.shape or not psnr >= 30.0:
            raise AssertionError(f"small-input agreement: PSNR {psnr}")


@contextlib.contextmanager
def plain_attention():
    """Route attention_auto to flash_attention_plain: the reference forward
    a K3 forward is held against (outside the counted paths)."""
    from neural_enhanced_super_resolution_torch.kernels import attention
    kernel = attention.flash_attention
    attention.flash_attention = attention.flash_attention_plain
    try:
        yield
    finally:
        attention.flash_attention = kernel


def write_sd_snapshot(torch) -> str:
    """The SD x4 upscaler at its published widths, seeded fan-in weights in
    bf16, as a diffusers-layout snapshot."""
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        CLIPTextConfig, UNetConfig, VAEConfig)
    from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
        write_synthetic_snapshot)
    path = os.path.join(OUT, "sd_x4_synthetic")
    t0 = time.perf_counter()
    write_synthetic_snapshot(
        path, (UNetConfig(), VAEConfig(), CLIPTextConfig()),
        torch.Generator("cuda").manual_seed(SEED), torch.bfloat16)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)
    log(f"SD x4 synthetic snapshot (full width, fan-in init, bf16): "
        f"{size / 1e9:.3f} GB written in {time.perf_counter() - t0:.2f} s")
    return path


def check_diffusion_forward(torch, snap: str, name: str) -> None:
    """One full-width UNet pass (batch 1, 7x128x128, one timestep, a
    77-token context) and one VAE decode of a 128^2 latent, with K3 against
    the same forward on the plain attention (TF32 off). Bar: TOL_SD of
    max|ref|."""
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        load_upscale_pipeline, unet_forward, vae_decode)
    t0 = time.perf_counter()
    pipe = load_upscale_pipeline(snap, device="cuda")
    log(f"SD x4 snapshot loaded to the card in {time.perf_counter() - t0:.2f}"
        " s")
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    x = torch.randn((1, 128, 128, 7), generator=gen, device="cuda")
    ctx = pipe.encode_prompt(PROMPT)[1:]
    labels = torch.tensor([20], device="cuda")
    lat = torch.randn((1, 128, 128, 4), generator=gen, device="cuda") / \
        pipe.vae.cfg.scaling_factor
    runs = {
        "UNet pass 1x128x128x7, t 500": lambda: unet_forward(
            pipe.unet, x, 500, ctx, labels),
        "VAE decode 1x128x128x4 -> 512^2": lambda: vae_decode(pipe.vae, lat)}
    for label, fn in runs.items():
        got = fn()
        with plain_attention():
            ref = fn()
            pms = cuda_ms(fn, reps=3)
            pdev = device_ms(fn, reps=2)
        ms = cuda_ms(fn, reps=3)
        dev = device_ms(fn, reps=2)
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        log(f"SD x4 {label}: max_abs_err {err:.6g} rel {rel:.3g} vs plain "
            f"attention (tol {TOL_SD}; max|ref| "
            f"{ref.abs().max().item():.4g}); with K3 {ms:.2f} ms "
            f"(device {dev:.2f} ms), plain attention {pms:.2f} ms (device "
            f"{pdev:.2f} ms) on {name}")
        if not (rel <= TOL_SD and torch.isfinite(got).all()):
            raise AssertionError(f"SD x4 {label}: rel err {rel}")
    del pipe
    torch.cuda.empty_cache()


def _sd_counts():
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3, conv3x3_plain, flash_attention, flash_attention_plain)
    return {"conv3x3": conv3x3.launches,
            "flash_attention": flash_attention.launches,
            "conv3x3_plain": conv3x3_plain.calls,
            "flash_attention_plain": flash_attention_plain.calls,
            **_step_counts()}


def _check_sd_request(np, label, src, out, iters, counts, runs, stages):
    """What every diffusion request must show: 4x per iteration, a picture
    that is neither constant nor saturated everywhere, K3 launched exactly
    SD_ATTN_PER_PASS x 2 (split CFG) x steps + 1 (VAE) times per diffusion
    run, K1 and the K1 step launched, no plain version, the diffusion
    sub-stages timed."""
    want = (src.shape[0] * 4 ** iters, src.shape[1] * 4 ** iters, 3)
    k3 = runs * (SD_ATTN_PER_PASS * 2 * SD_STEPS + 1)
    saturated = float(np.mean((out == 0) | (out == 255)))
    log(f"{label}: {src.shape[:2]} -> {out.shape[:2]}, output std "
        f"{out.std():.2f}, saturated share {saturated:.3f}; counts {counts}"
        f" (K3 expected {k3})")
    problems = []
    if out.shape != want or out.std() == 0 or saturated == 1.0:
        problems.append(f"output {out.shape} (want {want}), std {out.std()}")
    if (counts["flash_attention"] != k3 or counts["conv3x3"] == 0
            or not _steps_ran(counts)):
        problems.append(f"launches {counts}, K3 expected {k3}")
    if counts["flash_attention_plain"] or counts["conv3x3_plain"]:
        problems.append(f"plain versions ran on the card: {counts}")
    missing = {"diffusion/clip", "diffusion/denoise", "diffusion/vae"} - \
        set(stages)
    if missing:
        problems.append(f"StageTimer lacks {sorted(missing)}")
    if problems:
        raise AssertionError(f"{label}: {problems}")


def drive_diffusion_path(torch, np, ckpt: str, snap: str) -> dict:
    """ESRGAN (K1) and the SD x4 upscaler (K3) ensembled through the product
    path: the CLI at 128x128 -n 1, then enhance_image on a ragged 104x72
    input -n 2 with a 0.05 MP diffusion cap (iteration 2 skips diffusion and
    takes the streamed ESRGAN final)."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3, conv3x3_plain, flash_attention, flash_attention_plain)
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)

    base = {"use_diffusion": True, "diffusion_model_path": snap,
            "segment_enhancement": False, "denoise_level": 0,
            "esrgan_model_path": ckpt,
            "output_dir": os.path.join(OUT, "sd_out")}
    rng = np.random.default_rng(SEED + 3)
    paths = {}
    for label, (hh, ww) in (("sd_128", (128, 128)), ("sd_104x72", (72, 104))):
        small = rng.integers(0, 256, (hh // 8 + 1, ww // 8 + 1, 3),
                             dtype=np.uint8)
        paths[label] = os.path.join(OUT, f"{label}.png")
        imwrite_rgb(paths[label],
                    np.kron(small, np.ones((8, 8, 1), np.uint8))[:hh, :ww])
    total = dict.fromkeys(_sd_counts(), 0)

    cli_cfg = os.path.join(OUT, "sd_cli_config.json")
    with open(cli_cfg, "w") as f:
        json.dump(base, f)
    cli_out = os.path.join(OUT, "sd_cli", "result.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_COUNTED, "--cli", "-i", paths["sd_128"],
         "-c", cli_cfg, "-n", "1", "-o", cli_out, "-d", "cuda", "-p", PROMPT,
         "--bench"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"SD CLI subprocess: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        raise AssertionError("SD CLI failed:\n" + proc.stdout[-3000:]
                             + proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    counts = json.loads(next(line for line in lines
                             if line.startswith("COUNTS "))[7:])
    log("SD CLI StageTimer (--bench):")
    stages = []
    for line in lines:
        if line.startswith("  ") and "s (" in line:
            log(line)
            stages.append(line.split()[0])
    _check_sd_request(np, "SD CLI 128x128 -n 1", imread_rgb(paths["sd_128"]),
                      imread_rgb(cli_out), 1, counts, 1, stages)
    cli_counts = counts
    for key in total:
        total[key] += counts[key]

    pipe = SuperResolutionPipeline("cuda", dict(
        base, iterations=2, diffusion_max_megapixels=0.05))
    pipe._load_models()   # set-up: weights to the card before the window
    if set(pipe.models) != {"esrgan", "diffusion"}:
        raise AssertionError(f"models loaded: {sorted(pipe.models)}")
    conv3x3.launches = flash_attention.launches = 0
    conv3x3_plain.calls = flash_attention_plain.calls = 0
    _zero_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_path = pipe.enhance_image(paths["sd_104x72"], prompt=PROMPT)
    wall = time.perf_counter() - t0
    counts = _sd_counts()
    log(f"SD request sd_104x72.png -n 2 in process: {wall:.3f} s; StageTimer:")
    for line in pipe.timer.summary_lines():
        log(line)
    _check_sd_request(np, "SD enhance_image 104x72 -n 2",
                      imread_rgb(paths["sd_104x72"]), imread_rgb(out_path), 2,
                      counts, 1, pipe.timer.totals)
    if "esrgan+post/streamed" not in pipe.timer.totals:
        raise AssertionError("iteration 2 did not take the streamed final")
    for key in total:
        total[key] += counts[key]
    return total, cli_counts


def drive_default_config(torch, np, ckpt: str, snap: str, seg: str,
                         sd_cli_counts: dict) -> dict:
    """The JAX package's default config through the CLI at 128x128 -n 1:
    the SD CLI request's config with the segmentation snapshot and without
    its segment_enhancement / denoise_level overrides, so NL-means denoise
    and segmentation run at their defaults beside ESRGAN and diffusion. K3
    must launch exactly as often as in that request, K1 at all."""
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)
    cfg = {"use_diffusion": True, "diffusion_model_path": snap,
           "esrgan_model_path": ckpt, "segmentation_model_path": seg,
           "output_dir": os.path.join(OUT, "default_out")}
    rng = np.random.default_rng(SEED + 3)
    small = rng.integers(0, 256, (17, 17, 3), dtype=np.uint8)
    src = os.path.join(OUT, "default_128.png")
    imwrite_rgb(src, np.kron(small, np.ones((8, 8, 1), np.uint8))[:128, :128])
    cfg_path = os.path.join(OUT, "default_cli_config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(OUT, "default_cli", "result.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_COUNTED, "--cli", "-i", src, "-c",
         cfg_path, "-n", "1", "-o", out, "-d", "cuda", "-p", PROMPT,
         "--bench"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"default-config CLI subprocess: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        raise AssertionError("default-config CLI failed:\n"
                             + proc.stdout[-3000:] + proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    counts = json.loads(next(line for line in lines
                             if line.startswith("COUNTS "))[7:])
    log("default-config CLI StageTimer (--bench):")
    stages = []
    for line in lines:
        if line.startswith("  ") and "s (" in line:
            log(line)
            stages.append(line.split()[0])
    _check_sd_request(np, "default-config CLI 128x128 -n 1", imread_rgb(src),
                      imread_rgb(out), 1, counts, 1, stages)
    missing = {"pre/denoise", "pre/contrast", "segmentation"} - set(stages)
    if missing or counts["flash_attention"] != sd_cli_counts[
            "flash_attention"] or not _nlm_ran(counts):
        raise AssertionError(f"default-config CLI: stages lack "
                             f"{sorted(missing)}; counts {counts}, SD CLI "
                             f"request {sd_cli_counts}")
    return counts


def timed_request(torch, pipe, img, label: str, name: str, prompt=None,
                  info: dict | None = None):
    """One request in process, then the same request profiled: its stage
    times (a fresh StageTimer), and the device-busy share of the profiled
    run (kernel and copy time on the card over the wall; the StageTimer's
    nesr/ ranges are annotations, not device work). Returns the output and
    the stage times; fills ``info`` with the wall, the profiled wall and
    the device-busy seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neural_enhanced_super_resolution_torch.runtime.profiler import (
        StageTimer)
    pipe.timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.enhance_array(img, prompt)
    wall = time.perf_counter() - t0
    log(f"{label}: {img.shape[:2]} -> {out.shape[:2]} in {wall:.3f} s; "
        "StageTimer:")
    for line in pipe.timer.summary_lines():
        log(line)
    stages = dict(pipe.timer.totals)
    pipe.timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.enhance_array(img, prompt)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("nesr/")) / 1e6
    log(f"{label} profiled: wall {pwall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / pwall:.1f}% busy) on {name}")
    if info is not None:
        info.update(wall=wall, pwall=pwall, busy=busy)
    return out, stages


def drive_default_in_process(torch, np, ckpt: str, snap: str, seg: str,
                             name: str) -> dict:
    """The default-config request of drive_default_config once more, in
    process with the weights already on the card: its stage split beside
    ESRGAN and diffusion, and its device-busy share."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3, conv3x3_plain, flash_attention, flash_attention_plain)
    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb
    pipe = SuperResolutionPipeline("cuda", {
        "use_diffusion": True, "diffusion_model_path": snap,
        "esrgan_model_path": ckpt, "segmentation_model_path": seg,
        "iterations": 1,
        "output_dir": os.path.join(OUT, "default_out")})
    pipe._load_models()   # set-up: weights to the card before the window
    if set(pipe.models) != {"esrgan", "diffusion", "segmentation"}:
        raise AssertionError(f"models loaded: {sorted(pipe.models)}")
    img = imread_rgb(os.path.join(OUT, "default_128.png"))
    conv3x3.launches = flash_attention.launches = 0
    conv3x3_plain.calls = flash_attention_plain.calls = 0
    _zero_steps()
    out, stages = timed_request(torch, pipe, img,
                                "default-config request 128x128 -n 1 in "
                                "process", name, PROMPT)
    counts = _sd_counts()   # both runs: the timed one and the profiled one
    _check_sd_request(np, "default-config request in process", img, out, 1,
                      counts, 2, stages)
    missing = {"pre/denoise", "pre/contrast", "segmentation"} - set(stages)
    if missing or not _nlm_ran(counts):
        raise AssertionError(f"default-config request lacks {missing} or "
                             f"NL-means' kernel: counts {counts}")
    return counts


def _nlm_events(torch, ops_nlm, fn, events: list):
    """Points ops/nlmeans' NL-means at ``fn`` with CUDA events recorded
    around each call, appended to ``events``; returns the undo."""
    before = ops_nlm.nl_means_fields

    def timed(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args, **kwargs)
        e1.record()
        events.append((e0, e1))
        return out

    ops_nlm.nl_means_fields = timed
    return lambda: setattr(ops_nlm, "nl_means_fields", before)


def _nlm_split(torch, events: list, stage_s: float) -> str:
    """The first of a request's two runs (timed_request: timed, then
    profiled): its NL-means calls' device ms (events) beside its
    pre/denoise wall."""
    torch.cuda.synchronize()
    first = events[:len(events) // 2]
    ms = sum(e0.elapsed_time(e1) for e0, e1 in first)
    return (f"pre/denoise {stage_s:.4f} s, of it NL-means {ms:.4f} ms of "
            f"device time in {len(first)} calls (CUDA events), the rest "
            f"{1e3 * stage_s - ms:.4f} ms")


def drive_denoise_segmentation(torch, np, ckpt: str, seg: str,
                               name: str) -> dict:
    """A 1024x768 ESRGAN request with NL-means denoise and segmentation at
    their defaults, in process, one iteration: both new stages take the
    tiled path (an edge above 768). NL-means must run on its kernel. Then
    the same request in turns (plain, kernel, kernel, plain) against the
    NL-means of ops/nlmeans.py before the kernel (nl_means_fields_plain on
    the card, the plain form moved unchanged): pre/denoise, the request
    wall and the device-busy share of each turn. Each pre/denoise stands
    beside the device time of its NL-means calls (CUDA events around each
    call of the request's first run)."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3, conv3x3_plain, nl_means_fields_plain)
    from neural_enhanced_super_resolution_torch.ops import nlmeans as ops_nlm
    pipe = SuperResolutionPipeline("cuda", {
        "use_diffusion": False, "esrgan_model_path": ckpt,
        "segmentation_model_path": seg, "iterations": 1,
        "output_dir": os.path.join(OUT, "denoise_seg_out")})
    pipe._load_models()   # set-up: weights to the card before the window
    if set(pipe.models) != {"esrgan", "segmentation"}:
        raise AssertionError(f"models loaded: {sorted(pipe.models)}")
    img = _noisy_images(np, 1, 768, 1024, SEED + 8)[0]
    conv3x3.launches = conv3x3_plain.calls = 0
    _zero_steps()
    label = "request 1024x768 -n 1 (ESRGAN, denoise 0.5, segmentation, " \
            "tiled stages)"
    events: list = []
    undo = _nlm_events(torch, ops_nlm, ops_nlm.nl_means_fields, events)
    try:
        out, stages = timed_request(torch, pipe, img, label, name)
    finally:
        undo()
    counts = {"conv3x3": conv3x3.launches,
              "conv3x3_plain": conv3x3_plain.calls, **_step_counts()}
    log(f"request 1024x768 counts (both runs) {counts}; "
        + _nlm_split(torch, events, stages.get("pre/denoise", 0.0)))
    missing = {"pre/denoise", "pre/contrast", "segmentation"} - set(stages)
    if (out.shape != (3072, 4096, 3) or out.std() == 0 or missing
            or counts["conv3x3"] == 0 or counts["conv3x3_plain"]
            or not _steps_ran(counts) or not _nlm_ran(counts)):
        raise AssertionError(f"1024x768 request: output {out.shape}, "
                             f"missing stages {missing}, counts {counts}")

    kernel_fn = ops_nlm.nl_means_fields
    turns = []
    for form in ("plain", "kernel", "kernel", "plain"):
        events = []
        undo = _nlm_events(torch, ops_nlm, nl_means_fields_plain
                           if form == "plain" else kernel_fn, events)
        info: dict = {}
        try:
            turn_out, turn_stages = timed_request(
                torch, pipe, img, f"{label}, NL-means {form}", name,
                info=info)
        finally:
            undo()
        if not np.array_equal(turn_out.shape, out.shape):
            raise AssertionError(f"turn {form}: output {turn_out.shape}")
        turns.append(f"{form} " + _nlm_split(
                         torch, events, turn_stages["pre/denoise"])
                     + f", wall {info['wall']:.4f} s, profiled "
                     f"{info['pwall']:.4f} s at "
                     f"{100 * info['busy'] / info['pwall']:.1f}% busy")
    log("request 1024x768 with denoise and segmentation, in turns "
        "against the plain NL-means: " + "; ".join(turns) + f" on {name}")
    return counts


def check_diffusion_against_cpu(torch, np) -> None:
    """The diffusion branch on the tiny snapshot of tests/test_diffusion.py
    (written by the port's specs): trace_latents with the same injected
    noise, 3 DDIM steps, card bf16 against CPU f32. Latents: max|err| /
    max|ref| <= TOL_SD_CPU; the final uint8: PSNR >= 30 dB."""
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        CLIPTextConfig, UNetConfig, VAEConfig, load_upscale_pipeline)
    from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
        write_synthetic_snapshot)
    path = write_synthetic_snapshot(
        os.path.join(OUT, "sd_tiny"),
        (UNetConfig(sample_size=16, in_channels=7, out_channels=4,
                    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                    block_out_channels=(8, 16), layers_per_block=1,
                    cross_attention_dim=16, attention_head_dim=2,
                    num_class_embeds=50, norm_num_groups=4),
         VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                   latent_channels=4, norm_num_groups=4),
         CLIPTextConfig(vocab_size=100, hidden_size=16, intermediate_size=32,
                        num_hidden_layers=2, num_attention_heads=2,
                        max_position_embeddings=12)),
        torch.Generator().manual_seed(SEED), torch.float32, init="fixed")
    rng = np.random.default_rng(SEED + 4)
    h, w = 24, 40   # ragged attention lengths: 12x20 (UNet), 24x40 (VAE)
    args = ("a photo", rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.standard_normal((h, w, 3)).astype(np.float32),
            rng.standard_normal((h, w, 4)).astype(np.float32))
    ref_lats, ref = load_upscale_pipeline(
        path, device="cpu", compute_dtype="float32").trace_latents(
            *args, num_inference_steps=3)
    lats, got = load_upscale_pipeline(path, device="cuda").trace_latents(
        *args, num_inference_steps=3)
    err = np.abs(lats - ref_lats).max() / np.abs(ref_lats).max()
    mse = float(np.mean((got.astype(np.float64) - ref) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log(f"tiny SD x4 {h}x{w}, 3 DDIM steps, card bf16 vs CPU f32: latents "
        f"max|err|/max|ref| {err:.4g} (bar {TOL_SD_CPU}), output PSNR "
        f"{psnr:.2f} dB (bar 30 dB), max diff "
        f"{np.abs(got.astype(int) - ref.astype(int)).max()}")
    if not (err <= TOL_SD_CPU and psnr >= 30.0 and got.shape == ref.shape):
        raise AssertionError(f"tiny SD agreement: latents {err}, PSNR {psnr}")


def write_swinir_checkpoint(torch) -> str:
    """SwinIR-M real-world x4 (embed 180, depths 6 x 6, heads 6, window 8,
    mlp 2, num_feat 64, nearest+conv) with seeded weights, as an official
    .pth (params_ema)."""
    from neural_enhanced_super_resolution_torch.models import (
        SwinIRConfig, init_swinir, save_state_dict)
    return save_state_dict(
        init_swinir(SwinIRConfig(), torch.Generator().manual_seed(SEED + 9)),
        os.path.join(OUT, "swinir_m_x4_synthetic.pth"))


def kernel_families(fn) -> dict:
    """Device time a call by kernel family (torch.profiler): K1, GEMM
    (cuBLAS), softmax, LayerNorm, the rest (elementwise, copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fam = dict.fromkeys(("K1", "GEMM", "softmax", "LayerNorm",
                         "elementwise/copy"), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        key = ("K1" if "conv3x3" in name else
               "GEMM" if any(t in name for t in ("gemm", "xmma", "nvjet",
                                                 "cutlass", "cublas")) else
               "softmax" if "softmax" in name else
               "LayerNorm" if "layer_norm" in name or "layernorm" in name
               else "elementwise/copy")
        fam[key] += e.time_range.elapsed_us() / 1e3
    return fam


def swinir_flops(cfg, h: int, w: int) -> float:
    """Operations of one forward on an (h, w) input that is a multiple of
    the window: per STL the linears 2 T C (3C + C + 2 hidden) and the two
    attention products 4 T n C over T = h w tokens and n = window^2; the
    3x3 convs 18 Cin Cout a pixel at their resolutions."""
    from neural_enhanced_super_resolution_torch.models.swinir import (
        _conv_names)
    t, c = h * w, cfg.embed_dim
    hidden = int(c * cfg.mlp_ratio)
    stls = sum(cfg.depths)
    ops = stls * (2.0 * t * c * (4 * c + 2 * hidden)
                  + 4.0 * t * cfg.window_size ** 2 * c)
    up = {"conv_up1": 4, "conv_up2": 16, "conv_hr": 16, "conv_last": 16}
    for name, (cin, cout) in _conv_names(cfg).items():
        ops += 18.0 * t * up.get(name, 1) * cin * cout
    return ops


def check_swinir_forward(torch, np, path: str, name: str) -> dict:
    """SwinIR-M x4 loaded from its .pth through load_swinir (the config
    inferred on the card) on one 268^2 tile: K1 against the same model on
    conv3x3_plain (rel bar TOL_FORWARD), device ms, wall and launches a
    call, the split by kernel family and the bound; then the card in bf16
    against the port on the CPU in float32 at 60x44 (the pad path), PSNR
    of the uint8 outputs >= 30 dB."""
    from neural_enhanced_super_resolution_torch.models.swinir import (
        SwinIRConfig, load_swinir, swinir_param_shapes)
    t0 = time.perf_counter()
    model = load_swinir(path, "bfloat16", "cuda")
    log(f"SwinIR checkpoint loaded to the card in "
        f"{time.perf_counter() - t0:.2f} s; inferred {model.cfg}")
    if model.cfg != SwinIRConfig():
        raise AssertionError(f"inferred {model.cfg}, not SwinIR-M x4")
    side = 256 + 2 * 6
    x = torch.rand((1, side, side, 3),
                   generator=torch.Generator().manual_seed(SEED + 10)).to(
        "cuda")
    got = model(x)
    ref = model(x, plain=True)
    d, r = rel_err(got, ref)
    dev = device_ms(lambda: model(x), reps=5)
    wms = wall_ms(lambda: model(x), reps=5)
    launches = launches_per_call(lambda: model(x), reps=1)
    fam = kernel_families(lambda: model(x))
    hp = side + (-side) % model.cfg.window_size
    flops = swinir_flops(model.cfg, hp, hp)
    # the f32 tile in, the f32 x4 tile out, the weights once in bf16
    weights = sum(math.prod(s) for s in swinir_param_shapes(model.cfg)
                  .values())
    bms, by = bound(flops, 4.0 * side * side * 3 * (1 + 16) + 2.0 * weights)
    total = sum(fam.values())
    split = ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in fam.items())
    log(f"SwinIR-M x4 forward 1x{side}x{side} (padded to {hp}): max_abs_err "
        f"{d:.6g} rel {r:.3g} vs conv3x3_plain (tol {TOL_FORWARD}); device "
        f"{dev:.3f} ms, wall {wms:.3f} ms, {launches:.0f} launches a call; "
        f"by family: {split}; bound {bms:.4f} ms ({by}: "
        f"{flops / 1e12:.4f} TFLOP), bound/device {bms / dev:.4f} on {name}")
    if not (r <= TOL_FORWARD and torch.isfinite(got).all()):
        raise AssertionError(f"SwinIR forward: rel err {r}")
    del got, ref
    rng = np.random.default_rng(SEED + 11)
    small = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    img = np.kron(small, np.ones((8, 8, 1), np.uint8))[None, :44, :60]
    out = model.upscale_batch(torch.from_numpy(img).to("cuda")).cpu().numpy()
    t0 = time.perf_counter()
    cpu = load_swinir(path, "float32", "cpu").upscale_batch(
        torch.from_numpy(img)).numpy()
    cpu_s = time.perf_counter() - t0
    mse = float(np.mean((out.astype(np.float64) - cpu) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log(f"SwinIR-M x4 60x44 (pad path to 64x48), bf16 card vs CPU f32 "
        f"({cpu_s:.2f} s there): PSNR {psnr:.2f} dB (bar 30), max diff "
        f"{np.abs(out.astype(int) - cpu.astype(int)).max()}")
    if out.shape != (1, 176, 240, 3) or out.shape != cpu.shape \
            or not psnr >= 30.0:
        raise AssertionError(f"SwinIR card vs CPU: {out.shape} PSNR {psnr}")


def _count_swinir_k1(pipe, conv3x3) -> list:
    """Wraps the loaded SwinIR's upscale_batch to record the K1 launches
    and tiles of each call (one list entry a call)."""
    model = pipe.models["swinir"]
    calls = []
    inner = model.upscale_batch

    def counted(tiles):
        before = conv3x3.launches
        out = inner(tiles)
        calls.append((int(tiles.shape[0]), conv3x3.launches - before))
        return out

    model.upscale_batch = counted
    return calls


def drive_swinir_requests(torch, np, ckpt: str, swin: str, snap: str,
                          seg: str, name: str) -> dict:
    """Two in-process requests with use_swinir: a 1024x768 ESRGAN + SwinIR
    request (12 SwinIR tiles; diffusion, denoise and segmentation off), and
    the 128x128 default config plus SwinIR (denoise, segmentation, ESRGAN,
    SwinIR whole and diffusion into a three-branch ensemble). Each runs
    twice (timed, then profiled); counts zeroed before, read after."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3, conv3x3_plain, flash_attention, flash_attention_plain)
    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb
    total = dict.fromkeys(_sd_counts(), 0)

    pipe = SuperResolutionPipeline("cuda", {
        "use_diffusion": False, "segment_enhancement": False,
        "denoise_level": 0, "use_swinir": True, "swinir_model_path": swin,
        "esrgan_model_path": ckpt, "iterations": 1,
        "output_dir": os.path.join(OUT, "swinir_out")})
    pipe._load_models()   # set-up: weights to the card before the window
    if set(pipe.models) != {"esrgan", "swinir"}:
        raise AssertionError(f"models loaded: {sorted(pipe.models)}")
    calls = _count_swinir_k1(pipe, conv3x3)
    img = _noisy_images(np, 1, *SWIN_REQUEST, SEED + 12)[0]
    conv3x3.launches = flash_attention.launches = 0
    conv3x3_plain.calls = flash_attention_plain.calls = 0
    _zero_steps()
    out, stages = timed_request(torch, pipe, img,
                                "request 1024x768 -n 1 (ESRGAN + SwinIR)",
                                name)
    counts = _sd_counts()
    tiles = sum(t for t, _ in calls)
    swin_k1 = sum(k for _, k in calls)
    log(f"request 1024x768 ESRGAN + SwinIR counts (both runs) {counts}; "
        f"SwinIR: {tiles} tiles in {len(calls)} forwards, {swin_k1} K1 "
        f"launches; stages swinir {stages.get('swinir', 0):.3f} s, esrgan "
        f"{stages.get('esrgan', 0):.3f} s, ensemble "
        f"{stages.get('ensemble', 0):.3f} s")
    if (out.shape != (4 * SWIN_REQUEST[0], 4 * SWIN_REQUEST[1], 3)
            or out.std() == 0 or tiles != 2 * 12 or len(calls) != 2 * 12
            or swin_k1 != SWIN_K1_PER_FORWARD * tiles
            or counts["conv3x3_plain"] or not _steps_ran(counts)
            or not {"swinir", "esrgan", "ensemble"} <= set(stages)):
        raise AssertionError(f"1024x768 SwinIR request: output {out.shape}, "
                             f"calls {calls}, counts {counts}, stages "
                             f"{sorted(stages)}")
    for key in total:
        total[key] += counts[key]
    del pipe
    torch.cuda.empty_cache()

    pipe = SuperResolutionPipeline("cuda", {
        "use_diffusion": True, "diffusion_model_path": snap,
        "esrgan_model_path": ckpt, "segmentation_model_path": seg,
        "use_swinir": True, "swinir_model_path": swin, "iterations": 1,
        "output_dir": os.path.join(OUT, "swinir_default_out")})
    pipe._load_models()
    if set(pipe.models) != {"esrgan", "swinir", "diffusion", "segmentation"}:
        raise AssertionError(f"models loaded: {sorted(pipe.models)}")
    calls = _count_swinir_k1(pipe, conv3x3)
    img = imread_rgb(os.path.join(OUT, "default_128.png"))
    conv3x3.launches = flash_attention.launches = 0
    conv3x3_plain.calls = flash_attention_plain.calls = 0
    _zero_steps()
    out, stages = timed_request(torch, pipe, img,
                                "default config + SwinIR 128x128 -n 1 in "
                                "process", name, PROMPT)
    counts = _sd_counts()
    _check_sd_request(np, "default config + SwinIR in process", img, out, 1,
                      counts, 2, stages)
    if (calls != [(1, SWIN_K1_PER_FORWARD)] * 2 or not _nlm_ran(counts)
            or not {"pre/denoise", "segmentation", "esrgan", "swinir",
                    "ensemble"} <= set(stages)):
        raise AssertionError(f"default + SwinIR: calls {calls}, stages "
                             f"{sorted(stages)}")
    for key in total:
        total[key] += counts[key]
    del pipe
    torch.cuda.empty_cache()
    return total


def drive_batch_cli(np, ckpt: str, swin: str, seg: str) -> dict:
    """One CLI process over a directory of three small images with
    --use_swinir --no_diffusion (denoise and segmentation at their
    defaults): exit 0, three x4 outputs named {base}_enhanced{ext}, the
    per-image and total wall time."""
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)
    src = os.path.join(OUT, "batch_in")
    dst = os.path.join(OUT, "batch_out")
    for d in (src, dst):
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
    rng = np.random.default_rng(SEED + 13)
    sizes = {"a.png": (96, 96), "b.jpg": (64, 80), "c.png": (72, 56)}
    for fname, (hh, ww) in sizes.items():
        small = rng.integers(0, 256, (hh // 8 + 1, ww // 8 + 1, 3),
                             dtype=np.uint8)
        imwrite_rgb(os.path.join(src, fname),
                    np.kron(small, np.ones((8, 8, 1), np.uint8))[:hh, :ww])
    cfg = os.path.join(OUT, "batch_cli_config.json")
    with open(cfg, "w") as f:
        json.dump({"esrgan_model_path": ckpt, "swinir_model_path": swin,
                   "segmentation_model_path": seg}, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_COUNTED, "--cli", "-i", src, "-c", cfg,
         "-n", "1", "-o", dst, "-d", "cuda", "--use_swinir",
         "--no_diffusion", "--bench"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    per_image = [line for line in lines if " -> " in line]
    log(f"batch CLI over {len(sizes)} images (--use_swinir --no_diffusion): "
        f"rc {proc.returncode} in {wall:.2f} s (process start and model "
        "load included); per image: " + "; ".join(
            os.path.basename(line.split(" -> ")[0]) + " "
            + line.rsplit("(", 1)[-1].rstrip(")") for line in per_image))
    if proc.returncode != 0:
        raise AssertionError("batch CLI failed:\n" + proc.stdout[-3000:]
                             + proc.stderr[-3000:])
    for line in lines:
        if line.startswith("  ") and "s (" in line:
            log(line)
    counts = json.loads(next(line for line in lines
                             if line.startswith("COUNTS "))[7:])
    want = {f"{os.path.splitext(f)[0]}_enhanced{os.path.splitext(f)[1]}":
            (4 * hh, 4 * ww, 3) for f, (hh, ww) in sizes.items()}
    got = {f: imread_rgb(os.path.join(dst, f)).shape
           for f in sorted(os.listdir(dst))}
    log(f"batch CLI outputs {got}; counts {counts}")
    if (got != want or counts["conv3x3"] == 0 or counts["conv3x3_plain"]
            or not _steps_ran(counts) or not _nlm_ran(counts)):
        raise AssertionError(f"batch CLI: outputs {got} (want {want}), "
                             f"counts {counts}")
    return counts


# ---- The int8 trunk (K4) and parity tiling --------------------------------

def int8_bound(pix: int, cin: int, cout: int) -> tuple[float, str]:
    """K4's bound: 2 Cin Cout 9 int8 operations a pixel at 1,979 TOP/s,
    against the int8 input, the bf16 output, the int8 weights and the
    float32 scales once at 3.35 TB/s."""
    return bound(2.0 * pix * cout * 9 * cin,
                 pix * (cin + 2.0 * cout) + 9.0 * cin * cout + 4.0 * cout
                 + 4.0, peak_flops=PEAK_INT8_OPS)


def check_conv3x3_int8(torch, gen) -> dict:
    """K4 at the int8 trunk's and the trained fixture's shapes on
    full-range int8 operands, bitwise against conv3x3_int8_plain; device
    ms and wall beside the bound, the plain version's device ms and K1's
    bf16 device ms at the same shape (the fused trunk's conv). PyTorch has
    no int8 convolution on CUDA: library none."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv3x3, pack_conv3x3_weights)
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
        conv3x3_int8, conv3x3_int8_plain, pack_conv3x3_int8_weights)
    result, failed = {}, []
    for label, n, h, w, cin, cout in INT8_SHAPES:
        q = torch.randint(-127, 128, (n, h, w, cin), generator=gen,
                          dtype=torch.int8).to("cuda")
        wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                           dtype=torch.int8).to("cuda")
        w_s = (torch.rand((cout,), generator=gen) * 1e-2 + 1e-4).to("cuda")
        s_x = (torch.rand((), generator=gen) * 8 + 0.5).to("cuda")
        pk = pack_conv3x3_int8_weights(wq)
        got = conv3x3_int8(q, wq, s_x, w_s, packed=pk)
        ref = conv3x3_int8_plain(q, wq, s_x, w_s)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int16), ref.view(torch.int16))
        d = (got.float() - ref.float()).abs().max().item()
        ms = device_ms(lambda: conv3x3_int8(q, wq, s_x, w_s, packed=pk))
        wms = wall_ms(lambda: conv3x3_int8(q, wq, s_x, w_s, packed=pk))
        pms = device_ms(lambda: conv3x3_int8_plain(q, wq, s_x, w_s), reps=3)
        x = _rnd(torch, gen, n, h, w, cin)
        wt = _rnd(torch, gen, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        wpk = pack_conv3x3_weights(wt)
        k1 = device_ms(lambda: conv3x3(x, wt, packed=wpk))
        bms, by = int8_bound(n * h * w, cin, cout)
        log(f"K4 conv3x3_int8 {label} {tuple(q.shape)}: bitwise "
            f"{'equal' if same else 'DIFFERENT'} to plain (max_abs_err "
            f"{d:.6g}); device {ms:.4f} ms, wall {wms:.4f} ms a call; bound "
            f"{bms:.4f} ms ({by}), bound/device {bms / ms:.3f}; plain "
            f"{pms:.4f} ms; K1 bf16 at this shape {k1:.4f} ms (K4/K1 "
            f"{ms / k1:.3f}); library: none")
        if not same:
            failed.append(label)
        if label.startswith("trunk w0"):
            result = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                      "bound_by": by, "library_ms": None}
        result["max_abs_err"] = max(result.get("max_abs_err", 0.0), d)
        del q, got, ref, x
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K4 differs from its plain version: {failed}")
    return result


def _int8_rdb(torch, gen, nf: int, g: int):
    """An Int8RDB of widths (nf, g) on the card from seeded float weights
    of std 0.05 and biases of std 0.1 (K2's check's scale: every conv of
    the dense chain moves the output), with the float weights."""
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        Int8RDB, quantize_rdb)
    shapes = [(nf, 4 * g + nf), (g, 3 * g + nf), (g, 2 * g + nf),
              (g, g + nf), (g, nf)]
    fw = [torch.randn((3, 3, ci, co), generator=gen) * 0.05
          for ci, co in shapes]
    b = torch.randn((4 * g + nf,), generator=gen) * 0.1
    return Int8RDB(*quantize_rdb(fw), b, "cuda"), fw, b


def _same(a, b) -> bool:
    """Bit for bit, NaN payloads and signed zeros included."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return bool(torch.equal(a.view(it), b.view(it)))
    return bool(torch.equal(a, b))


def rdb_int8_bytes(pix: int, nf: int, g: int, xbytes: int,
                   skip: bool = False) -> list:
    """Bytes each of the five steps must move a pixel times pix (each
    input read once, each output written once): the source, the slots it
    reads and writes, x_{k+1} in float32, and at step 4 x (and skip) and
    out in x's dtype."""
    cs = 4 * g + nf
    steps = [nf * xbytes + 2 * (cs - g) + 4 * g]
    for k in range(1, 4):
        steps.append(4 * g + 2 * (cs - k * g) + 2 * (cs - (k + 1) * g)
                     + 4 * g)
    steps.append(4 * g + 2 * nf + (2 + skip) * nf * xbytes)
    return [pix * b for b in steps]


def rdb_int8_bound(pix: int, nf: int, g: int, xbytes: int,
                   skip: bool = False) -> tuple:
    """The bound of one int8 RDB, the function the five steps compute:
    its int8 operations at 1,979 TOP/s against x (and skip) read and out
    written once in x's dtype, with the weights, scales and biases, at
    3.35 TB/s. Beside it the floor of the five-launch design, whose
    x_1..x_4 and slots pass through HBM between steps (rdb_int8_bytes),
    and each step's bound alone."""
    cins = [nf, g, g, g, g]
    couts = [4 * g + nf - k * g for k in range(5)]
    macs = sum(c * o for c, o in zip(cins, couts))
    params = 9.0 * macs + 4.0 * (sum(couts) + 4 * g + nf) + 24.0
    nbytes = rdb_int8_bytes(pix, nf, g, xbytes, skip)
    per = [bound(2.0 * pix * 9 * ci * co,
                 nb + 9.0 * ci * co + 4.0 * co + 4.0 * (4 * g + nf) + 8.0,
                 peak_flops=PEAK_INT8_OPS)
           for ci, co, nb in zip(cins, couts, nbytes)]
    whole = bound(2.0 * pix * 9 * macs,
                  (2 + skip) * xbytes * pix * nf + params,
                  peak_flops=PEAK_INT8_OPS)
    design = bound(2.0 * pix * 9 * macs, sum(nbytes) + params,
                   peak_flops=PEAK_INT8_OPS)
    return whole, design, per


def composition_rdb(rdb, x):
    """The int8 RDB on the standalone K4, built from the port's public
    functions: each conv's input through quantize_int8, K4
    (conv3x3_int8), then the PyTorch float32 assembly of
    _rdb_fused_int8."""
    import torch.nn.functional as F
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
        conv3x3_int8, quantize_int8)
    g, b = rdb.gc, rdb.b

    def conv(h, k):
        q, s = quantize_int8(h)
        return conv3x3_int8(q, getattr(rdb, f"q{k}"), s,
                            getattr(rdb, f"s{k}"),
                            packed=getattr(rdb, f"p{k}"))
    c = [conv(x, 0)]
    xk = F.leaky_relu(c[0][..., :g] + b[:g], 0.2)
    for k in range(1, 4):
        c.append(conv(xk, k))
        sk = c[0][..., k * g:(k + 1) * g]
        for j in range(1, k + 1):
            sk = sk + c[j][..., (k - j) * g:(k - j + 1) * g]
        xk = F.leaky_relu(sk + b[k * g:(k + 1) * g], 0.2)
    c.append(conv(xk, 4))
    x5 = c[0][..., 4 * g:]
    for j in range(1, 5):
        x5 = x5 + c[j][..., (4 - j) * g:]
    return x + 0.2 * (x5 + b[4 * g:]).to(x.dtype)


def composition_body(model, feat):
    """The int8 trunk on the standalone K4: composition_rdb for every RDB."""
    body = feat
    for block in model.body:
        out = body
        for rdb in block.rdbs:
            out = composition_rdb(rdb, out)
        body = body + 0.2 * out
    return body


def _step_args(rdb, k: int):
    return (getattr(rdb, f"q{k}"), getattr(rdb, f"s{k}"), rdb.b)


def check_rdb_int8_steps(torch, rdb, x, skip, label: str) -> list:
    """K4's redesign at one RDB's five steps against
    conv3x3_int8_rdb_plain on the same inputs, step by step and bit for
    bit: x_{k+1} (or out), the whole slot buffer and the whole scale
    chain; int8_amax against int8_amax_plain; the RDB on the kernels
    against Int8RDB's plain composition. Returns the failures."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
        conv3x3_int8_rdb, conv3x3_int8_rdb_plain, int8_amax, int8_amax_plain)
    failed = []
    scales = int8_amax(x, 5)
    if not _same(scales, int8_amax_plain(x, 5)):
        failed.append(f"{label} int8_amax")
    n, h, w, _ = x.shape
    slots = torch.zeros((n, h, w, rdb.b.numel()), dtype=torch.bfloat16,
                        device="cuda")
    src = x
    for k in range(5):
        sl_p, sc_p = slots.clone(), scales.clone()
        extra = dict(x=x, skip=skip) if k == 4 else {}
        got = conv3x3_int8_rdb(k, src, scales[k], scales[k + 1],
                               *_step_args(rdb, k), slots,
                               packed=getattr(rdb, f"p{k}"), **extra)
        ref = conv3x3_int8_rdb_plain(k, src, sc_p[k], sc_p[k + 1],
                                     *_step_args(rdb, k), sl_p, **extra)
        torch.cuda.synchronize()
        parts = {"y": _same(got, ref), "slots": _same(slots, sl_p),
                 "scales": _same(scales, sc_p)}
        if not all(parts.values()):
            d = (got.float() - ref.float()).abs().max().item()
            ds = (slots.float() - sl_p.float()).abs().max().item()
            failed.append(f"{label} step {k} {parts} (y max|d| {d:.6g}, "
                          f"slots max|d| {ds:.6g}, scales {scales.tolist()} "
                          f"vs {sc_p.tolist()})")
        src = got
    got, ref = rdb(x, skip=skip), rdb(x, plain=True, skip=skip)
    torch.cuda.synchronize()
    if not _same(got, ref):
        failed.append(f"{label} RDB vs its plain composition (max|d| "
                      f"{(got.float() - ref.float()).abs().max().item():.6g})")
    log(f"K4 step rdb_int8 {label} {tuple(x.shape)} {x.dtype}"
        f"{' +skip' if skip is not None else ''}: x_k+1/out, slots and "
        f"scales of the 5 steps, int8_amax and the RDB against the plain "
        f"composition: {'bitwise equal' if not failed else failed}; "
        f"scales {[f'{v:.6g}' for v in scales.tolist()]}")
    return failed


def check_conv3x3_int8_rdb(torch, gen) -> tuple:
    """K4's redesign (csrc/rdb_int8.cu) bit for bit against its plain
    version at the int8 trunk's RDB on TILE_BATCH (with and without the
    RRDB skip), the trained fixture's (nf 16, growth 8) on 1 x 80^2, a
    float32 RDB and one at widths the 16-byte paths do not take; then,
    on TILE_BATCH, device time of an RDB in turns: the K4 composition
    (quantize_int8 -> conv3x3_int8 -> the PyTorch assembly), the five
    steps, the fused trunk's RDB (five K1 convs + assembly) and K2 (the
    dform trunk's RDB) on the same weights; each step beside its bound,
    the standalone K4 conv and its quantise pass; int8_amax beside its
    bound and torch.linalg.vector_norm(ord=inf). Returns the kernels JSON rows of
    both entries: the step as one RDB's five launches."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
        conv3x3_int8, conv3x3_int8_rdb, conv3x3_int8_rdb_plain, int8_amax,
        int8_amax_plain, quantize_int8)
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    failed = []
    n, h, w = TILE_BATCH
    rdb, fw, fb = _int8_rdb(torch, gen, 64, 32)
    x = _rnd(torch, gen, n, h, w, 64, scale=0.5)
    skip = _rnd(torch, gen, n, h, w, 64, scale=0.5)
    failed += check_rdb_int8_steps(torch, rdb, x, None, "trunk")
    failed += check_rdb_int8_steps(torch, rdb, x, skip, "trunk")
    fix, _, _ = _int8_rdb(torch, gen, 16, 8)
    failed += check_rdb_int8_steps(
        torch, fix, _rnd(torch, gen, 1, 80, 80, 16, scale=0.5), None,
        "fixture")
    failed += check_rdb_int8_steps(
        torch, rdb, _rnd(torch, gen, 2, 37, 45, 64, scale=0.5,
                         dtype=torch.float32),
        _rnd(torch, gen, 2, 37, 45, 64, scale=0.5, dtype=torch.float32),
        "float32")
    odd, _, _ = _int8_rdb(torch, gen, 12, 4)
    failed += check_rdb_int8_steps(
        torch, odd, _rnd(torch, gen, 2, 21, 35, 12, scale=0.5), None,
        "scalar paths (nf 12, g 4)")
    if failed:
        raise AssertionError(f"K4 step differs from its plain version: "
                             f"{failed}")

    # Timing on TILE_BATCH. The five steps on a chain made once (step 0
    # rewrites the slots it starts from, so every call is the same work).
    scales = int8_amax(x, 5)
    slots = torch.empty((n, h, w, 192), dtype=torch.bfloat16, device="cuda")

    def step(k, src, fn=conv3x3_int8_rdb):
        extra = dict(x=x) if k == 4 else {}
        if fn is conv3x3_int8_rdb:
            extra["packed"] = getattr(rdb, f"p{k}")
        return fn(k, src, scales[k], scales[k + 1], *_step_args(rdb, k),
                  slots, **extra)

    def steps(fn=conv3x3_int8_rdb):
        t = x
        for k in range(5):
            t = step(k, t, fn)
        return t

    def composition():
        return composition_rdb(rdb, x)

    if not _same(composition(), steps()):
        raise AssertionError("K4 step: the five steps differ from the K4 "
                             "composition on the card")
    fused = FusedRDB([t.to(torch.bfloat16) for t in fw], fb, torch.bfloat16,
                     "cuda", kernel=False)
    dform = FusedRDB([t.to(torch.bfloat16) for t in fw], fb, torch.bfloat16,
                     "cuda", kernel=True)
    pix = n * h * w
    (bms, by), (dms, dby), per = rdb_int8_bound(pix, 64, 32, 2)
    runs = {"composition": composition, "steps": steps,
            "fused": lambda: fused(x), "dform": lambda: dform(x)}
    dev = {k: [] for k in runs}
    for key in ("composition", "steps", "fused", "dform",
                "dform", "fused", "steps", "composition"):
        dev[key].append(device_ms(runs[key], reps=10, floor_ms=dms))
    wms = wall_ms(steps)
    pms = device_ms(lambda: steps(conv3x3_int8_rdb_plain), reps=2)
    ms = min(dev["steps"])
    log(f"K4 step rdb_int8, one RDB (5 launches) on {tuple(x.shape)} bf16, "
        f"device ms in turns (composition, steps, fused, dform, dform, "
        f"fused, steps, composition): {dev}; bound {bms:.4f} ms ({by}), "
        f"bound/steps {bms / ms:.3f}; the five-launch design's floor "
        f"{dms:.4f} ms ({dby}), floor/steps {dms / ms:.3f}; steps/composition "
        f"{ms / min(dev['composition']):.3f}, steps/fused "
        f"{ms / min(dev['fused']):.3f}, steps/dform "
        f"{ms / min(dev['dform']):.3f}; wall {wms:.4f} ms an RDB; plain "
        f"steps {pms:.4f} ms")
    # Each step alone, beside its bound, the standalone K4 at its shape and
    # that conv's quantise pass.
    srcs = [x] + [torch.randn((n, h, w, 32), generator=gen).to("cuda")
                  for _ in range(4)]
    for k in range(5):
        cin, cout = (64, 192) if k == 0 else (32, 160 - 32 * (k - 1))
        sk = device_ms(lambda k=k: step(k, srcs[k]), reps=10,
                       floor_ms=per[k][0])
        q, s = quantize_int8(srcs[k])
        old = device_ms(lambda k=k, q=q, s=s: conv3x3_int8(
            q, getattr(rdb, f"q{k}"), s, getattr(rdb, f"s{k}"),
            packed=getattr(rdb, f"p{k}")))
        qms = device_ms(lambda k=k: quantize_int8(srcs[k]))
        log(f"K4 step {k} ({cin}->{cout}) on {tuple(x.shape[:3])}: device "
            f"{sk:.4f} ms, bound {per[k][0]:.4f} ({per[k][1]}), "
            f"bound/step {per[k][0] / sk:.3f}; standalone K4 "
            f"{old:.4f} + its quantise {qms:.4f}")
    # int8_amax on the trunk's input: max|x| once, a memset of the chain.
    # The 36.8 MB input fits the 50 MB L2, where repeated launches would
    # find it: a 96 MB fill between launches evicts it, and the kernel
    # (amax_kernel) and the library's kernels are timed apart from the fill
    # and the chain's memset.
    chain = 15 * ARCH["num_block"]
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    ams = device_ms_named(lambda: (flush.fill_(1), int8_amax(x, chain)),
                          lambda: None, "amax_kernel")[0]
    apms = device_ms(lambda: int8_amax_plain(x, chain), reps=3)
    lib_ms = device_ms_named(
        lambda: (flush.fill_(1), torch.linalg.vector_norm(x, float("inf"))),
        lambda: None, "FillFunctor")[1]
    del flush
    same = _same(int8_amax(x, chain), int8_amax_plain(x, chain))
    abms, aby = bound(float(x.numel()), 2.0 * x.numel() + 4.0 * (chain + 1))
    log(f"int8_amax on {tuple(x.shape)} bf16, chain {chain + 1}: "
        f"{'bitwise equal' if same else 'DIFFERENT'} to plain; device "
        f"{ams:.4f} ms (the kernel, L2 flushed before each launch), bound "
        f"{abms:.4f} ({aby}), bound/kernel {abms / ams:.3f}; plain "
        f"{apms:.4f}; library torch.linalg.vector_norm(ord=inf) {lib_ms:.4f}"
        " (L2 flushed)")
    if not same:
        raise AssertionError("int8_amax differs from its plain version")
    del fused, dform, srcs, slots
    torch.cuda.empty_cache()
    return ({"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
             "library_ms": None, "max_abs_err": 0.0},
            {"ms": ams, "plain_ms": apms, "bound_ms": abms, "bound_by": aby,
             "library_ms": lib_ms, "max_abs_err": 0.0})


def rdb_bf16_bytes(pix: int, nf: int, g: int, skip: bool = False) -> list:
    """Bytes each of the K1 step's five launches must move (each input
    read once, each output written once), times pix: the bf16 source, the
    slots it reads and writes, x_{k+1}, and at step 4 x (and skip) and
    out."""
    cs = 4 * g + nf
    steps = [2 * nf + 2 * (cs - g) + 2 * g]
    for k in range(1, 4):
        steps.append(2 * g + 2 * (cs - k * g) + 2 * (cs - (k + 1) * g)
                     + 2 * g)
    steps.append(2 * g + 2 * nf + (2 + skip) * 2 * nf)
    return [pix * b for b in steps]


def rdb_bf16_bound(pix: int, nf: int, g: int, skip: bool = False) -> tuple:
    """The bound of one bf16 RDB, the function the five steps compute:
    its operations at 989 TFLOP/s against x (and skip) read and out
    written once, with the weights and biases, at 3.35 TB/s. Beside it
    the floor of the five-launch design, whose x_1..x_4 and slots pass
    through HBM between steps (rdb_bf16_bytes), and each step's bound
    alone."""
    cins = [nf, g, g, g, g]
    couts = [4 * g + nf - k * g for k in range(5)]
    macs = sum(c * o for c, o in zip(cins, couts))
    params = 18.0 * macs + 4.0 * (4 * g + nf)
    nbytes = rdb_bf16_bytes(pix, nf, g, skip)
    per = [bound(2.0 * pix * 9 * ci * co,
                 nb + 18.0 * ci * co + 4.0 * (4 * g + nf))
           for ci, co, nb in zip(cins, couts, nbytes)]
    whole = bound(2.0 * pix * 9 * macs, (2 + skip) * 2.0 * pix * nf + params)
    design = bound(2.0 * pix * 9 * macs, sum(nbytes) + params)
    return whole, design, per


def _fused_rdb(torch, gen, nf: int, g: int, kernel: bool = False):
    """A FusedRDB of widths (nf, g) on the card from seeded float weights
    of std 0.05 and biases of std 0.1 (K2's check's scale: every conv of
    the dense chain moves the output), with the float weights."""
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    shapes = [(nf, 4 * g + nf), (g, 3 * g + nf), (g, 2 * g + nf),
              (g, g + nf), (g, nf)]
    fw = [(torch.randn((3, 3, ci, co), generator=gen) * 0.05).to(
        torch.bfloat16).float() for ci, co in shapes]
    b = torch.randn((4 * g + nf,), generator=gen) * 0.1
    return FusedRDB(fw, b, torch.bfloat16, "cuda", kernel=kernel), fw, b


def _bf16_ulps(a, b) -> int:
    """The largest distance in bf16 steps between a and b (ordered
    integers of the bit patterns; -0 and +0 one step apart)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def check_rdb_bf16_steps(torch, rdb, x, skip, label: str) -> list:
    """The K1 step at one RDB's five steps against conv3x3_rdb_plain on
    the same inputs, step by step (x_{k+1} or out, and the slots each step
    wrote; the plain convs sum in another order, so the bar is K1's rel
    1e-2), then the RDB on the steps against FusedRDB._composition on K1
    (the target: bit for bit; printed as the count of unequal bf16 values
    and the largest distance in bf16 steps, held to rel 1e-2). Returns the
    failures and the RDB's max|err| against its plain steps."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
        conv3x3_rdb, conv3x3_rdb_plain)
    failed, notes = [], []
    n, h, w, _ = x.shape
    g = rdb.gc
    slots = torch.zeros((n, h, w, rdb.b.numel()), dtype=torch.bfloat16,
                        device="cuda")
    src = x
    for k, (wk, pk) in enumerate(zip(rdb.weights(), rdb.packed())):
        sl_p = slots.clone()
        extra = dict(x=x, skip=skip) if k == 4 else {}
        got = conv3x3_rdb(k, src, wk, rdb.b, slots, packed=pk, **extra)
        ref = conv3x3_rdb_plain(k, src, wk, rdb.b, sl_p, **extra)
        torch.cuda.synchronize()
        lo = (k + 1) * g
        _, ry = rel_err(got, ref)
        _, rs = rel_err(slots[..., lo:], sl_p[..., lo:]) if k < 4 else (0, 0)
        notes.append(f"step {k} rel {ry:.3g} slots rel {rs:.3g} unequal "
                     f"{int((got != ref).sum())}")
        if not (ry <= TOL_KERNEL and rs <= TOL_KERNEL):
            failed.append(f"{label} step {k}: rel {ry}, slots rel {rs}")
        src = got
    got = rdb(x, skip=skip)
    plain = rdb(x, plain=True, skip=skip)
    comp = rdb._composition(x)
    if skip is not None:
        comp = skip + 0.2 * comp
    torch.cuda.synchronize()
    d, r = rel_err(got, comp)
    dp, rp = rel_err(got, plain)
    unequal = int((got != comp).sum())
    log(f"K1 step rdb_bf16 {label} {tuple(x.shape)}"
        f"{' +skip' if skip is not None else ''}: the RDB on the steps "
        f"against FusedRDB._composition on K1: {unequal} of {got.numel()} "
        f"bf16 values unequal, at most {_bf16_ulps(got, comp)} bf16 steps "
        f"apart, max_abs_err {d:.6g} rel {r:.3g} (target bit for bit, bar "
        f"{TOL_KERNEL}); against the plain steps max_abs_err {dp:.6g} rel "
        f"{rp:.3g}; " + "; ".join(notes))
    if not (r <= TOL_KERNEL and rp <= TOL_KERNEL
            and torch.isfinite(got).all()):
        failed.append(f"{label} RDB: rel {r} vs the composition, {rp} vs "
                      "the plain steps")
    return failed, dp


def log_rdb_step_plans(torch, rdb, x) -> None:
    """Each step's launch on x (kernels/conv3x3_rdb.py: step_plan): the
    instantiation, grid, N tiles a sweep, stages, path and shared memory,
    beside that instantiation's registers and spills from the build log."""
    from neural_enhanced_super_resolution_torch.kernels import _build
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
        step_plan)
    tag = os.path.basename(_build.library_path())[len("libnesr_torch_"):-3]
    path = os.path.join(_build.build_dir(), f"build_{tag}.log")
    lines = open(path).read().splitlines() if os.path.exists(path) else []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, h, w, nf = x.shape
    out = []
    for k, wk in enumerate(rdb.weights()):
        cin, cout = wk.shape[2], wk.shape[3]
        p = step_plan(k, cin, cout, nf, n, h, w, sms)
        name = f"rdb_bf16_step_kernelILi{p.n_width}ELi{p.ks}E"
        regs = next((" | ".join(ln.split(":", 1)[-1].strip()
                                for ln in lines[i + 1:i + 4])
                     for i, line in enumerate(lines)
                     if "Compiling entry function" in line and name in line),
                    "not in the build log")
        out.append(f"step {k} ({cin}->{cout}) <{p.n_width},{p.ks}>: grid "
                   f"{p.grid}, {p.tiles} tiles, {p.nps} N tile(s) a sweep, "
                   f"{p.stages} stages, {'bulk' if p.bulk else 'cp.async'} "
                   f"path, {p.smem} B shared; ptxas: {regs}")
    log(f"K1 step launches on {tuple(x.shape)}: " + "; ".join(out))


def check_conv3x3_rdb(torch, gen) -> dict:
    """The K1 step (csrc/rdb_bf16.cu) on TILE_BATCH at full width (nf 64,
    growth 32) with and without the RRDB skip, at the trained fixture's
    widths (16, 8) on 1 x 80^2, at widths the 16-byte paths do not take
    (12, 4), and at full width on the persistent walk's edges (1 x 268^2,
    1 x 17 x 9) with and without the skip: each step against
    conv3x3_rdb_plain, the RDB against the composition on K1
    (check_rdb_bf16_steps); each step's launch and its instantiation's
    registers and spills. Then, on TILE_BATCH, device
    time of an RDB in turns: the five steps, the composition (five K1
    convs + the PyTorch assembly: the yardstick; no single PyTorch call
    computes an RDB), K2 and the K4 step (with its int8_amax) on the same
    weights; each step beside its bound and K1's bare conv of its shape;
    and torch.profiler's kernels of an RDB on the fused trunk: five, all
    the step's (and no PyTorch op dispatched but the buffers'
    allocations). Returns the kernels JSON row: an RDB's five launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv3x3)
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
        conv3x3_rdb)
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB, Int8RDB, quantize_rdb)
    failed = []
    n, h, w = TILE_BATCH
    rdb, fw, fb = _fused_rdb(torch, gen, 64, 32)
    x = _rnd(torch, gen, n, h, w, 64, scale=0.5)
    skip = _rnd(torch, gen, n, h, w, 64, scale=0.5)
    f, err = check_rdb_bf16_steps(torch, rdb, x, None, "trunk")
    failed += f
    failed += check_rdb_bf16_steps(torch, rdb, x, skip, "trunk")[0]
    fix, _, _ = _fused_rdb(torch, gen, 16, 8)
    failed += check_rdb_bf16_steps(
        torch, fix, _rnd(torch, gen, 1, 80, 80, 16, scale=0.5), None,
        "fixture")[0]
    odd, _, _ = _fused_rdb(torch, gen, 12, 4)
    failed += check_rdb_bf16_steps(
        torch, odd, _rnd(torch, gen, 2, 21, 35, 12, scale=0.5),
        _rnd(torch, gen, 2, 21, 35, 12, scale=0.5),
        "scalar paths (nf 12, g 4)")[0]
    # The persistent walk's edges: 1 x 268^2 is 1,139 tiles, which no grid
    # of at most 132 blocks of two consumers divides; 1 x 17 x 9 is 5 tiles
    # for 3 blocks, the last block's second consumer idle.
    for shape, label in (((1, 268, 268), "ragged walk"),
                         ((1, 17, 9), "fewer tiles than blocks")):
        xr = _rnd(torch, gen, *shape, 64, scale=0.5)
        failed += check_rdb_bf16_steps(torch, rdb, xr, None, label)[0]
        failed += check_rdb_bf16_steps(
            torch, rdb, xr, _rnd(torch, gen, *shape, 64, scale=0.5),
            label)[0]
    log_rdb_step_plans(torch, rdb, x)
    if failed:
        raise AssertionError(f"K1 step differs from its references: "
                             f"{failed}")

    # What an RDB on the fused trunk puts on the card: the profiler's
    # kernels (a window that loses events is taken again, at most three
    # times) and the PyTorch ops it dispatches.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rdb(x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if len(names) >= 5:
            break
    ops = aten_ops(lambda: rdb(x))
    foreign = [k for k in names if "rdb_bf16_step_kernel" not in k]
    bad_ops = [op for op in ops if not op.startswith("aten.empty")]
    log(f"K1 step: an RDB on the fused trunk puts {len(names)} kernels on "
        f"the card by torch.profiler, {len(names) - len(foreign)} of them "
        f"rdb_bf16_step_kernel, other kernels {sorted(set(foreign))}; "
        f"PyTorch ops it dispatches {sorted(set(ops))}")
    if foreign or bad_ops or not names:
        raise AssertionError(f"K1 step: an RDB launched {foreign} and "
                             f"dispatched {bad_ops} besides its steps")

    # Timing on TILE_BATCH, in turns.
    pix = n * h * w
    (bms, by), (dms, dby), per = rdb_bf16_bound(pix, 64, 32)
    dform = FusedRDB(fw, fb, torch.bfloat16, "cuda", kernel=True)
    k4 = Int8RDB(*quantize_rdb(fw), fb, "cuda")
    runs = {"steps": lambda: rdb(x), "composition": lambda: rdb._composition(x),
            "K2": lambda: dform(x), "K4 step": lambda: k4(x)}
    dev = {k: [] for k in runs}
    for key in ("steps", "composition", "K2", "K4 step", "K4 step", "K2",
                "composition", "steps"):
        dev[key].append(device_ms(runs[key], reps=10, floor_ms=dms))
    wms = wall_ms(runs["steps"])
    pms = device_ms(lambda: rdb(x, plain=True), reps=2)
    ms, cms = min(dev["steps"]), min(dev["composition"])
    log(f"K1 step rdb_bf16, one RDB (5 launches) on {tuple(x.shape)} bf16, "
        f"device ms in turns (steps, composition, K2, K4 step, K4 step, K2, "
        f"composition, steps): {dev}; bound {bms:.4f} ms ({by}), "
        f"bound/steps {bms / ms:.3f}; the five-launch design's floor "
        f"{dms:.4f} ms ({dby}), floor/steps {dms / ms:.3f}; "
        f"steps/composition {ms / cms:.3f}, "
        f"steps/K2 {ms / min(dev['K2']):.3f}, steps/K4 step "
        f"{ms / min(dev['K4 step']):.3f}; wall {wms:.4f} ms an RDB; plain "
        f"steps {pms:.4f} ms; yardstick (no single PyTorch call computes an "
        f"RDB): the composition {cms:.4f} ms")
    # Each step alone beside its bound and K1's bare conv of its shape.
    slots = torch.empty((n, h, w, 192), dtype=torch.bfloat16, device="cuda")
    srcs = [x] + [_rnd(torch, gen, n, h, w, 32, scale=0.5) for _ in range(4)]
    xn = torch.empty((n, h, w, 32), dtype=torch.bfloat16, device="cuda")
    for k, (wk, pk) in enumerate(zip(rdb.weights(), rdb.packed())):
        extra = dict(x=x) if k == 4 else dict(xn=xn)
        sk = device_ms(lambda k=k, wk=wk, pk=pk, e=extra: conv3x3_rdb(
            k, srcs[k], wk, rdb.b, slots, packed=pk, **e), reps=10,
            floor_ms=per[k][0])
        bare = device_ms(lambda k=k, wk=wk, pk=pk: conv3x3(
            srcs[k], wk, packed=pk), reps=10)
        log(f"K1 step {k} ({wk.shape[2]}->{wk.shape[3]}) on "
            f"{tuple(x.shape[:3])}: device {sk:.4f} ms, bound "
            f"{per[k][0]:.4f} ({per[k][1]}), bound/step "
            f"{per[k][0] / sk:.3f}; K1's bare conv {bare:.4f} ms")
    del dform, k4, srcs, slots, xn
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "max_abs_err": err}


def rdb_f32_bound(pix: int, nf: int, g: int, skip: bool = False) -> tuple:
    """The bound of one float32 RDB, the function the five float32 steps
    compute: its operations at 67 TFLOP/s (float32 on the CUDA cores;
    TF32 would change the result) against x (and skip) read and out
    written once, with the weights and biases, at 3.35 TB/s. Beside it
    the floor of the five-launch design, whose x_1..x_4 and slots pass
    through HBM between steps (rdb_bf16_bytes at 4 bytes a value), and
    each step's bound alone."""
    cins = [nf, g, g, g, g]
    couts = [4 * g + nf - k * g for k in range(5)]
    macs = sum(c * o for c, o in zip(cins, couts))
    params = 36.0 * macs + 4.0 * (4 * g + nf)
    nbytes = [2 * b for b in rdb_bf16_bytes(pix, nf, g, skip)]
    per = [bound(2.0 * pix * 9 * ci * co,
                 nb + 36.0 * ci * co + 4.0 * (4 * g + nf), PEAK_FP32_FLOPS)
           for ci, co, nb in zip(cins, couts, nbytes)]
    whole = bound(2.0 * pix * 9 * macs, (2 + skip) * 4.0 * pix * nf + params,
                  PEAK_FP32_FLOPS)
    design = bound(2.0 * pix * 9 * macs, sum(nbytes) + params,
                   PEAK_FP32_FLOPS)
    return whole, design, per


def _fused_rdb_f32(torch, gen, nf: int, g: int):
    """A float32 FusedRDB of widths (nf, g) on the card from seeded
    weights of std 0.05 and biases of std 0.1 (_fused_rdb's scale)."""
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    shapes = [(nf, 4 * g + nf), (g, 3 * g + nf), (g, 2 * g + nf),
              (g, g + nf), (g, nf)]
    fw = [torch.randn((3, 3, ci, co), generator=gen) * 0.05
          for ci, co in shapes]
    b = torch.randn((4 * g + nf,), generator=gen) * 0.1
    return FusedRDB(fw, b, torch.float32, "cuda", kernel=False)


def k1f_step(k, src, w, b, slots, x=None, skip=None):
    """Step k as FusedRDB._composition takes it in float32: K1f's
    bias-free conv (conv3x3_f32), then the step's slice of the assembly
    in PyTorch, slots updated in place."""
    import torch.nn.functional as F
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv3x3_f32)
    c = conv3x3_f32(src, w)
    g = src.shape[-1] if k else (w.shape[3] - src.shape[-1]) // 4
    lo = k * g
    if k == 4:
        y = x + 0.2 * (slots[..., lo:] + c + b[lo:])
        return y if skip is None else skip + 0.2 * y
    t = c[..., :g] if k == 0 else slots[..., lo:lo + g] + c[..., :g]
    if k == 0:
        slots[..., g:] = c[..., g:]
    else:
        slots[..., lo + g:] += c[..., g:]
    return F.leaky_relu(t + b[lo:lo + g], 0.2)


def _misaligned(torch, t):
    """A contiguous copy of float32 t that starts 4 bytes past a 16-byte
    boundary: the float32 kernels' 16-byte paths give way to their scalar
    forms there (csrc/rdb_f32.cu's epilogue, K1f's patch staging)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 != 4:
        raise AssertionError(f"misaligned copy at {view.data_ptr()}")
    return view


def check_rdb_f32_steps(torch, rdb, x, skip, label: str,
                        misalign: bool = False) -> tuple:
    """The float32 RDB step at one RDB's five steps, each against the
    composition's step on K1f (k1f_step: x_{k+1} or out and the whole slot
    buffer, bit for bit) and against conv3x3_rdb_plain (cuDNN, TF32 off;
    TOL_F32), on the same inputs; then the RDB on the steps against
    FusedRDB._composition (bit for bit; printed as the count of unequal
    values). With ``misalign`` the slots, x and skip sit 4 bytes past a
    16-byte boundary (_misaligned): every step's epilogue takes its scalar
    form and step 0's patch its 4-byte copies, and in the RDB (which makes
    its own slots) step 0's patch and step 4's epilogue. Returns the
    failures and the RDB's max|err| against its plain steps."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
        conv3x3_rdb, conv3x3_rdb_plain)
    failed, notes = [], []
    n, h, w, _ = x.shape
    g = rdb.gc
    slots = torch.zeros((n, h, w, rdb.b.numel()), device="cuda")
    if misalign:
        slots, x = _misaligned(torch, slots), _misaligned(torch, x)
        skip = None if skip is None else _misaligned(torch, skip)
        label += " (slots, x and skip at +4 bytes)"
    src = x
    for k, wk in enumerate(rdb.weights()):
        sl_c, sl_p = slots.clone(), slots.clone()
        extra = dict(x=x, skip=skip) if k == 4 else {}
        got = conv3x3_rdb(k, src, wk, rdb.b, slots, **extra)
        comp = k1f_step(k, src, wk, rdb.b, sl_c, **extra)
        ref = conv3x3_rdb_plain(k, src, wk, rdb.b, sl_p, **extra)
        torch.cuda.synchronize()
        lo = (k + 1) * g
        _, ry = rel_err(got, ref)
        _, rs = rel_err(slots[..., lo:], sl_p[..., lo:]) if k < 4 else (0, 0)
        bits = _same(got, comp) and _same(slots, sl_c)
        unequal = int((got != comp).sum()) + int((slots != sl_c).sum())
        notes.append(f"step {k}: {unequal} values unequal to the "
                     f"composition's step on K1f; vs plain rel {ry:.3g}, "
                     f"slots rel {rs:.3g}")
        if not (bits and ry <= TOL_F32 and rs <= TOL_F32):
            failed.append(f"{label} step {k}: bit for bit {bits} "
                          f"({unequal} unequal), rel {ry}, slots rel {rs}")
        src = got
    got = rdb(x, skip=skip)
    plain = rdb(x, plain=True, skip=skip)
    comp = rdb._composition(x)
    if skip is not None:
        comp = skip + 0.2 * comp
    torch.cuda.synchronize()
    d, r = rel_err(got, comp)
    dp, rp = rel_err(got, plain)
    unequal = int((got != comp).sum())
    log(f"float32 RDB step rdb_f32 {label} {tuple(x.shape)}"
        f"{' +skip' if skip is not None else ''}: the RDB on the steps "
        f"against FusedRDB._composition on K1f: {unequal} of {got.numel()} "
        f"values unequal, max_abs_err {d:.6g} (target bit for bit); "
        f"against the plain steps max_abs_err {dp:.6g} rel {rp:.3g} (tol "
        f"{TOL_F32}); " + "; ".join(notes))
    if not (_same(got, comp) and rp <= TOL_F32
            and torch.isfinite(got).all()):
        failed.append(f"{label} RDB: {unequal} unequal to the composition, "
                      f"rel {rp} vs the plain steps")
    return failed, dp


def check_conv3x3_rdb_f32(torch, gen) -> tuple:
    """The float32 RDB step (csrc/rdb_f32.cu) at each of an RDB's five
    steps (check_rdb_f32_steps) on TILE_BATCH at full width (nf 64,
    growth 32) with and without the RRDB skip, at nf 16 / g 8 on 1 x 80^2,
    at nf 12 / g 4 (a granule holds x_{k+1} and slot channels) with the
    skip, on a ragged 1 x 13 x 9 at full width with and without it, and,
    with and without the skip, its scalar forms: at full width on 1 x 72
    x 56 with the slots, x and skip 4 bytes off a 16-byte boundary, and at
    nf 18 / g 6 on 2 x 21 x 35 (K1f's 4-byte staging too);
    the RRDB fold (three RDBs, the third with skip) against the RRDB on
    the composition, bit for bit; by torch.profiler, that an RDB launches
    five rdb_f32_step_kernel and nothing else (and dispatches nothing but
    allocations). Then on TILE_BATCH, CUDA events in turns (steps,
    composition, composition, steps): an RDB and each step beside the
    composition's step on K1f, K1f's bare conv and the bound. Returns the
    kernels JSON row (an RDB's five launches) and the shapes the
    composition gave K1f."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv3x3_f32)
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
        conv3x3_rdb)
    k1mod = sys.modules[
        "neural_enhanced_super_resolution_torch.kernels.conv3x3"]
    failed = []
    n, h, w = TILE_BATCH
    rdb = _fused_rdb_f32(torch, gen, 64, 32)
    x = _rnd(torch, gen, n, h, w, 64, scale=0.5, dtype=torch.float32)
    skip = _rnd(torch, gen, n, h, w, 64, scale=0.5, dtype=torch.float32)
    k1f_shapes = set()
    with recording(k1mod, "conv3x3_f32", k1f_shapes, _conv_key):
        f, err = check_rdb_f32_steps(torch, rdb, x, None, "trunk")
        failed += f
        failed += check_rdb_f32_steps(torch, rdb, x, skip, "trunk")[0]
        fix = _fused_rdb_f32(torch, gen, 16, 8)
        failed += check_rdb_f32_steps(
            torch, fix, _rnd(torch, gen, 1, 80, 80, 16, scale=0.5,
                             dtype=torch.float32), None, "nf 16 g 8")[0]
        odd = _fused_rdb_f32(torch, gen, 12, 4)
        failed += check_rdb_f32_steps(
            torch, odd, _rnd(torch, gen, 2, 21, 35, 12, scale=0.5,
                             dtype=torch.float32),
            _rnd(torch, gen, 2, 21, 35, 12, scale=0.5, dtype=torch.float32),
            "nf 12 g 4")[0]
        xr = _rnd(torch, gen, 1, 13, 9, 64, scale=0.5, dtype=torch.float32)
        failed += check_rdb_f32_steps(torch, rdb, xr, None, "ragged")[0]
        failed += check_rdb_f32_steps(
            torch, rdb, xr, _rnd(torch, gen, 1, 13, 9, 64, scale=0.5,
                                 dtype=torch.float32), "ragged")[0]
        # The forms the checks above never reach (their own generator, so
        # that every later phase draws what it drew before): the scalar
        # epilogue at full width, its tensors 4 bytes off a 16-byte
        # boundary; g and nf not multiples of 4 (nf 18 / g 6: the scalar
        # epilogue, and K1f's 4-byte copies of the patch and the weights,
        # Cin 18 and 6), each with and without the skip.
        more = torch.Generator().manual_seed(SEED + 24)
        xs = _rnd(torch, more, 1, 72, 56, 64, scale=0.5, dtype=torch.float32)
        ss = _rnd(torch, more, 1, 72, 56, 64, scale=0.5, dtype=torch.float32)
        failed += check_rdb_f32_steps(torch, rdb, xs, None, "scalar",
                                      misalign=True)[0]
        failed += check_rdb_f32_steps(torch, rdb, xs, ss, "scalar",
                                      misalign=True)[0]
        odd6 = _fused_rdb_f32(torch, more, 18, 6)
        x6 = _rnd(torch, more, 2, 21, 35, 18, scale=0.5, dtype=torch.float32)
        failed += check_rdb_f32_steps(torch, odd6, x6, None, "nf 18 g 6")[0]
        failed += check_rdb_f32_steps(
            torch, odd6, x6, _rnd(torch, more, 2, 21, 35, 18, scale=0.5,
                                  dtype=torch.float32), "nf 18 g 6")[0]
        # The RRDB's residual folded into its third RDB's last step.
        folded = rdb(rdb(rdb(x)), skip=x)
        ref = x + 0.2 * rdb._composition(rdb._composition(
            rdb._composition(x)))
        torch.cuda.synchronize()
        fold_unequal = int((folded != ref).sum())
        log(f"float32 RDB step: the RRDB (three RDBs, the third with skip) "
            f"against the RRDB on the composition: {fold_unequal} of "
            f"{ref.numel()} values unequal (target bit for bit)")
        if not _same(folded, ref):
            failed.append(f"RRDB fold: {fold_unequal} values unequal")
        del folded, ref
    if failed:
        raise AssertionError(f"float32 RDB step differs from its "
                             f"references: {failed}")

    # What an RDB puts on the card in float32: the profiler's kernels (a
    # window that loses events is taken again, at most three times) and
    # the PyTorch ops it dispatches.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rdb(x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if len(names) >= 5:
            break
    ops = aten_ops(lambda: rdb(x))
    foreign = [k for k in names if "rdb_f32_step_kernel" not in k]
    bad_ops = [op for op in ops if not op.startswith("aten.empty")]
    log(f"float32 RDB step: an RDB puts {len(names)} kernels on the card by "
        f"torch.profiler, {len(names) - len(foreign)} of them "
        f"rdb_f32_step_kernel, other kernels {sorted(set(foreign))}; "
        f"PyTorch ops it dispatches {sorted(set(ops))}")
    if foreign or bad_ops or not names:
        raise AssertionError(f"float32 RDB step: an RDB launched {foreign} "
                             f"and dispatched {bad_ops} besides its steps")

    # Timing on TILE_BATCH, CUDA events, in turns.
    pix = n * h * w
    (bms, by), (dms, dby), per = rdb_f32_bound(pix, 64, 32)
    runs = {"steps": lambda: rdb(x),
            "composition": lambda: rdb._composition(x)}
    ev = {key: [] for key in runs}
    for key in ("steps", "composition", "composition", "steps"):
        ev[key].append(cuda_ms(runs[key], reps=5))
    pms = cuda_ms(lambda: rdb(x, plain=True), reps=2)
    ms, cms = min(ev["steps"]), min(ev["composition"])
    log(f"float32 RDB step rdb_f32, one RDB (5 launches) on "
        f"{tuple(x.shape)} float32, ms (CUDA events, 5 calls) in turns "
        f"(steps, composition, composition, steps): {ev}; bound "
        f"{bms:.4f} ms ({by}), bound/steps {bms / ms:.3f}; the five-launch "
        f"design's floor {dms:.4f} ms ({dby}); steps/composition "
        f"{ms / cms:.3f}; plain steps {pms:.4f} ms; yardstick (no single "
        f"PyTorch call computes an RDB): the composition {cms:.4f} ms")
    slots = torch.zeros((n, h, w, 192), device="cuda")
    srcs = [x] + [_rnd(torch, gen, n, h, w, 32, scale=0.5,
                       dtype=torch.float32) for _ in range(4)]
    xn = torch.empty((n, h, w, 32), device="cuda")
    for k, wk in enumerate(rdb.weights()):
        extra = dict(x=x) if k == 4 else dict(xn=xn)
        sl = slots.clone()
        fns = {"step": lambda k=k, wk=wk, e=extra: conv3x3_rdb(
                   k, srcs[k], wk, rdb.b, slots, **e),
               "composition's step": lambda k=k, wk=wk: k1f_step(
                   k, srcs[k], wk, rdb.b, sl, **({"x": x} if k == 4
                                                 else {})),
               "K1f conv": lambda k=k, wk=wk: conv3x3_f32(srcs[k], wk)}
        t = {key: [] for key in fns}
        for key in ("step", "composition's step", "K1f conv", "K1f conv",
                    "composition's step", "step"):
            t[key].append(cuda_ms(fns[key], reps=5))
        sk = min(t["step"])
        log(f"float32 RDB step {k} ({wk.shape[2]}->{wk.shape[3]}) on "
            f"{tuple(x.shape[:3])}: ms (CUDA events, 5 calls) in turns "
            f"{t}; bound {per[k][0]:.4f} ({per[k][1]}), bound/step "
            f"{per[k][0] / sk:.3f}; step - K1f conv "
            f"{sk - min(t['K1f conv']):.4f} ms")
    del srcs, slots, xn, sl
    torch.cuda.empty_cache()
    return ({"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
             "library_ms": None, "max_abs_err": err}, sorted(k1f_shapes))


def check_f32_unaligned(torch) -> None:
    """K1f's SAME conv and its head 3x3 and 2x2 forms through their C
    entries with x, w, the bias and y each 4 bytes past a 16-byte boundary
    (the wrappers allocate y themselves, always aligned; an allocator that
    does not would hand the kernels such a y), bit for bit against the
    wrappers' aligned results: the epilogue's float4 stores take a y that
    is 16-byte aligned only, else a float at a time (before that check a
    misaligned y faulted with a misaligned address)."""
    from neural_enhanced_super_resolution_torch.kernels import (
        _build, conv2x2_s2d_f32, conv3x3_f32, conv3x3_head_f32)
    lib, stream = _build.load_library(), _build.stream_ptr()
    gen = torch.Generator().manual_seed(SEED + 25)
    lrelu, mask, d2s = 1, 4, 8
    cases = [  # (label, entry, x, Cout, taps, pad, flags, wrapper)
        ("K1f 64->64", "nesr_conv3x3_f32", (1, 40, 40, 64), 64, 3, None,
         lrelu, lambda x, w, b: conv3x3_f32(x, w, b, True)),
        ("head 3x3 up1 64->256 d2s", "nesr_conv3x3_head_f32",
         (1, 40, 40, 64), 256, 3, None, lrelu | d2s,
         lambda x, w, b: conv3x3_head_f32(x, w, b, True, True)),
        ("head 3x3 up2 64->256", "nesr_conv3x3_head_f32", (1, 80, 80, 64),
         256, 3, None, lrelu, lambda x, w, b: conv3x3_head_f32(x, w, b,
                                                               True)),
        ("2x2 hr 256->256 pad 1 mask", "nesr_conv2x2_f32", (1, 40, 40, 256),
         256, 2, 1, lrelu | mask,
         lambda x, w, b: conv2x2_s2d_f32(x, w, b, True, 1, True, False))]
    notes, failed = [], []
    for label, entry, shape, cout, taps, pad, flags, wrap in cases:
        x = _rnd(torch, gen, *shape, dtype=torch.float32)
        w = _rnd(torch, gen, taps, taps, shape[3], cout, scale=0.05,
                 dtype=torch.float32)
        b = _rnd(torch, gen, cout, scale=0.1, dtype=torch.float32)
        ref = wrap(x, w, b)
        xs, ws, bs = (_misaligned(torch, t) for t in (x, w, b))
        ys = _misaligned(torch, torch.full_like(ref, float("nan")))
        dims = [*shape, cout] + ([] if pad is None else [pad])
        err = getattr(lib, entry)(xs.data_ptr(), ws.data_ptr(), bs.data_ptr(),
                                  ys.data_ptr(), *dims, flags, stream)
        _build.check(entry, err)
        torch.cuda.synchronize()
        unequal = int((ys != ref).sum())
        notes.append(f"{label} {unequal} of {ref.numel()} unequal")
        if not _same(ys, ref):
            failed.append(label)
    log("float32 forms through their C entries with x, w, bias and y at "
        "+4 bytes (scalar stores) against the wrappers' aligned results: "
        + "; ".join(notes) + " (target bit for bit)")
    if failed:
        raise AssertionError(f"float32 forms at +4 bytes differ: {failed}")


def check_forward_int8(torch, gen, sd, name: str) -> None:
    """The full-width int8 trunk on the 4-tile batch: against the same
    model on the plain versions (TOL_FORWARD) and its trunk bit for bit
    against the plain trunk; no quantize_int8, no plain call and no host
    sync on the kernel path (sync debug mode "error"), 345 step, 1
    int8_amax, 2 K1 (conv_first, conv_body), 2 K1 head 3x3-form and 2 K1
    2x2-form launches (the folded head: up1, up2, hr, last); against the
    fused bf16 trunk (PSNR of the uint8 outputs);
    device ms and wall in turns with the K4 composition (quantise, K4, the
    PyTorch assembly), the fused and the dform trunk, each split by kernel
    family; the folded head on the int8 trunk (check_head)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neural_enhanced_super_resolution_torch.kernels import (
        conv2x2_s2d, conv2x2_s2d_plain, conv3x3, conv3x3_head, conv3x3_int8,
        conv3x3_int8_plain, conv3x3_int8_rdb, conv3x3_int8_rdb_plain,
        conv3x3_plain, int8_amax, int8_amax_plain)
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig)
    from neural_enhanced_super_resolution_torch.models import rrdbnet

    cfg = RRDBNetConfig(**ARCH)
    n, h, w = TILE_BATCH
    x = torch.rand((n, h, w, 12), generator=gen).to("cuda")
    model = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "int8")
    ref = model(x, plain=True)
    feat = model.conv_first(x.to(torch.bfloat16))
    body_ref = model.body_forward(feat, plain=True)
    counters = (conv3x3, conv3x3_int8_rdb, int8_amax, conv3x3_int8,
                conv2x2_s2d, conv3x3_head)
    plains = (conv3x3_plain, conv3x3_int8_rdb_plain, int8_amax_plain,
              conv3x3_int8_plain, conv2x2_s2d_plain)
    before = [c.launches for c in counters] + [c.calls for c in plains]
    seen = []
    real = rrdbnet.quantize_int8

    def spy(t):
        seen.append(tuple(t.shape))
        return real(t)

    rrdbnet.quantize_int8 = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model(x)
            body = model.body_forward(feat)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        rrdbnet.quantize_int8 = real
    counts = [a - b for a, b in zip(
        [c.launches for c in counters] + [c.calls for c in plains], before)]
    # Two trunk passes (the forward's and body_forward's), one head.
    k1, k4s, amax, k4, k2x2, khead = (counts[0], counts[1] // 2,
                                      counts[2] // 2, counts[3], counts[4],
                                      counts[5])
    d, r = rel_err(out, ref)
    body_same = _same(body, body_ref)
    del ref, body_ref, body
    fused = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "fused")
    dform = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "dform")
    out_f = fused(x)

    def u8(t):
        return torch.clamp(t * 255.0, 0.0, 255.0).to(torch.uint8).float()

    mse = torch.mean((u8(out) - u8(out_f)) ** 2).item()
    p = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    del out, out_f
    torch.cuda.empty_cache()
    # The K4 composition: the same int8 model with its trunk run as
    # composition_body (quantize_int8 -> conv3x3_int8 -> the assembly).
    comp = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "int8")
    comp.body_forward = lambda f, plain=False: composition_body(comp, f)
    # The fused trunk on its composition: each RDB five K1 convs with
    # the assembly in PyTorch (FusedRDB._composition), each RRDB's
    # residual a separate add.
    fcomp = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "fused")
    for block in fcomp.body:
        for rdb in block.rdbs:
            rdb.folds_skip = lambda t: False
    runs = {"composition": comp, "int8": model, "fused": fused,
            "dform": dform, "fused composition": fcomp}
    dev = {k: [] for k in runs}
    wall = {k: [] for k in runs}
    for key in ("composition", "int8", "fused", "dform", "fused composition",
                "fused composition", "dform", "fused", "int8",
                "composition"):
        m = runs[key]
        dev[key].append(device_ms(lambda: m(x), reps=3))
        wall[key].append(wall_ms(lambda: m(x), reps=3))
    # K1's head instantiations (conv_first <64,1>; conv_body <64,4>; the
    # folded head's forms); the fused trunk's five convs take the others.
    head = ("conv3x3_kernel<64,1>", "conv3x3_kernel<64,4>",
            "conv3x3_head_kernel", "conv2x2_kernel")
    fams = ("K4 step", "int8_amax", "K4", "K2", "K1 step", "K1 trunk",
            "K1 head", "other")

    def families(m):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m(x)
            torch.cuda.synchronize()
        fam = dict.fromkeys(fams, 0.0)
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            nm = e.name.replace(" ", "")
            key = ("K4 step" if "rdb_int8_step_kernel" in nm else
                   "K1 step" if "rdb_bf16_step_kernel" in nm else
                   "int8_amax" if "amax_kernel" in nm else
                   "K4" if "conv3x3_int8_kernel" in nm else
                   "K2" if "rdb_fused_kernel" in nm else
                   "K1 head" if any(k in nm for k in head) else
                   "K1 trunk" if "conv3x3_kernel" in nm else "other")
            fam[key] += e.time_range.elapsed_us() / 1e3
        return {k: v for k, v in fam.items() if v}

    mp_out = n * (4 * h) * (4 * w) / 1e6
    log(f"forward int8 trunk (K4 step + K1) 12ch x4 nf64 nb23 gc32 on "
        f"{tuple(x.shape)}: max_abs_err {d:.6g} rel {r:.3g} vs the plain "
        f"versions (tol {TOL_FORWARD}); trunk "
        f"{'bitwise equal' if body_same else 'DIFFERENT'} to the plain "
        f"trunk; uint8 PSNR vs the fused bf16 trunk {p:.2f} dB; a forward "
        f"launches K4 step {k4s}, int8_amax {amax}, K1 {k1}, K4 {k4}, K1 "
        f"2x2 form {k2x2}, K1 head 3x3 form {khead}; plain calls "
        f"{counts[6:]}; quantize_int8 calls "
        f"{len(seen)}; no host sync (sync debug mode error)")
    log(f"forward device ms in turns (composition, int8, fused, dform, "
        f"fused composition, and back) {dev}; wall ms {wall}; int8 "
        f"{mp_out / (min(dev['int8']) / 1e3):.3f} MP_out/s of device time "
        f"on {name}")
    for key, m in runs.items():
        fam = families(m)
        tot = sum(fam.values())
        log(f"forward {key} split (device ms, one forward, {tot:.3f} in "
            "all): " + ", ".join(f"{k} {v:.3f} ({100 * v / tot:.1f}%)"
                                 for k, v in fam.items()))
    want = (15 * cfg.num_block, 1, K1_FOLDED, 0, K1_2X2, K1_HEAD)
    got = (k4s, amax, k1, k4, k2x2, khead)
    if not (r <= TOL_FORWARD and body_same and got == want
            and not any(counts[6:]) and not seen):
        raise AssertionError(
            f"int8 forward: rel err {r}, trunk bitwise {body_same}, "
            f"launches step/amax/K1/K4/2x2/head 3x3 {got} (want {want}), "
            f"plain calls {counts[6:]}, quantize_int8 calls {len(seen)}")
    check_head(torch, model, x, TOL_FORWARD, name)
    del model, fused, dform, comp, fcomp
    torch.cuda.empty_cache()


def _quality_requests(torch, device: str):
    """The JAX package's int8 quality gate (tests/test_quality.py) as
    requests on ``device``: the trained fixture on the fixture image
    downscaled 2x, exact and int8 trunk; returns (hr, exact, int8)."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.ops.resize import resize
    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb
    hr = torch.from_numpy(imread_rgb(os.path.join(ROOT, "tests", "fixtures",
                                                  "test.jpeg")))
    lr = resize(hr, dsize=(hr.shape[1] // 2, hr.shape[0] // 2),
                interpolation="bicubic").numpy()
    common = {"iterations": 1, "use_diffusion": False,
              "segment_enhancement": False, "denoise_level": 0,
              "adaptive_sharpening": False, "esrgan_model_path": FIXTURE_CKPT,
              "esrgan_arch": dict(FIXTURE_ARCH),
              "output_dir": os.path.join(OUT, "quality")}
    outs = [SuperResolutionPipeline(device, dict(
        common, esrgan_trunk=trunk)).enhance_array(lr)
        for trunk in (None, "int8")]
    return hr.numpy(), outs[0], outs[1]


def check_int8_quality(torch, np) -> None:
    """The int8 quality gate on the card with the bars of
    tests/test_quality.py: int8 vs the exact (bf16) trunk > 40 dB, and
    |dPSNR| against the Lanczos-upscaled original < 0.15 dB."""
    from neural_enhanced_super_resolution_torch.ops.resize import resize
    from neural_enhanced_super_resolution_torch.utils import psnr
    _zero_counts()
    hr, exact, q = _quality_requests(torch, "cuda")
    c = _counts()
    ref = resize(torch.from_numpy(hr), dsize=(q.shape[1], q.shape[0]),
                 interpolation="lanczos4").numpy()
    cross = psnr(q, exact)
    dq, de = psnr(q, ref), psnr(exact, ref)
    log(f"int8 quality gate on the card (trained fixture, 80x80 -> "
        f"{q.shape[1]}x{q.shape[0]}): PSNR int8 vs exact bf16 trunk "
        f"{cross:.2f} dB (bar > 40); vs the Lanczos reference int8 "
        f"{dq:.4f} dB, exact {de:.4f} dB, |dPSNR| {abs(dq - de):.4f} (bar "
        f"< 0.15); counts {c}")
    if not (q.shape == exact.shape and cross > 40.0
            and abs(dq - de) < 0.15 and _int8_path_ok(c)
            and c["conv3x3_rdb"] > 0):
        raise AssertionError("int8 quality gate failed on the card")


def _int8_counters():
    from neural_enhanced_super_resolution_torch import kernels as k
    return ({"conv3x3": k.conv3x3, "conv3x3_head": k.conv3x3_head,
             "conv3x3_int8": k.conv3x3_int8,
             "conv3x3_int8_rdb": k.conv3x3_int8_rdb,
             "int8_amax": k.int8_amax, "conv2x2_s2d": k.conv2x2_s2d,
             "conv3x3_rdb": k.conv3x3_rdb},
            {"conv3x3_plain": k.conv3x3_plain,
             "conv3x3_rdb_plain": k.conv3x3_rdb_plain,
             "conv2x2_s2d_plain": k.conv2x2_s2d_plain,
             "conv3x3_int8_plain": k.conv3x3_int8_plain,
             "conv3x3_int8_rdb_plain": k.conv3x3_int8_rdb_plain,
             "int8_amax_plain": k.int8_amax_plain})


def _counts():
    kernels, plains = _int8_counters()
    return {**{key: f.launches for key, f in kernels.items()},
            **{key: f.calls for key, f in plains.items()}}


def _zero_counts():
    kernels, plains = _int8_counters()
    for f in kernels.values():
        f.launches = 0
    for f in plains.values():
        f.calls = 0


def _int8_path_ok(c: dict) -> bool:
    """The int8 trunk ran on the step kernel: steps and one int8_amax a
    forward, the standalone K4 never, no plain version."""
    return (c["conv3x3_int8_rdb"] > 0 and c["int8_amax"] > 0
            and c["conv3x3_int8_rdb"] % 15 == 0 and c["conv3x3_int8"] == 0
            and not any(c[k] for k in c if k.endswith("_plain")))


def drive_int8_and_parity(torch, np, ckpt: str, name: str) -> dict:
    """The two config modes through the entry points, each with the
    launch counts zeroed before it and read after it: an int8 request at
    1024x768 in process (timed, then profiled), an int8 CLI request, and a
    parity-tiling request (memory_efficient) at 1024x768 in process."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb
    rng = np.random.default_rng(SEED + 20)
    small = rng.integers(0, 256, (768 // 8, 1024 // 8, 3), dtype=np.uint8)
    img = np.kron(small, np.ones((8, 8, 1), np.uint8))
    base = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "iterations": 1, "esrgan_model_path": ckpt,
            "output_dir": os.path.join(OUT, "modes_out")}
    counts = {}
    for label, extra, want in (
            ("int8", {"esrgan_trunk": "int8"}, (3072, 4096, 3)),
            ("parity", {"parity_tiling": True, "memory_efficient": True},
             (1536, 2048, 3))):
        pipe = SuperResolutionPipeline("cuda", dict(base, **extra))
        pipe._load_models()   # set-up: weights to the card before the window
        _zero_counts()
        out, stages = timed_request(
            torch, pipe, img, f"{label} request 1024x768 -n 1 ({extra})",
            name)
        counts[label] = c = _counts()
        log(f"{label} request 1024x768 counts (both runs) {c}")
        int8_ok = (_int8_path_ok(c) and not c["conv3x3_rdb"]
                   if label == "int8" else not (
                       c["conv3x3_int8_rdb"] or c["int8_amax"]
                       or c["conv3x3_int8"] or not c["conv3x3_rdb"]
                       or any(c[k] for k in c if k.endswith("_plain"))))
        if (out.shape != want or out.std() == 0 or c["conv3x3"] == 0
                or c["conv2x2_s2d"] == 0 or not int8_ok):
            raise AssertionError(f"{label} request: output {out.shape} "
                                 f"(want {want}), counts {c}")
        del pipe
        torch.cuda.empty_cache()
    cfg = os.path.join(OUT, "int8_cli_config.json")
    with open(cfg, "w") as f:
        json.dump(dict(base, esrgan_trunk="int8"), f)
    dst = os.path.join(OUT, "int8_cli", "result.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_COUNTED, "--cli", "-i",
         os.path.join(ROOT, "tests", "fixtures", "test.jpeg"), "-c", cfg,
         "-n", "1", "-o", dst, "-d", "cuda"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("int8 CLI failed:\n" + proc.stdout[-3000:]
                             + proc.stderr[-3000:])
    c = json.loads(next(line for line in proc.stdout.splitlines()
                        if line.startswith("COUNTS "))[7:])
    got = imread_rgb(dst)
    log(f"int8 CLI request 160x160 -n 1: rc 0 in {wall:.2f} s, output "
        f"{got.shape}, counts {c}")
    if (got.shape != (640, 640, 3) or got.std() == 0 or c["conv3x3"] == 0
            or c["conv2x2_s2d"] == 0 or not _int8_path_ok(c)
            or c["conv3x3_rdb"]):
        raise AssertionError(f"int8 CLI: output {got.shape}, counts {c}")
    counts["int8_cli"] = c
    return counts


def check_parity_against_cpu(torch, np, ckpt: str) -> None:
    """A parity-tiling request at num_block 1 on a 96x72 image (2 x 2
    tiles of 48 and the probe) on the card in bf16 against the same
    request on the CPU in float32: PSNR of the uint8 outputs (the bar of
    check_against_cpu)."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    base = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "iterations": 1, "esrgan_model_path": ckpt,
            "esrgan_arch": {"num_block": 1}, "parity_tiling": True,
            "memory_efficient": True, "max_tile_size": 48,
            "output_dir": os.path.join(OUT, "ref")}
    rng = np.random.default_rng(SEED + 21)
    img = np.kron(rng.integers(0, 256, (9, 12, 3), dtype=np.uint8),
                  np.ones((8, 8, 1), np.uint8))
    t0 = time.perf_counter()
    ref = SuperResolutionPipeline("cpu", base).enhance_array(img).astype(
        np.float64)
    cpu_s = time.perf_counter() - t0
    _zero_counts()
    got = SuperResolutionPipeline("cuda", base).enhance_array(img).astype(
        np.float64)
    c = _counts()
    mse = float(np.mean((got - ref) ** 2))
    p = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log(f"parity-tiling request 96x72 (nb 1, 48-px tiles), bf16 card vs "
        f"CPU float32 ({cpu_s:.2f} s there): PSNR {p:.2f} dB, max diff "
        f"{np.abs(got - ref).max():.0f} (bar 30 dB); card counts {c}")
    if (got.shape != ref.shape or got.shape != (144, 192, 3)
            or not p >= 30.0 or c["conv3x3"] == 0 or c["conv3x3_plain"]
            or not _steps_ran(c)):
        raise AssertionError(f"parity card vs CPU: {got.shape} PSNR {p}, "
                             f"counts {c}")


# ---- The single-device surface: precompile, overlapped output, vae_encode,
# ---- float32 ---------------------------------------------------------------

STREAM_REQUEST = (1200, 1600)   # 5 x 7 = 35 tiles of 256: chunks 16, 16, 3
VAE_ENCODE_INPUT = 512          # a 512^2 image -> a 128^2 latent, S 16384


def drive_precompile(name: str) -> None:
    """tools/torch_precompile.py in a subprocess: it builds the kernel
    library and the host stager from the sources; its build seconds, and
    the process's wall."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_precompile.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"precompile: {line}")
    log(f"precompile subprocess: rc {proc.returncode} in {wall:.2f} s "
        f"(process start included) on {name}")
    if proc.returncode != 0:
        raise AssertionError("tools/torch_precompile.py failed:\n"
                             + proc.stdout[-3000:] + proc.stderr[-3000:])


def drive_streamed_overlap(torch, np, ckpt: str, name: str) -> dict:
    """A 1600x1200 ESRGAN-only enhance_array (35 tiles, three chunks of 16,
    the last partial) on the overlapped streamed final, and the same
    request with the final's tiler swapped for the blocking form it
    replaced (each chunk's cores ``.cpu()`` before the next chunk runs),
    in turns (ABBA twice), then one profiled run of each for its
    device-busy share. The outputs are equal bit for bit. Launch counts
    over all ten runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch import pipeline as pipeline_mod
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3, conv3x3_plain)
    from neural_enhanced_super_resolution_torch.parallel import tiling
    from neural_enhanced_super_resolution_torch.runtime.profiler import (
        StageTimer)

    overlapped = pipeline_mod.process_tiled_to_host

    def blocking(model_fn, image, tile_size, halo, scale, batch_tiles,
                 cancel_check):
        tiles, ny, nx, oh, ow = tiling._tile_grid(image, tile_size, halo)
        to, ho = tile_size * scale, halo * scale
        canvas = None
        for start, chunk in tiling._chunks(tiles, batch_tiles, cancel_check):
            cores = model_fn(chunk)[:, ho:ho + to, ho:ho + to, :]
            cores = cores.cpu().numpy()
            if canvas is None:
                canvas = np.empty((ny * to, nx * to, cores.shape[-1]),
                                  dtype=cores.dtype)
            tiling._land(canvas, cores, start, nx, to)
        return canvas[:oh * scale, :ow * scale, :]

    rng = np.random.default_rng(SEED + 30)
    hh, ww = STREAM_REQUEST
    img = np.kron(rng.integers(0, 256, (hh // 8, ww // 8, 3), dtype=np.uint8),
                  np.ones((8, 8, 1), np.uint8))
    pipe = SuperResolutionPipeline("cuda", {
        "use_diffusion": False, "segment_enhancement": False,
        "denoise_level": 0, "iterations": 1, "esrgan_model_path": ckpt,
        "output_dir": os.path.join(OUT, "stream_out")})
    pipe._load_models()   # set-up: weights to the card before the window
    conv3x3.launches = conv3x3_plain.calls = 0
    _zero_steps()
    outs, stage_s, busy = {}, {"overlapped": [], "blocking": []}, {}
    try:
        for variant in ("overlapped", "blocking", "blocking", "overlapped",
                        "overlapped", "blocking", "blocking", "overlapped",
                        "profile overlapped", "profile blocking"):
            kind = variant.split()[-1]
            pipeline_mod.process_tiled_to_host = (
                overlapped if kind == "overlapped" else blocking)
            pipe.timer = StageTimer()
            torch.cuda.synchronize()
            if variant.startswith("profile"):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    pipe.enhance_array(img)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                spans = [(e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not e.name.startswith("nesr/")]
                dev = sum(end - start for start, end in spans) / 1e6
                busy[kind] = (wall, dev, device_gaps(spans))
                continue
            t0 = time.perf_counter()
            out = pipe.enhance_array(img)
            wall = time.perf_counter() - t0
            stage_s[kind].append((pipe.timer.totals["esrgan+post/streamed"],
                                  wall))
            outs.setdefault(kind, out)
    finally:
        pipeline_mod.process_tiled_to_host = overlapped
    counts = {"conv3x3": conv3x3.launches,
              "conv3x3_plain": conv3x3_plain.calls, **_step_counts()}
    for kind in ("overlapped", "blocking"):
        wall, dev, (union, gaps) = busy[kind]
        st = [t for t, _ in stage_s[kind]]
        log(f"streamed final {ww}x{hh} -n 1, {kind} copies: "
            f"esrgan+post/streamed mean {sum(st) / len(st):.4f} s (" +
            ", ".join(f"{t:.3f}" for t in st) + "; requests " +
            ", ".join(f"{w:.3f}" for _, w in stage_s[kind])
            + f" s); profiled request {wall:.3f} s, device busy {dev:.3f} s "
            f"({100 * dev / wall:.1f}% busy; {union:.3f} s with concurrent "
            "work counted once); device idle gaps over 1 ms (start ms after "
            "the first device event, length ms): " + ", ".join(
                f"{g0:.1f}+{gl:.2f}" for g0, gl in gaps) + f" on {name}")
    equal = np.array_equal(outs["overlapped"], outs["blocking"])
    log(f"streamed final {ww}x{hh}: output {outs['overlapped'].shape}, "
        f"overlapped == blocking bit for bit: {equal}; counts (ten runs) "
        f"{counts}")
    if (not equal or outs["overlapped"].shape != (4 * hh, 4 * ww, 3)
            or counts["conv3x3"] == 0 or counts["conv3x3_plain"]
            or not _steps_ran(counts)):
        raise AssertionError(f"streamed final: equal {equal}, counts "
                             f"{counts}")
    del pipe
    torch.cuda.empty_cache()
    return counts


def device_gaps(spans, min_ms: float = 1.0) -> tuple[float, list]:
    """From (start, end) us of a run's device events: the busy seconds
    with overlapping events counted once, and the idle gaps longer than
    ``min_ms`` as (ms after the first event, ms long), in time order."""
    spans = sorted(spans)
    if not spans:
        return 0.0, []
    busy, gaps = 0.0, []
    cur0, cur1 = spans[0]
    for start, end in spans[1:] + [(float("inf"), float("inf"))]:
        if start > cur1:
            busy += cur1 - cur0
            if start - cur1 > min_ms * 1e3 and start != float("inf"):
                gaps.append(((cur1 - spans[0][0]) / 1e3,
                             (start - cur1) / 1e3))
            cur0, cur1 = start, end
        else:
            cur1 = max(cur1, end)
    return busy / 1e6, gaps


def vae_encode_flops(cfg, h: int, w: int) -> float:
    """FLOPs of vae_encode on one h x w image: every conv (2 x outputs x
    Cin x k^2), the mid-block's four projections and its attention
    (4 S^2 d)."""
    b, lat = cfg.block_out_channels, cfg.latent_channels

    def conv(hh, ww, cin, cout, k=3):
        return 2.0 * hh * ww * cin * cout * k * k

    def resnet(hh, ww, cin, cout):
        return (conv(hh, ww, cin, cout) + conv(hh, ww, cout, cout)
                + (conv(hh, ww, cin, cout, 1) if cin != cout else 0.0))

    flops, c, hh, ww = conv(h, w, cfg.in_channels, b[0]), b[0], h, w
    for bi, cout in enumerate(b):
        for _ in range(cfg.layers_per_block):
            flops += resnet(hh, ww, c, cout)
            c = cout
        if bi < len(b) - 1:
            hh, ww = hh // 2, ww // 2
            flops += conv(hh, ww, c, c)
    s = hh * ww
    flops += 2 * resnet(hh, ww, c, c) + 4 * 2.0 * s * c * c + 4.0 * s * s * c
    return flops + conv(hh, ww, c, 2 * lat) + conv(hh, ww, 2 * lat, 2 * lat,
                                                    1)


def drive_vae_encode(torch, snap: str, name: str) -> dict:
    """vae_encode of the full-width SD x4 VAE (block_out 128/256/512, two
    layers a block, loaded strictly with its encoder from the snapshot) on
    a 512^2 image: K3 runs the mid-block attention (S 16384, d 512) once an
    encode, counted over the encodes of the window; then the same encode on
    flash_attention_plain (outside the window), bar TOL_SD of max|ref|;
    device ms and wall beside the bound."""
    from neural_enhanced_super_resolution_torch.kernels import (
        flash_attention, flash_attention_plain)
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        load_upscale_pipeline, vae_encode)
    pipe = load_upscale_pipeline(snap, device="cuda")
    vae = pipe.vae
    gen = torch.Generator("cuda").manual_seed(SEED + 31)
    n = VAE_ENCODE_INPUT
    img = torch.rand((1, n, n, 3), generator=gen, device="cuda") * 2 - 1

    encodes = [0]

    def fn():
        encodes[0] += 1
        return vae_encode(vae, img)

    flash_attention.launches = flash_attention_plain.calls = 0
    got = fn()
    ms = device_ms(fn, reps=3)
    wall = wall_ms(fn, reps=3)
    torch.cuda.synchronize()
    n_enc = encodes[0]
    counts = {"flash_attention": flash_attention.launches,
              "flash_attention_plain": flash_attention_plain.calls}
    with plain_attention():
        ref = fn()
        pms = device_ms(fn, reps=2)
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    # bytes: the encoder's and quant_conv's parameters (bf16 weights, f32
    # biases and norms), the f32 image in and the f32 moments out, once
    flops = vae_encode_flops(vae.cfg, n, n)
    nbytes = sum(p.numel() * p.element_size()
                 for m in (vae.encoder, vae.quant_conv)
                 for p in m.parameters()) + img.numel() * 4 + \
        got.numel() * 4
    bms, by = bound(flops, nbytes)
    log(f"vae_encode 1x{n}x{n}x3 -> {tuple(got.shape)} (K3 at S "
        f"{(n // 4) ** 2}, d {vae.cfg.block_out_channels[-1]}): device "
        f"{ms:.3f} ms, wall {wall:.3f} ms, bound {bms:.4f} ms ({by}; "
        f"{flops / 1e12:.3f} TFLOP); plain attention device {pms:.3f} ms; "
        f"max_abs_err {err:.6g} rel {rel:.3g} (tol {TOL_SD}); K3 launches "
        f"{counts['flash_attention']} in {n_enc} encodes, plain calls "
        f"{counts['flash_attention_plain']} on {name}")
    if (counts != {"flash_attention": n_enc, "flash_attention_plain": 0}
            or not rel <= TOL_SD or not torch.isfinite(got).all()
            or tuple(got.shape) != (1, n // 4, n // 4, 8)):
        raise AssertionError(f"vae_encode: rel {rel}, counts {counts}, "
                             f"shape {tuple(got.shape)}")
    del pipe, vae
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def recording(module, name: str, shapes: set, key):
    """Record ``key(*args)`` of every call of ``module.name``; the call
    goes through to it. A wrapper counts its launches on the object its
    own name holds, the recorder while it stands in, so the count is
    carried over to the recorder and back."""
    fn = getattr(module, name)

    def rec(*args, **kw):
        shapes.add(key(*args, **kw))
        return fn(*args, **kw)

    rec.launches = fn.launches
    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, fn)
        fn.launches = rec.launches


@contextlib.contextmanager
def counting_calls(owner, name: str):
    """Counts the calls of ``owner.name`` (a method: every instance's)
    while the context lasts; yields a one-item list, the count."""
    fn, box = getattr(owner, name), [0]

    def counted(*args, **kw):
        box[0] += 1
        return fn(*args, **kw)

    setattr(owner, name, counted)
    try:
        yield box
    finally:
        setattr(owner, name, fn)


def _f32_counts():
    from neural_enhanced_super_resolution_torch.kernels import (
        conv2x2_s2d, conv2x2_s2d_f32, conv2x2_s2d_plain, conv3x3,
        conv3x3_f32, conv3x3_plain, flash_attention, flash_attention_f32,
        flash_attention_plain)
    return {"conv3x3_f32": conv3x3_f32.launches,
            "conv2x2_s2d_f32": conv2x2_s2d_f32.launches,
            "flash_attention_f32": flash_attention_f32.launches,
            "conv3x3": conv3x3.launches,
            "conv2x2_s2d": conv2x2_s2d.launches,
            "flash_attention": flash_attention.launches,
            "conv3x3_plain": conv3x3_plain.calls,
            "conv2x2_s2d_plain": conv2x2_s2d_plain.calls,
            "flash_attention_plain": flash_attention_plain.calls,
            **_step_counts()}


def _zero_f32_counts():
    from neural_enhanced_super_resolution_torch.kernels import (
        conv2x2_s2d, conv2x2_s2d_f32, conv2x2_s2d_plain, conv3x3,
        conv3x3_f32, conv3x3_plain, flash_attention, flash_attention_f32,
        flash_attention_plain)
    for fn in (conv3x3, conv3x3_f32, conv2x2_s2d, conv2x2_s2d_f32,
               flash_attention, flash_attention_f32):
        fn.launches = 0
    conv3x3_plain.calls = flash_attention_plain.calls = 0
    conv2x2_s2d_plain.calls = 0
    _zero_steps()


def _conv_key(x, w, bias=None, lrelu=False, d2s=False):
    """A K1f call's shape: (N, H, W, Cin, Cout, bias, lrelu, d2s)."""
    return (*x.shape, w.shape[3], bias is not None, bool(lrelu), bool(d2s))


def _conv2x2_key(x, w, bias, lrelu, pad, mask, d2s):
    """A call of K1f's 2x2 form: (N, H, W, Cin, Cout, lrelu, pad, mask,
    d2s); the folded head's convs always carry a bias."""
    return (*x.shape, w.shape[3], bool(lrelu), pad, bool(mask), bool(d2s))


F32_SD_INPUT = (40, 48)   # the float32 diffusion request's input (H, W)
F32_SD_STEPS = 2


def drive_float32(torch, np, ckpt: str, snap: str, name: str):
    """precision float32 on the card (the parity mode: K1f and K3f, TF32
    off). (1) A 150x136 ESRGAN request at num_block 1 on the streamed
    final against the same request on the CPU, adaptive sharpening off
    (its detail threshold turns a one-level truncation tie into a
    many-level pixel); (2) a 48x40 ESRGAN + diffusion request (the
    full-width SD x4 snapshot, two steps) against the same request with
    attention on flash_attention_plain. Bar for both: >= 99.9% of the
    uint8 values equal, max 1 level. The counts of each request show the
    float32 forms only: the trunk on the float32 RDB step (15 launches an
    RRDB a forward), never FusedRDB._composition, no bf16 kernel and no
    plain version. Returns the summed counts and the shapes K1f (its SAME
    conv, its head 3x3 and 2x2 forms) and K3f were given."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels import attention
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    # the module: the package's name conv3x3 is the wrapper
    k1mod = sys.modules[
        "neural_enhanced_super_resolution_torch.kernels.conv3x3"]
    base = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "iterations": 1, "esrgan_model_path": ckpt,
            "esrgan_arch": {"num_block": 1}, "precision": "float32",
            "adaptive_sharpening": False,
            "output_dir": os.path.join(OUT, "ref")}
    k1_shapes, k3_shapes, k2x2_shapes, k1h_shapes = set(), set(), set(), set()

    def attn_key(q, k, v):
        return (*q.shape[:3], k.shape[2], q.shape[3])

    def agreement(got, ref):
        diff = np.abs(got.astype(int) - ref.astype(int))
        return float(np.mean(diff == 0)), int(diff.max())

    def only_f32(counts, k3: int | None):
        return (counts["conv3x3_f32"] > 0 and counts["conv2x2_s2d_f32"] > 0
                and counts["conv3x3_head_f32"] > 0
                and counts["conv3x3_rdb_f32"] > 0
                and counts["conv3x3_rdb_f32"] % 15 == 0
                and counts["composition"] == 0
                and counts["conv3x3"] == 0 and counts["conv2x2_s2d"] == 0
                and counts["conv3x3_head"] == 0
                and counts["conv3x3_rdb"] == 0
                and counts["conv3x3_rdb_plain"] == 0
                and counts["flash_attention"] == 0
                and counts["conv3x3_plain"] == 0
                and counts["conv2x2_s2d_plain"] == 0
                and counts["flash_attention_plain"] == 0
                and (k3 is None or counts["flash_attention_f32"] == k3))

    rng = np.random.default_rng(SEED + 32)
    img = np.kron(rng.integers(0, 256, (19, 17, 3), dtype=np.uint8),
                  np.ones((8, 8, 1), np.uint8))[:150, :136]
    t0 = time.perf_counter()
    ref = SuperResolutionPipeline("cpu", base).enhance_array(img)
    cpu_s = time.perf_counter() - t0
    pipe = SuperResolutionPipeline("cuda", base)
    pipe._load_models()   # set-up: weights to the card before the window
    _zero_f32_counts()
    t0 = time.perf_counter()
    with recording(k1mod, "conv3x3_f32", k1_shapes, _conv_key), \
            recording(k1mod, "conv3x3_head_f32", k1h_shapes, _conv_key), \
            recording(k1mod, "conv2x2_s2d_f32", k2x2_shapes, _conv2x2_key), \
            counting_calls(FusedRDB, "_composition") as comp:
        got = pipe.enhance_array(img)
    card_s = time.perf_counter() - t0
    esr_counts = dict(_f32_counts(), composition=comp[0])
    equal, worst = agreement(got, ref)
    log(f"float32 request 136x150 (nb 1, streamed final) card {card_s:.2f} s"
        f" vs CPU float32 {cpu_s:.2f} s: {100 * equal:.4f}% of uint8 values "
        f"equal, max diff {worst} (bar 99.9%, 1); card counts {esr_counts} "
        f"on {name}")
    if (got.shape != ref.shape or got.shape != (600, 544, 3)
            or not equal >= 0.999 or worst > 1
            or "esrgan+post/streamed" not in pipe.timer.totals
            or not only_f32(esr_counts, 0)):
        raise AssertionError(f"float32 card vs CPU: {equal} equal, max "
                             f"{worst}, counts {esr_counts}")
    del pipe

    hh, ww = F32_SD_INPUT
    small = rng.integers(0, 256, (hh // 8, ww // 8, 3), dtype=np.uint8)
    img = np.kron(small, np.ones((8, 8, 1), np.uint8))
    pipe = SuperResolutionPipeline("cuda", dict(
        base, use_diffusion=True, diffusion_model_path=snap,
        num_inference_steps=F32_SD_STEPS,
        output_dir=os.path.join(OUT, "f32_sd")))
    pipe._load_models()
    if set(pipe.models) != {"esrgan", "diffusion"}:
        raise AssertionError(f"float32 models loaded: {sorted(pipe.models)}")
    _zero_f32_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(k1mod, "conv3x3_f32", k1_shapes, _conv_key), \
            recording(k1mod, "conv3x3_head_f32", k1h_shapes, _conv_key), \
            recording(k1mod, "conv2x2_s2d_f32", k2x2_shapes, _conv2x2_key), \
            recording(attention, "flash_attention_f32", k3_shapes,
                      attn_key), \
            counting_calls(FusedRDB, "_composition") as comp:
        got = pipe.enhance_array(img, prompt=PROMPT)
    card_s = time.perf_counter() - t0
    sd_counts = dict(_f32_counts(), composition=comp[0])
    with plain_attention():
        ref = pipe.enhance_array(img, prompt=PROMPT)
    equal, worst = agreement(got, ref)
    k3 = SD_ATTN_PER_PASS * 2 * F32_SD_STEPS + 1
    log(f"float32 request {ww}x{hh} ESRGAN + diffusion ({F32_SD_STEPS} "
        f"steps) card {card_s:.2f} s: against the plain attention "
        f"{100 * equal:.4f}% of uint8 values equal, max diff {worst} (bar "
        f"99.9%, 1); counts {sd_counts} (K3f expected {k3}) on {name}")
    if (got.shape != (4 * hh, 4 * ww, 3) or not equal >= 0.999
            or worst > 1 or not only_f32(sd_counts, k3)):
        raise AssertionError(f"float32 diffusion request: {equal} equal, "
                             f"max {worst}, counts {sd_counts}")
    del pipe
    torch.cuda.empty_cache()
    counts = {k: esr_counts[k] + sd_counts[k] for k in esr_counts}
    return (counts, sorted(k1_shapes), sorted(k2x2_shapes),
            sorted(k3_shapes), sorted(k1h_shapes))


def check_forward_f32(torch, gen, sd, name: str):
    """The full-width RRDBNet x4 (64/23/32, fused trunk) in float32 on
    TILE_BATCH against the same forward with plain=True on the card (the
    plain steps and convs: cuDNN's float32 conv, TF32 off), under
    TOL_F32_FORWARD; its launches: RDB_STEPS of the float32 RDB step, 2 of
    K1f's SAME conv (conv_first, conv_body), 2 of its head 3x3 form (up1,
    up2) and 2 of its 2x2 form (hr, last), never FusedRDB._composition,
    no bf16 kernel and no plain call; its device time split into the step,
    K1f's SAME conv, the head forms and the rest (by kernel name); the
    folded head (check_head, bar TOL_F32_FORWARD). Returns the launches
    (K1f SAME conv, 2x2 form, head 3x3 form, the step) and the shapes
    K1f's SAME conv, 2x2 and head 3x3 forms were given. The forward also
    runs twice and must be bit-equal to itself, and a
    F64_CROP-square crop of tile 0's output is held against the plain
    forward of that tile in float64 (TOL_F64_CROP), the float32 plain
    forward's crop printed beside it; a miss of any bar prints
    _forward_f32_diagnosis."""
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig)
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    k1mod = sys.modules[
        "neural_enhanced_super_resolution_torch.kernels.conv3x3"]
    cfg = RRDBNetConfig(**ARCH)
    n, h, w = TILE_BATCH
    x = torch.rand((n, h, w, 12), generator=gen).to("cuda")
    model = RRDBNet(cfg, sd, torch.float32, "cuda", "fused")
    ref = model(x, plain=True)
    shapes, shapes_2x2, shapes_head = _Tally(), _Tally(), _Tally()
    _zero_f32_counts()
    with recording(k1mod, "conv3x3_f32", shapes, _conv_key), \
            recording(k1mod, "conv3x3_head_f32", shapes_head, _conv_key), \
            recording(k1mod, "conv2x2_s2d_f32", shapes_2x2, _conv2x2_key), \
            counting_calls(FusedRDB, "_composition") as comp:
        out = model(x)
    counts = dict(_f32_counts(), composition=comp[0])
    d, r = rel_err(out, ref)
    # Twice, bit for bit; and a crop of tile 0 against the plain forward
    # in float64, the float32 plain reference's crop beside it: which of
    # the two is off, where they disagree.
    again = model(x)
    repeat = _same(out, again)
    repeat_unequal = int((out != again).sum())
    del again
    c0 = (out.shape[1] - F64_CROP) // 2
    crop = (0, slice(c0, c0 + F64_CROP), slice(c0, c0 + F64_CROP))
    ref_crop = ref[crop].clone()
    f64 = RRDBNet(cfg, sd, torch.float64, "cuda", "fused")(
        x[:1], plain=True)[crop].double()
    _, r64 = rel_err(out[crop].double(), f64)
    _, r64_ref = rel_err(ref_crop.double(), f64)
    del f64
    ok = (r <= TOL_F32_FORWARD and bool(torch.isfinite(out).all())
          and repeat and r64 <= TOL_F64_CROP)
    why = "" if ok else _forward_f32_diagnosis(torch, model, x, out, ref)
    del ref
    torch.cuda.empty_cache()
    nf, g = ARCH["num_feat"], ARCH["num_grow_ch"]
    rdb_flops = 2.0 * n * h * w * 9 * sum(
        (nf if k == 0 else g) * (4 * g + nf - k * g) for k in range(5))
    flops = sum(2.0 * a * b * c * ci * co * 9
                for a, b, c, ci, co, *_ in shapes + shapes_head) + sum(
        2.0 * a * (b + 2 * pad - 1) * (c + 2 * pad - 1) * ci * co * 4
        for a, b, c, ci, co, _, pad, _, _ in shapes_2x2) + (
        3 * cfg.num_block * rdb_flops)
    split = device_ms_split(
        lambda: model(x),
        {"step": ("rdb_f32_step",), "K1f": ("conv3x3_f32_kernel",),
         "head": ("conv3x3_head_f32", "conv2x2_f32")},
        reps=2, floor_ms=flops / PEAK_FP32_FLOPS * 1e3)
    total = sum(split.values())
    wall = wall_ms(lambda: model(x), reps=2)

    def on_composition():
        """The same forward with the trunk before the step: each RDB five
        K1f convs and the PyTorch assembly, each RRDB's residual an add."""
        keep = FusedRDB.folds_skip
        FusedRDB.folds_skip = lambda self, t: False
        try:
            return model(x)
        finally:
            FusedRDB.folds_skip = keep

    turns = {"steps": [], "composition": []}
    for key in ("steps", "composition", "composition", "steps"):
        turns[key].append(device_ms(
            (lambda: model(x)) if key == "steps" else on_composition, reps=2,
            floor_ms=flops / PEAK_FP32_FLOPS * 1e3))
    log(f"forward float32 (the float32 RDB step + K1f) 12ch x4 nf64 nb23 "
        f"gc32 on {tuple(x.shape)}: max_abs_err {d:.6g} rel {r:.3g} vs the "
        f"plain forward on the card (tol {TOL_F32_FORWARD}); a second "
        f"forward bit-equal to the first {repeat} ({repeat_unequal} values "
        f"unequal); the {F64_CROP}x{F64_CROP} crop of tile 0 at ({c0}, {c0})"
        f" against the tile's plain forward in float64: rel {r64:.3g} (tol "
        f"{TOL_F64_CROP}), the float32 plain forward's crop rel "
        f"{r64_ref:.3g}; device ms "
        f"{total:.3f} (wall {wall:.3f}; bound "
        f"{flops / PEAK_FP32_FLOPS * 1e3:.3f}, {flops / 1e12:.3f} TFLOP at 67 "
        f"TFLOP/s): the step "
        f"{split['step']:.3f}, K1f SAME conv {split['K1f']:.3f}, head forms "
        f"{split['head']:.3f}, the rest {split['rest']:.3f}; launches: "
        f"step {counts['conv3x3_rdb_f32']}, K1f {counts['conv3x3_f32']} over "
        f"{len(set(shapes))} shapes, 2x2 form {counts['conv2x2_s2d_f32']} "
        f"over {len(set(shapes_2x2))}, head 3x3 form "
        f"{counts['conv3x3_head_f32']} over {len(set(shapes_head))}, "
        f"FusedRDB._composition calls {counts['composition']}; device ms in "
        f"turns with the trunk on the composition (steps, composition, "
        f"composition, steps) {turns}; counts {counts} on {name}")
    want = (K1F_FOLDED, K1_2X2, K1_HEAD, RDB_STEPS)
    got = (counts["conv3x3_f32"], counts["conv2x2_s2d_f32"],
           counts["conv3x3_head_f32"], counts["conv3x3_rdb_f32"])
    if (not ok or got != want
            or any(counts[k] for k in ("conv3x3", "conv2x2_s2d",
                                       "conv3x3_head",
                                       "flash_attention", "conv3x3_plain",
                                       "conv2x2_s2d_plain",
                                       "flash_attention_plain",
                                       "conv3x3_rdb", "conv3x3_rdb_plain",
                                       "composition"))):
        raise AssertionError(f"float32 forward: rel err {r}, bit-equal to "
                             f"itself {repeat}, the crop against float64 rel"
                             f" {r64} (the plain forward's {r64_ref}), "
                             f"counts {counts} (want {want} launches of K1f, "
                             "its 2x2 and head 3x3 forms and the step, "
                             "nothing else)" + why)
    del out
    check_head(torch, model, x, TOL_F32_FORWARD, name)
    del model
    torch.cuda.empty_cache()
    return (got, sorted(set(shapes)), sorted(set(shapes_2x2)),
            sorted(set(shapes_head)))


def _forward_f32_diagnosis(torch, model, x, out, ref) -> str:
    """Where a float32 forward that missed a bar went wrong, for the
    failure's message (the phase fails all the same): the forward and its
    plain reference run again, each compared with its first run and with
    the other's; the tiles, rows and columns where the first run is off;
    in a third run each RDB held against FusedRDB._composition on its own
    input, bit for bit, and K1f's conv_first and conv_body and the folded
    head's four launches each against its plain version on its own
    input."""
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    out2, ref2 = model(x), model(x, plain=True)
    far = ((out - ref).abs() > TOL_F32_FORWARD * max(
        1.0, ref.abs().max().item())).any(-1)
    where = far.nonzero()
    box = (f"{int(far.sum())} pixels off, tiles "
           f"{sorted(set(where[:, 0].tolist()))}, rows "
           f"{where[:, 1].min().item()}..{where[:, 1].max().item()}, columns "
           f"{where[:, 2].min().item()}..{where[:, 2].max().item()}"
           if len(where) else "no pixel off")
    unequal, seen, fwd = [], [0], FusedRDB.forward

    def held(self, t, plain=False, skip=None):
        y = fwd(self, t, plain, skip)
        c = self._composition(t)
        c = c if skip is None else skip + 0.2 * c
        if not torch.equal(y, c):
            unequal.append((seen[0], int((y != c).sum())))
        seen[0] += 1
        return y

    # K1f's two convs and the four head launches, each against its plain
    # version on the input it gets in the same run.
    convs = []
    mods = [(model.conv_first, "conv_first"), (model.conv_body, "conv_body")]
    mods += [(getattr(model.folded_head, k), k)
             for k in ("up1", "up2", "hr", "last")]

    def holding(mod, label):
        run = mod.forward

        def forward(t, *args, **kw):
            y = run(t, *args, **kw)
            plain = run(t, *args, **dict(kw, plain=True))
            convs.append(f"{label} rel {rel_err(y, plain)[1]:.3g}")
            return y
        return forward

    FusedRDB.forward = held
    for mod, label in mods:
        mod.forward = holding(mod, label)
    try:
        model(x)
    finally:
        FusedRDB.forward = fwd
        for mod, _ in mods:
            del mod.forward
    return (f"; diagnosis: {box}; a second forward rel err "
            f"{rel_err(out2, ref)[1]:.3g} (bit-equal to the first "
            f"{torch.equal(out2, out)}), the first against a second plain "
            f"reference {rel_err(out, ref2)[1]:.3g} (references bit-equal "
            f"{torch.equal(ref2, ref)}); RDBs unequal to the composition "
            f"{len(unequal)} of {seen[0]} {unequal[:8]}; against their "
            f"plain versions (bar {TOL_F32}) {', '.join(convs)}")


class _Tally(list):
    """Every key ``recording`` sees, repeats included."""
    add = list.append


def check_conv3x3_f32(torch, gen, shapes, shapes_2x2, shapes_head) -> tuple:
    """K1f against conv3x3_plain at every shape of the full-width float32
    forward and of the float32 requests, and K1f's 2x2 and head 3x3 forms
    against conv2x2_s2d_plain / conv3x3_plain at every shape they gave
    them, each beside cuDNN's float32 conv (TF32 off) at its shape and its
    bound; the JSON rows are conv_body on TILE_BATCH (F32_CONV_BODY), the
    folded head's hr there (F32_HEAD_HR) and its up2 (F32_HEAD_UP2)."""
    import torch.nn.functional as F
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv2x2_s2d_f32, conv2x2_s2d_plain, conv3x3_f32, conv3x3_head_f32,
        conv3x3_plain)
    worst, rows, failed = [0.0, 0.0, 0.0], {}, []
    cases = ([(3, s, s[:5] + (1, False)) for s in shapes]
             + [(2, s, s[:5] + s[6:8]) for s in shapes_2x2]
             + [("head", s, s[:5] + (1, False)) for s in shapes_head])
    for taps, key, (n, h, w, cin, cout, pad, mask) in cases:
        x = _rnd(torch, gen, n, h, w, cin, dtype=torch.float32)
        kt = 2 if taps == 2 else 3
        wt = _rnd(torch, gen, kt, kt, cin, cout,
                  scale=(2.0 / (kt * kt * cin)) ** 0.5, dtype=torch.float32)
        if kt == 3:
            bias, act, d2s = key[5:]
            b = (_rnd(torch, gen, cout, scale=0.1, dtype=torch.float32)
                 if bias else None)
            fn = conv3x3_head_f32 if taps == "head" else conv3x3_f32
            run = lambda: fn(x, wt, b, act, d2s)
            plain = lambda: conv3x3_plain(x, wt, b, act, d2s)
            what = f"{fn.__name__} {(n, h, w, cin)} -> {cout} bias {bias}"
        else:
            bias, (act, _, _, d2s) = True, key[5:]
            b = _rnd(torch, gen, cout, scale=0.1, dtype=torch.float32)
            run = lambda: conv2x2_s2d_f32(x, wt, b, act, pad, mask, d2s)
            plain = lambda: conv2x2_s2d_plain(x, wt, b, act, pad, mask, d2s)
            what = (f"2x2 form conv2x2_s2d_f32 {(n, h, w, cin)} -> {cout} "
                    f"pad {pad} mask {mask}")
        got, ref = run(), plain()
        d, r = rel_err(got, ref)
        ms, pms = cuda_ms(run), cuda_ms(plain)
        # For scale only: the library's float32 conv (cuDNN, TF32 off,
        # channels_last).
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cms = cuda_ms(lambda: F.conv2d(xc, wc, b, padding=pad))
        bms, by = conv_bound(n, h, w, kt, cin, cout, pad, 4,
                             PEAK_FP32_FLOPS, bias)
        log(f"K1f {what} lrelu {act} d2s {d2s}: max_abs_err {d:.6g} rel "
            f"{r:.3g} (tol {TOL_F32}) kernel {ms:.4f} ms plain {pms:.4f} ms "
            f"cuDNN f32 conv {cms:.4f} ms bound {bms:.4f} ms ({by}); "
            f"kernel/cuDNN {ms / cms:.3f}, bound/kernel {bms / ms:.3f}")
        if not (r <= TOL_F32 and got.shape == ref.shape):
            failed.append(f"{what}: rel {r}")
        form = 2 if taps == "head" else int(taps == 2)
        worst[form] = max(worst[form], d)
        rows[form, key] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                           "bound_by": by, "library_ms": cms}
        del x, got, ref
    want = ((0, F32_CONV_BODY), (1, F32_HEAD_HR), (2, F32_HEAD_UP2))
    if failed or any(k not in rows for k in want):
        raise AssertionError(f"K1f disagrees with its plain version: "
                             f"{failed or 'conv_body, head hr or up2 not '}"
                             "recorded")
    return tuple(dict(rows[k], max_abs_err=worst[k[0]]) for k in want)


def check_flash_attention_f32(torch, gen, shapes) -> dict:
    """K3f against flash_attention_plain at every FLASH_SHAPES row and at
    every shape the float32 diffusion request gave it (the VAE mid-block's
    1920^2, d 512 among them), q and k of std 2 (peaked softmax rows), and
    K3's case of every real score at -2048 on a ragged Skv; each shape's
    key-range split count beside its times. The JSON row is the VAE's
    1920^2 (F32_VAE_SHAPE)."""
    import torch.nn.functional as F
    from neural_enhanced_super_resolution_torch.kernels.attention import (
        flash_attention_f32, flash_attention_plain, flash_f32_splits)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = list(FLASH_SHAPES)
    known = {c[1:] for c in cases}
    cases += [("float32 request", *sh) for sh in shapes
              if tuple(sh) not in known]
    if not any(c[1:] == F32_VAE_SHAPE for c in cases):
        raise AssertionError(f"K3f: the request gave no {F32_VAE_SHAPE}")
    cases.append(("padded keys, scores -2048", 1, 2, 100, 100, 64))
    worst, rows, failed = 0.0, {}, []
    for label, b, h, sq, skv, d in cases:
        if label.startswith("padded"):
            q = torch.full((b, h, sq, d), 16.0, device="cuda")
            k = torch.full((b, h, skv, d), -16.0, device="cuda")
        else:
            q = _rnd(torch, gen, b, h, sq, d, scale=2.0, dtype=torch.float32)
            k = _rnd(torch, gen, b, h, skv, d, scale=2.0,
                     dtype=torch.float32)
        v = _rnd(torch, gen, b, h, skv, d, dtype=torch.float32)
        got = flash_attention_f32(q, k, v)
        ref = flash_attention_plain(q, k, v)
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        # K3f (its kernel and, split, the merge), SDPA and the plain
        # version (its products and softmax) all by device time, K3f and
        # SDPA in one profiled window: at the small shapes CUDA events over
        # a call time the host's enqueue. A window sometimes loses device
        # events, wholly or in part, so each is taken again while under
        # the bound. Events over a call are logged beside them.
        flops = 4.0 * b * h * sq * skv * d
        bms, by = bound(flops, 4.0 * b * h * d * (2 * sq + 2 * skv),
                        PEAK_FP32_FLOPS)
        ms, lms = device_ms_named(
            lambda: flash_attention_f32(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v), "attn_f32",
            floor_ms=(bms, bms))
        pms = device_ms(lambda: flash_attention_plain(q, k, v),
                        floor_ms=bms)
        ems = cuda_ms(lambda: flash_attention_f32(q, k, v))
        lems = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        pems = cuda_ms(lambda: flash_attention_plain(q, k, v))
        nsplit, kps = flash_f32_splits(sq, skv, b * h, d, sms)
        log(f"K3f flash_attention_f32 {label} q {tuple(q.shape)} Skv {skv}:"
            f" {nsplit} split(s) of {kps} keys; max_abs_err {err:.6g} rel "
            f"{rel:.3g} (tol {TOL_F32}) device ms: kernel {ms:.4f} SDPA f32 "
            f"{lms:.4f} plain {pms:.4f} bound {bms:.4f} ({by}); "
            f"kernel/SDPA {ms / lms:.3f}, kernel/plain {ms / pms:.3f}, "
            f"bound/kernel {bms / ms:.3f}; events ms a call: kernel "
            f"{ems:.4f} SDPA f32 {lems:.4f} plain {pems:.4f}")
        if not rel <= TOL_F32:
            failed.append(f"{label} {(b, h, sq, skv, d)}: rel {rel}")
        worst = max(worst, err)
        rows[(b, h, sq, skv, d)] = {"ms": ms, "plain_ms": pms,
                                    "bound_ms": bms, "bound_by": by,
                                    "library_ms": lms}
        del q, k, v, got, ref
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K3f disagrees with its plain version: "
                             f"{failed}")
    return dict(rows[F32_VAE_SHAPE], max_abs_err=worst)


MD_IMAGE = (768, 1024)       # H, W of the tile-DP and strip checks
MD_MEMBER = 268              # the member ensemble's image edge
MD_LATENT = 128              # split CFG and TP: a 128^2 latent
# The TP pass is held to a float32 pass of the same weights: its error
# against it (max|err| / max|ref|) may be at most TP_F32_FACTOR times the
# replicated bf16 pass's. Its difference to the replicated pass is printed
# for scale, under no bar: another GEMM shape alone moves the bf16 pass by
# about 1.2e-2 (the replicated pass at batch 2 against batch 1).
TP_F32_FACTOR = 1.5
TP_INPUTS = 3                # seeded UNet inputs the TP check compares on
LADDER_WARNINGS = ("Sharded tile path failed", "Strip-sharded path failed")


class _Warnings(logging.Handler):
    """Collects the WARNING records of the pipeline's logger."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def multi_device_mesh(torch) -> tuple[tuple, bool]:
    """Every card when there are two or more; else the one card listed
    four times (a one-card rehearsal of a four-slot layout)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return tuple(torch.device("cuda", i) for i in range(n)), False
    return (torch.device("cuda", 0),) * 4, True


def strip_emulation(torch, fn, image, n: int, halo: int, scale: int):
    """Strip sharding done sequentially by indexing: each strip with its
    neighbours' rows or its reflected edge, one forward each."""
    from neural_enhanced_super_resolution_torch.ops.pad import reflect_pad
    h = int(image.shape[0])
    padded = reflect_pad(image, 0, 0, (-h) % n)
    rows = int(padded.shape[0]) // n
    outs = []
    for i in range(n):
        lo, hi = i * rows, (i + 1) * rows
        s = padded[lo:hi]
        top = padded[lo - halo:lo] if i > 0 else s[1:halo + 1].flip(0)
        bot = (padded[hi:hi + halo] if i < n - 1
               else s[-halo - 1:-1].flip(0))
        y = fn(torch.cat([top, s, bot])[None].contiguous())[0]
        outs.append(y[halo * scale:y.shape[0] - halo * scale])
    return torch.cat(outs)[:h * scale]


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def drive_multi_device(torch, np, sd, ckpt: str, snap: str, seg: str,
                       name: str) -> dict:
    """The multi-device layer at full width over a mesh of the card(s):
    tile DP and strips of the RRDBNet x4, the member ensemble, split CFG
    and TP of the SD x4 UNet, the default config and a strips request
    through the product with ``data_parallel: "auto"``, NCCL at world size
    1, and the dry run. Each sharded result is held against its
    single-device counterpart. Returns the K1 (3x3 and 2x2 forms) and K3
    launches of the sharded runs."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels import (
        conv2x2_s2d, conv2x2_s2d_plain, conv3x3, conv3x3_head, conv3x3_plain,
        conv3x3_rdb, conv3x3_rdb_plain, flash_attention, flash_attention_plain,
        nl_means_fields, nl_means_fields_plain)
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig, init_rrdbnet)
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        UNet2DConditionModel, build_module, load_upscale_pipeline,
        unet_forward)
    from neural_enhanced_super_resolution_torch.models.diffusion.cfg_shard \
        import cfg_mesh, denoise_cfg_sharded
    from neural_enhanced_super_resolution_torch.ops.enhance import (
        contrast_stage)
    from neural_enhanced_super_resolution_torch.parallel import (
        ensemble_members_sharded, process_strips_sharded, process_tiled,
        process_tiled_sharded, shard_tiles)
    from neural_enhanced_super_resolution_torch.parallel.dryrun import (
        dryrun_multichip, visible)
    from neural_enhanced_super_resolution_torch.parallel.mesh import module_on
    from neural_enhanced_super_resolution_torch.parallel.tensor import (
        TensorParallelUNet, _TPBlock)
    from neural_enhanced_super_resolution_torch.pipeline import esrgan_step
    from neural_enhanced_super_resolution_torch.runtime import distributed
    from neural_enhanced_super_resolution_torch.runtime.profiler import (
        StageTimer)
    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb
    from neural_enhanced_super_resolution_torch.utils.metrics import psnr

    t_phase = time.perf_counter()
    mesh, repeated = multi_device_mesh(torch)
    n = len(mesh)
    tag = (f"one-card rehearsal, not a multi-card speed; {name}" if repeated
           else f"{n} cards; {name}")
    log(f"multi-device: mesh of {n} slots {[str(d) for d in mesh]}"
        + (" (the one card listed 4 times: every time below is a one-card "
           "rehearsal, not a multi-card speed)" if repeated else ""))
    counts = {"conv3x3": 0, "conv2x2_s2d": 0, "conv3x3_rdb": 0,
              "conv3x3_head": 0, "flash_attention": 0, "nl_means_fields": 0}
    warnings = _Warnings()
    logging.getLogger("nesr").addHandler(warnings)

    def zero():
        conv3x3.launches = flash_attention.launches = 0
        conv2x2_s2d.launches = conv2x2_s2d_plain.calls = 0
        conv3x3_plain.calls = flash_attention_plain.calls = 0
        conv3x3_rdb.launches = conv3x3_rdb_plain.calls = 0
        conv3x3_head.launches = 0
        nl_means_fields.launches = nl_means_fields_plain.calls = 0

    def no_plain(label):
        if (conv3x3_plain.calls or flash_attention_plain.calls
                or conv2x2_s2d_plain.calls or conv3x3_rdb_plain.calls
                or nl_means_fields_plain.calls):
            raise AssertionError(f"{label}: plain versions ran on the card")

    def k1_per(forwards: int) -> bool:
        """The folded model's K1, 2x2-form, K1 step and head 3x3-form
        launches for ``forwards``."""
        return (conv3x3.launches, conv2x2_s2d.launches, conv3x3_rdb.launches,
                conv3x3_head.launches) == (forwards * K1_FOLDED,
                                           forwards * K1_2X2,
                                           forwards * RDB_STEPS,
                                           forwards * K1_HEAD)

    def add_k1():
        counts["conv3x3"] += conv3x3.launches
        counts["conv2x2_s2d"] += conv2x2_s2d.launches
        counts["conv3x3_rdb"] += conv3x3_rdb.launches
        counts["conv3x3_head"] += conv3x3_head.launches

    # ---- tile DP: the full-width RRDBNet x4 on a 1024x768 image ----------
    model = RRDBNet(RRDBNetConfig(**ARCH), sd, dtype=torch.bfloat16,
                    device="cuda").eval()
    replicas = {}

    def fn(tiles, member=None):
        m = member or model
        key = (id(m), tiles.device)
        if key not in replicas:
            replicas[key] = module_on(m, tiles.device)
        return esrgan_step(replicas[key], tiles, "stack12")

    hh, ww = MD_IMAGE
    img = torch.from_numpy(_noisy_images(np, 1, hh, ww, SEED + 40)[0]).cuda()
    tile, halo, batch = 256, 6, 16   # the cuda overlay's geometry
    process_tiled_sharded(fn, img, mesh, tile, halo, 4, batch_tiles=batch)
    process_tiled(fn, img, tile, halo, 4, batch_tiles=batch)   # warm both
    single, single_ms = _timed(torch, lambda: process_tiled(
        fn, img, tile, halo, 4, batch_tiles=batch))
    shards = []

    def counted(tiles):
        shards.append(int(tiles.shape[0]))
        return fn(tiles)

    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")   # any host sync raises
    try:
        out = process_tiled_sharded(counted, img, mesh, tile, halo, 4,
                                    batch_tiles=batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1e3
    k1, k2x2 = conv3x3.launches, conv2x2_s2d.launches
    no_plain("tile DP")
    log(f"multi-device tile DP: RRDBNet x4 (64/23/32, bf16) on {ww}x{hh}, "
        f"{tile}-px tiles, halo {halo}, batch {batch} a slot: {len(shards)} "
        f"shards of {shards} tiles, K1 launches {k1}, 2x2 form {k2x2} and "
        f"K1 step {conv3x3_rdb.launches}, head 3x3 form "
        f"{conv3x3_head.launches} (forwards x {K1_FOLDED}, x {K1_2X2}, x "
        f"{RDB_STEPS} and x {K1_HEAD}), 0 host syncs from the "
        f"first shard's "
        f"dispatch to the last one's (sync debug mode 'error'); equal to "
        f"process_tiled bit for bit: {torch.equal(out, single)}; dispatch "
        f"{dispatch_ms:.2f} ms, sharded {sharded_ms:.2f} ms, one device "
        f"{single_ms:.2f} ms ({tag})")
    if not torch.equal(out, single) or not k1_per(len(shards)):
        raise AssertionError(f"tile DP: equal {torch.equal(out, single)}, "
                             f"K1 {k1}, 2x2 {k2x2}, shards {shards}")
    add_k1()

    # ---- strips over the mesh against a sequential emulation ---------------
    zero()
    strips, strips_ms = _timed(torch, lambda: process_strips_sharded(
        fn, img, mesh, halo=halo, scale=4))
    k1, k2x2, strips_ok = conv3x3.launches, conv2x2_s2d.launches, k1_per(n)
    steps = conv3x3_rdb.launches
    add_k1()
    emulated = strip_emulation(torch, fn, img, n, halo, 4)
    no_plain("strips")
    log(f"multi-device strips: {n} strips of {ww}x{-(-hh // n)} + 2x{halo} "
        f"halo rows, K1 launches {k1}, 2x2 form {k2x2} and K1 step {steps} "
        f"(forwards x {K1_FOLDED}, x {K1_2X2} and x {RDB_STEPS}); equal to "
        f"the sequential emulation bit "
        f"for bit: {torch.equal(strips, emulated)}; {strips_ms:.2f} ms "
        f"({tag})")
    if not torch.equal(strips, emulated) or not strips_ok:
        raise AssertionError(f"strips: K1 {k1}, 2x2 {k2x2}, steps {steps}")

    # ---- the member ensemble: two seeded full-width RRDBNets ---------------
    member2 = RRDBNet(RRDBNetConfig(**ARCH), init_rrdbnet(
        RRDBNetConfig(**ARCH), torch.Generator().manual_seed(SEED + 1)),
        dtype=torch.bfloat16, device="cuda").eval()
    small = img[:MD_MEMBER, :MD_MEMBER].contiguous()

    def member_fn(member, x):
        return esrgan_step(member, x[None], "stack12")[0]

    members = [model, module_on(member2, mesh[1])]   # placed once
    ensemble_members_sharded(member_fn, members, small, mesh[:2])   # warm
    zero()
    ens, ens_ms = _timed(torch, lambda: ensemble_members_sharded(
        member_fn, members, small, mesh[:2], weights=[0.5, 0.5]))
    k1, k2x2, ens_ok = conv3x3.launches, conv2x2_s2d.launches, k1_per(2)
    steps = conv3x3_rdb.launches
    add_k1()
    ref = (member_fn(model, small).float() * 0.5
           + member_fn(member2, small).float() * 0.5)
    err = (ens - ref).abs().max().item()
    log(f"multi-device member ensemble: 2 RRDBNets (seeds {SEED}, "
        f"{SEED + 1}) on {MD_MEMBER}^2 over 2 slots, weights 0.5/0.5: max "
        f"abs err {err:.3g} against the weighted sum on one device (bar "
        f"1e-6), K1 launches {k1}, 2x2 form {k2x2}, K1 step {steps}; "
        f"{ens_ms:.2f} ms ({tag})")
    if not err <= 1e-6 or not ens_ok:
        raise AssertionError(f"member ensemble: err {err}, K1 {k1}, "
                             f"2x2 {k2x2}, steps {steps}")
    del member2

    # ---- split CFG: the full-width SD x4 on a 128x128 image, 2 DDIM steps -
    pipe = load_upscale_pipeline(snap, device="cuda")
    gen = torch.Generator("cuda").manual_seed(SEED + 41)
    s = MD_LATENT
    image = pipe._image(torch.randint(0, 256, (s, s, 3), generator=gen,
                                      device="cuda", dtype=torch.uint8))
    embeds = pipe.encode_prompt(PROMPT)
    noise = torch.randn((1, s, s, 3), generator=gen, device="cuda")
    latents = torch.randn((1, s, s, 4), generator=gen, device="cuda")
    steps = pipe.scheduler.timesteps(2)
    args = (embeds, image, noise, latents, None, steps, 20, 7.5)
    pair = cfg_mesh(mesh[:2])
    unets = [pipe._unet_on(d) for d in pair]
    pipe._denoise(*args)   # warm both
    denoise_cfg_sharded(unets, *args, pipe.scheduler, pipe.low_res_scheduler,
                        pair)
    zero()
    lat_single, single_ms = _timed(torch, lambda: pipe._denoise(*args))
    k3_single = flash_attention.launches
    zero()
    lat_sharded, sharded_ms = _timed(torch, lambda: denoise_cfg_sharded(
        unets, *args, pipe.scheduler, pipe.low_res_scheduler, pair))
    k3 = flash_attention.launches
    equal = torch.equal(lat_sharded.to(lat_single.device), lat_single)
    no_plain("split CFG")
    log(f"multi-device split CFG: SD x4 UNet (full width), {s}^2 latent, 2 "
        f"DDIM steps, uncond on slot 0 and cond on slot 1: latents equal to "
        f"cfg_split on one device bit for bit: {equal}; K3 launches {k3} "
        f"(one device {k3_single}); sharded {sharded_ms:.2f} ms, one device "
        f"{single_ms:.2f} ms ({tag})")
    if not equal or k3 != k3_single or k3 != SD_ATTN_PER_PASS * 2 * 2:
        raise AssertionError(f"split CFG: equal {equal}, K3 {k3} vs "
                             f"{k3_single}")
    counts["flash_attention"] += k3

    # ---- TP: one full-width UNet pass at a 128^2 latent, tp 2 --------------
    ctx, labels = embeds[1:], torch.tensor([20], device="cuda")
    tp_unet = TensorParallelUNet(pipe.unet, mesh[:2])
    per_slot = [0, 0]
    slot_attention = _TPBlock._attention

    def counted_attention(self, i, q, k, v, cross):
        per_slot[i] += not cross   # the self-attentions run K3
        return slot_attention(self, i, q, k, v, cross)

    xs = [torch.randn((1, s, s, 7), generator=gen, device="cuda")
          for _ in range(TP_INPUTS)]
    tp_unet(xs[0], 500, ctx, labels)   # warm
    _TPBlock._attention = counted_attention
    try:
        zero()
        got, tp_ms = _timed(torch, lambda: tp_unet(xs[0], 500, ctx, labels))
        k3 = flash_attention.launches
    finally:
        _TPBlock._attention = slot_attention
    _, ref_ms = _timed(torch, lambda: unet_forward(pipe.unet, xs[0], 500,
                                                   ctx, labels))
    no_plain("TP")
    # the float32 anchor: the same (bf16) weights in float32, TF32 off
    unet32 = build_module(UNet2DConditionModel, pipe.unet.cfg,
                          {k: v.float() for k, v in
                           pipe.unet.state_dict().items()},
                          torch.float32, "cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    rels, tp_errs, rep_errs, finite = [], [], [], True
    for x in xs:
        got = tp_unet(x, 500, ctx, labels)
        ref = unet_forward(pipe.unet, x, 500, ctx, labels)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            ref32 = unet_forward(unet32, x, 500, ctx, labels)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        scale = ref32.abs().max()
        rels.append(((got - ref).abs().max() / ref.abs().max()).item())
        tp_errs.append(((got - ref32).abs().max() / scale).item())
        rep_errs.append(((ref - ref32).abs().max() / scale).item())
        finite = finite and bool(torch.isfinite(got).all())
    ratios = [t / r for t, r in zip(tp_errs, rep_errs)]
    log(f"multi-device TP: SD x4 UNet pass (full width) at {s}^2, tp 2 "
        f"(heads, GEGLU halves and row-parallel sums split over 2 slots), "
        f"{TP_INPUTS} seeded inputs: rel err "
        f"{', '.join(f'{r:.4g}' for r in rels)} against the replicated pass "
        f"(bf16, for scale); against a float32 "
        f"pass of the same weights (TF32 off): TP rel err "
        f"{', '.join(f'{e:.4g}' for e in tp_errs)}, replicated "
        f"{', '.join(f'{e:.4g}' for e in rep_errs)}, ratio "
        f"{', '.join(f'{q:.4g}' for q in ratios)} (bar {TP_F32_FACTOR}); K3 "
        f"launches {k3} a pass, per slot {per_slot}; TP {tp_ms:.2f} ms, "
        f"replicated {ref_ms:.2f} ms ({tag})")
    if not finite or max(ratios) > TP_F32_FACTOR or \
            per_slot != [SD_ATTN_PER_PASS] * 2 or \
            k3 != 2 * SD_ATTN_PER_PASS:
        raise AssertionError(f"TP: ratio {ratios}, K3 {k3}, per slot "
                             f"{per_slot}")
    counts["flash_attention"] += k3
    del pipe, tp_unet, unets, unet32
    torch.cuda.empty_cache()

    # ---- the product: the default config over the mesh --------------------
    base = {"use_diffusion": True, "diffusion_model_path": snap,
            "esrgan_model_path": ckpt, "segmentation_model_path": seg,
            "iterations": 1, "output_dir": os.path.join(OUT, "md_out")}
    small_img = imread_rgb(os.path.join(OUT, "default_128.png"))
    one = SuperResolutionPipeline("cuda", dict(base, data_parallel="off"))
    one._load_models()
    streams = one._stream_final_ok(0, 1, small_img)
    if streams:
        one.config["streamed_output"] = False
    one.enhance_array(small_img, PROMPT)   # warm
    out_one, one_ms = _timed(torch, lambda: one.enhance_array(small_img,
                                                              PROMPT))
    del one
    with visible(mesh):
        multi = SuperResolutionPipeline("cuda", dict(base,
                                                     data_parallel="auto"))
        multi._load_models()
        layout = multi._parallel_layout()
        multi.enhance_array(small_img, PROMPT)   # warm
        multi.timer = StageTimer()
        zero()
        out_multi, multi_ms = _timed(torch, lambda: multi.enhance_array(
            small_img, PROMPT))
    k1, k3, steps = (conv3x3.launches, flash_attention.launches,
                     conv3x3_rdb.launches)
    nlm = nl_means_fields.launches
    counts["nl_means_fields"] += nlm
    no_plain("default config over the mesh")
    equal = np.array_equal(out_multi, out_one)
    log(f"multi-device default config 128x128 -n 1 (denoise, segmentation, "
        f"ESRGAN, diffusion), data_parallel auto: ESRGAN slots "
        f"{layout['slots']}, diffusion on slot {layout['diffusion_slot']}; "
        f"equal to the single-device request bit for bit: {equal} (the "
        "single-device side "
        + ("would take the streamed final, so it ran with streamed_output "
           "false" if streams else "takes the standard chain here, as "
           "diffusion joins the ensemble; streamed_output at its default")
        + f"); K1 {k1}, K1 step {steps}, K3 {k3}; {multi_ms:.1f} ms over "
        f"the mesh, "
        f"{one_ms:.1f} ms on one device ({tag}); StageTimer (esrgan, swinir "
        "and diffusion time dispatch only under stage overlap):")
    for line in multi.timer.summary_lines():
        log(line)
    if layout["mesh"] is None or not equal or not (
            len(layout["slots"]) == max(1, n - max(1, n // 4))
            and layout["diffusion_slot"] == n - 1) or \
            k3 != SD_ATTN_PER_PASS * 2 * SD_STEPS + 1 or k1 == 0 or \
            steps == 0 or nlm == 0:
        raise AssertionError(f"default config over the mesh: layout "
                             f"{layout}, equal {equal}, K1 {k1}, K3 {k3}, "
                             f"K1 step {steps}")
    counts["conv3x3"] += k1
    counts["conv3x3_rdb"] += steps
    counts["conv2x2_s2d"] += conv2x2_s2d.launches
    counts["conv3x3_head"] += conv3x3_head.launches
    counts["flash_attention"] += k3
    del multi

    # ---- the product: strips against tiles at 1024x768 --------------------
    esr = {"use_diffusion": False, "segment_enhancement": False,
           "denoise_level": 0, "adaptive_sharpening": False,
           "upscale_factor": 4, "esrgan_model_path": ckpt, "iterations": 1,
           "data_parallel": "auto", "output_dir": os.path.join(OUT, "md_out")}
    big = img.cpu().numpy()
    outs, ms, k1s = {}, {}, {}
    with visible(mesh):
        for strategy in ("strips", "tiles"):
            p = SuperResolutionPipeline("cuda", dict(
                esr, shard_strategy=strategy))
            p._load_models()
            if p._parallel_layout()["mesh"] is None:
                raise AssertionError(f"{strategy}: no mesh")
            zero()
            outs[strategy], ms[strategy] = _timed(
                torch, lambda p=p: p.enhance_array(big))
            k1s[strategy] = (conv3x3.launches, conv2x2_s2d.launches,
                             conv3x3_rdb.launches, conv3x3_head.launches)
            no_plain(f"{strategy} request")
    emulated = strip_emulation(torch, fn, contrast_stage(img), n, halo,
                               4).cpu().numpy()
    exact = np.array_equal(outs["strips"], emulated)
    db = float(psnr(outs["strips"], outs["tiles"]))
    same = float(np.mean(outs["strips"] == outs["tiles"]))
    log(f"multi-device request {ww}x{hh} ESRGAN-only, shard_strategy strips "
        f"over {n} slots (halo {halo}): equal bit for bit to the sequential "
        f"strip emulation of the same preprocessed image: {exact}; PSNR "
        f"{db:.2f} dB against shard_strategy tiles (bar 30; {same:.4f} of "
        f"the values identical: the RRDBNet's receptive field exceeds the "
        f"{halo}-px halo, so the two cuts differ near their seams); K1, 2x2 "
        f"form, K1 step, head 3x3 form {k1s['strips']} (strips) and "
        f"{k1s['tiles']} (tiles); "
        f"{ms['strips']:.1f} ms and {ms['tiles']:.1f} ms ({tag})")
    if not exact or not db > 30.0 or k1s["strips"] != (
            n * K1_FOLDED, n * K1_2X2, n * RDB_STEPS,
            n * K1_HEAD) or not k1s["tiles"][2]:
        raise AssertionError(f"strips request: exact {exact}, PSNR {db}, "
                             f"K1, 2x2 form, K1 step and head 3x3 form "
                             f"{k1s}")
    for k1, k2x2, steps, khead in k1s.values():
        counts["conv3x3"] += k1
        counts["conv2x2_s2d"] += k2x2
        counts["conv3x3_rdb"] += steps
        counts["conv3x3_head"] += khead

    # ---- one process group on NCCL at world size 1 -------------------------
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "1", "RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        joined = distributed.init_multihost()
        init_s = time.perf_counter() - t0
        backend = torch.distributed.get_backend() if joined else None
        hmesh = distributed.make_hybrid_mesh(devices=list(mesh))
        tiles = torch.rand((2 * n, 268, 268, 3), generator=gen,
                           device="cuda")
        gathered = [torch.empty_like(tiles)]
        torch.distributed.all_gather(gathered, tiles)
        # the gathered batch through the hybrid mesh's local slots
        ok = torch.equal(torch.cat([t.to(mesh[0]) for t in shard_tiles(
            gathered[0], hmesh.local())]), tiles)
        sliced = distributed.local_tile_slice(10)
        torch.distributed.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"multi-device multi-process: init_multihost with WORLD_SIZE 1, RANK "
        f"0 on 127.0.0.1 -> {joined} ({backend}, {init_s:.2f} s); hybrid mesh "
        f"{hmesh.axis_names} {hmesh.devices.shape}; all_gather of a {2 * n} x "
        f"268^2 tile batch, sharded over the local slots, equal: {ok}; "
        f"local_tile_slice(10) {sliced}; process group destroyed")
    if not (joined and backend == "nccl" and ok
            and hmesh.devices.shape == (1, n) and sliced == slice(0, 10)):
        raise AssertionError("multi-process init on NCCL failed")

    # ---- the dry run over the mesh -----------------------------------------
    dryrun_multichip(mesh)

    logging.getLogger("nesr").removeHandler(warnings)
    ladder = [m for m in warnings.messages
              if m.startswith(LADDER_WARNINGS)]
    if ladder:
        raise AssertionError(f"a sharded rung fell back: {ladder}")
    log(f"multi-device phase: no ladder warning; "
        f"{time.perf_counter() - t_phase:.1f} s in all; launches {counts}")
    return counts


# ---- Training and the entry points ------------------------------------------

TRAIN_IMAGE = (768, 1024)    # H, W of the seeded image a step's patches cut
TRAIN_BATCH = 16             # HR patches a full-width step
TRAIN_PATCH = 256            # HR patch edge: 64-px LR patches, 65,536 LR px
TRAIN_STEPS = 3
TRAIN_RATE = 2e-3
TOL_TRAIN_LOSS = 1e-5        # each step's loss, K1f against the plain convs
TOL_TRAIN_GRAD = 1e-3        # each parameter's first-step gradient: norm of
#                              the difference over the norm
# K1f launches a full-width step: 351 forward convs and 350 input gradients
# (conv_first's input needs none).
TRAIN_K1F_PER_STEP = 2 * (15 * ARCH["num_block"] + 6) - 1
# The convs of a full-width step: (label, scale over the 64-px LR patch,
# Cin, Cout, LeakyReLU). Their input gradients run K1f at Cout -> Cin.
TRAIN_CONVS = [("conv_first", 1, 12, 64, False),
               ("rdb conv1", 1, 64, 32, True), ("rdb conv2", 1, 96, 32, True),
               ("rdb conv3", 1, 128, 32, True),
               ("rdb conv4", 1, 160, 32, True),
               ("rdb conv5", 1, 192, 64, False),
               ("conv_body", 1, 64, 64, False), ("conv_up1", 2, 64, 64, True),
               ("conv_up2, conv_hr", 4, 64, 64, True),
               ("conv_last", 4, 64, 3, False)]
X2PLUS_ARCH = dict(ARCH, num_in_ch=3, scale=2)
ENTRY_IMAGE = (96, 128)      # H, W of the entry-point scripts' input
# A script of the repo in a subprocess, as `python <script>` runs it,
# printing the kernels' launch counts after it returns.
SCRIPT_COUNTED = (
    "import json, runpy, sys\n"
    "from neural_enhanced_super_resolution_torch.kernels import (\n"
    "    conv2x2_s2d, conv2x2_s2d_f32, conv2x2_s2d_plain, conv3x3,\n"
    "    conv3x3_f32, conv3x3_head, conv3x3_head_f32, conv3x3_plain,\n"
    "    conv3x3_rdb, conv3x3_rdb_plain)\n"
    "sys.argv = sys.argv[1:]\n"
    "rc = 0\n"
    "try:\n"
    "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "except SystemExit as exc:\n"
    "    rc = exc.code\n"
    "print('COUNTS ' + json.dumps({\n"
    "    'conv3x3': conv3x3.launches, 'conv3x3_f32': conv3x3_f32.launches,\n"
    "    'conv3x3_head': conv3x3_head.launches,\n"
    "    'conv3x3_head_f32': conv3x3_head_f32.launches,\n"
    "    'conv2x2_s2d': conv2x2_s2d.launches,\n"
    "    'conv2x2_s2d_f32': conv2x2_s2d_f32.launches,\n"
    "    'conv2x2_s2d_plain': conv2x2_s2d_plain.calls,\n"
    "    'conv3x3_plain': conv3x3_plain.calls,\n"
    "    'conv3x3_rdb': conv3x3_rdb.launches,\n"
    "    'conv3x3_rdb_plain': conv3x3_rdb_plain.calls}))\n"
    "sys.exit(rc)\n")


def repo_script(rel: str):
    """A script of the repo (tools/, standalone/, examples/) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "nesr_" + os.path.splitext(os.path.basename(rel))[0],
        os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def plain_k1():
    """Route RRDBNet's K1 convs (both forms, and the K1 step) to their
    plain versions: the reference a K1 forward is held against (outside
    the counted paths)."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv2x2_s2d_plain, conv3x3_plain)
    from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
        conv3x3_rdb_plain)
    from neural_enhanced_super_resolution_torch.models import rrdbnet
    kernels = rrdbnet.conv3x3, rrdbnet.conv2x2_s2d, rrdbnet.conv3x3_rdb
    rrdbnet.conv3x3 = (lambda x, w, b=None, lrelu=False, packed=None,
                       d2s=False, round_first=False:
                       conv3x3_plain(x, w, b, lrelu, d2s, round_first))
    rrdbnet.conv2x2_s2d = (lambda x, w, b, lrelu, pad, mask, d2s,
                           packed=None:
                           conv2x2_s2d_plain(x, w, b, lrelu, pad, mask, d2s))
    rrdbnet.conv3x3_rdb = (lambda k, src, w, b, slots, xn=None, x=None,
                           skip=None, packed=None:
                           conv3x3_rdb_plain(k, src, w, b, slots, xn, x,
                                             skip))
    try:
        yield
    finally:
        rrdbnet.conv3x3, rrdbnet.conv2x2_s2d, rrdbnet.conv3x3_rdb = kernels


def check_conv3x3_train(torch, gen, name: str) -> None:
    """Conv3x3Function (K1f forward, K1f input gradient, the library's
    weight gradient) against autograd through conv3x3_plain at every conv
    of a full-width step (TRAIN_CONVS on TRAIN_BATCH x 64^2 LR patches):
    y, dx, dw and db at rel <= TOL_F32 (max |err| / max |ref|). The plain
    side's LeakyReLU slope is read from the same sign as the kernel's (its
    output's), so a pre-activation within float32 rounding of 0, where the
    two forwards may disagree on the sign, does not count against the
    backward; the sign disagreements are counted and printed. Then each
    input-gradient conv (Cout -> Cin, flipped weights) timed by CUDA
    events: K1f, its plain version, the library's conv2d_input (cuDNN
    float32, TF32 off) and the bound."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        Conv3x3Function, conv3x3_f32, conv3x3_plain)
    n, lp = TRAIN_BATCH, TRAIN_PATCH // 4
    failed = []
    for label, s, cin, cout, act in TRAIN_CONVS:
        h = w = lp * s
        x = _rnd(torch, gen, n, h, w, cin, dtype=torch.float32)
        wt = _rnd(torch, gen, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5,
                  dtype=torch.float32)
        b = _rnd(torch, gen, cout, scale=0.1, dtype=torch.float32)
        gy = _rnd(torch, gen, n, h, w, cout, dtype=torch.float32)
        needs_dx = label != "conv_first"
        leaves = [x.clone().requires_grad_(needs_dx),
                  wt.clone().requires_grad_(), b.clone().requires_grad_()]
        k0 = conv3x3_f32.launches
        y = Conv3x3Function.apply(*leaves, act)
        y.backward(gy)
        launches = conv3x3_f32.launches - k0
        ref_leaves = [x.clone().requires_grad_(needs_dx),
                      wt.clone().requires_grad_(), b.clone().requires_grad_()]
        z = conv3x3_plain(*ref_leaves)
        if act:
            slope = torch.where(y.detach() >= 0, 1.0, 0.2)
            ties = int(((z.detach() >= 0) != (y.detach() >= 0)).sum())
            y_ref = conv3x3_plain(x, wt, b, True)
            (z * slope).backward(gy)
        else:
            ties, y_ref = 0, z.detach()
            z.backward(gy)
        errs = {"y": rel_err(y.detach(), y_ref)[0]
                / y_ref.abs().max().item()}
        for key, got, ref in zip(("dx", "dw", "db"), leaves, ref_leaves):
            if ref.grad is not None:
                errs[key] = ((got.grad - ref.grad).abs().max()
                             / ref.grad.abs().max()).item()
        log(f"K1f training conv {label} {(n, h, w, cin)} -> {cout} lrelu "
            f"{act}: rel err " + ", ".join(f"{k} {v:.3g}" for k, v in
                                           errs.items())
            + f" (tol {TOL_F32}); K1f launches {launches} (forward + input "
            f"gradient); sign disagreements at the LeakyReLU {ties}")
        if max(errs.values()) > TOL_F32 or launches != 1 + needs_dx:
            failed.append(f"{label}: {errs}, launches {launches}")
        del leaves, ref_leaves, y, z, y_ref
        if not needs_dx:
            continue
        # the input gradient: a SAME conv Cout -> Cin of the output gradient
        wf = wt.flip(0, 1).transpose(2, 3).contiguous()
        wc = wt.permute(3, 2, 0, 1).contiguous()
        gc = gy.permute(0, 3, 1, 2)
        ms = cuda_ms(lambda: conv3x3_f32(gy, wf))
        pms = cuda_ms(lambda: conv3x3_plain(gy, wf))
        lms = cuda_ms(lambda: torch.nn.grad.conv2d_input(
            (n, cin, h, w), wc, gc, padding=1))
        pix = n * h * w
        bms, by = bound(2.0 * pix * 9 * cin * cout,
                        4.0 * (pix * (cin + cout) + 9 * cin * cout),
                        PEAK_FP32_FLOPS)
        log(f"K1f input gradient of {label}: {(n, h, w, cout)} -> {cin}: "
            f"kernel {ms:.4f} ms plain {pms:.4f} ms conv2d_input (cuDNN f32)"
            f" {lms:.4f} ms bound {bms:.4f} ms ({by}); kernel/library "
            f"{ms / lms:.3f}, bound/kernel {bms / ms:.3f} on {name}")
        del x, gy, wf, gc
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"Conv3x3Function disagrees with autograd "
                             f"through its plain version: {failed}")


def train_full_width(torch, np, sd, name: str) -> int:
    """The full-width RRDBNet x4 (12 in, 64/23/32) trained in float32 for
    TRAIN_STEPS Adam steps at TRAIN_RATE on TRAIN_BATCH patches cut by
    numpy from a seeded 1024x768 image and preprocessed as
    tools/torch_train_tiny_esrgan.py does (its functions): once through
    Conv3x3Function (K1f), once through the plain convs (autograd through
    cuDNN's float32 conv, TF32 off), from the same seeded weights, with
    cuDNN's deterministic algorithms, so that the comparison reads the
    same in every run (its weight gradients otherwise sum in a varying
    order). Holds each step's loss (TOL_TRAIN_LOSS) and each parameter's
    first-step gradient (TOL_TRAIN_GRAD), TRAIN_K1F_PER_STEP K1f launches
    a step and no plain call on the K1f path, and prints the peak memory.
    Then, at PyTorch's defaults, as the trainer runs: two more steps each
    timed by CUDA events (forward, backward, Adam), one by the host clock
    and one profiled (the device-busy share: the profiled step's device
    time over the host-timed step's wall). Returns the K1f launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNetConfig, TrainableRRDBNet)
    from neural_enhanced_super_resolution_torch.utils.io import imwrite_rgb
    tt = repo_script("tools/torch_train_tiny_esrgan.py")
    h, w = TRAIN_IMAGE
    path = os.path.join(OUT, "train_1024x768.png")
    imwrite_rgb(path, _noisy_images(np, 1, h, w, SEED + 40)[0])
    hr_img, lr_full = tt.training_images(path)
    rng = np.random.default_rng(SEED)
    batches = [tuple(torch.from_numpy(a).to("cuda")
                     for a in tt.sample_batch(rng, hr_img, lr_full,
                                              TRAIN_BATCH, TRAIN_PATCH))
               for _ in range(TRAIN_STEPS + 4)]
    cfg = RRDBNetConfig(**ARCH)
    tt.tf32_off("cuda")

    def step(model, opt, lr, hr, plain):
        opt.zero_grad(set_to_none=True)
        loss = tt.l1_loss(model, lr, hr, plain)
        loss.backward()
        opt.step()
        return loss

    def run(plain: bool):
        model = TrainableRRDBNet(cfg, sd, "cuda")
        opt = torch.optim.Adam(model.parameters(), TRAIN_RATE)
        losses, grads = [], None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_f32_counts()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for i, (lr, hr) in enumerate(batches[:TRAIN_STEPS]):
                opt.zero_grad(set_to_none=True)
                loss = tt.l1_loss(model, lr, hr, plain)
                loss.backward()
                if i == 0:
                    grads = {k: p.grad.detach().clone()
                             for k, p in model.named_parameters()}
                opt.step()
                losses.append(loss.item())
        finally:
            torch.cuda.synchronize()
            torch.backends.cudnn.deterministic = deterministic
        counts = _f32_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = []
        for lr, hr in batches[TRAIN_STEPS:TRAIN_STEPS + 2]:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            step(model, opt, lr, hr, plain)
            e1.record()
            torch.cuda.synchronize()
            step_ms.append(e0.elapsed_time(e1))
        return model, opt, losses, grads, step_ms, counts, peak

    model, opt, losses, grads, step_ms, counts, peak = run(False)
    lr, hr = batches[TRAIN_STEPS + 2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(model, opt, lr, hr, False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device activity only, so the host pays little for the trace
    lr, hr = batches[TRAIN_STEPS + 3]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(model, opt, lr, hr, False)
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    k1f = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and "conv3x3_f32_kernel" in e.name) / 1e6
    del model, opt, prof
    torch.cuda.empty_cache()
    _, _, ref_losses, ref_grads, ref_ms, ref_counts, ref_peak = run(True)
    torch.cuda.empty_cache()
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad_rel = {k: ((grads[k] - ref_grads[k]).norm()
                    / ref_grads[k].norm()).item() for k in grads}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"training full width 12ch x4 nf64 nb23 gc32, float32, batch "
        f"{TRAIN_BATCH} of {TRAIN_PATCH}-px HR / {TRAIN_PATCH // 4}-px LR "
        f"patches, Adam lr {TRAIN_RATE} (cuDNN deterministic): losses K1f "
        f"{', '.join(f'{v:.7f}' for v in losses)} plain "
        f"{', '.join(f'{v:.7f}' for v in ref_losses)}, rel "
        f"{', '.join(f'{v:.3g}' for v in loss_rel)} (tol {TOL_TRAIN_LOSS}); "
        f"first-step gradients: worst norm ratio {grad_rel[worst]:.3g} "
        f"({worst}; tol {TOL_TRAIN_GRAD}); counts K1f path {counts}, plain "
        f"path {ref_counts}; peak memory K1f path {peak:.2f} GiB, plain "
        f"path {ref_peak:.2f} GiB")
    log(f"training step (forward, backward, Adam; CUDA events) K1f path "
        f"{', '.join(f'{v:.2f}' for v in step_ms)} ms, plain path "
        f"{', '.join(f'{v:.2f}' for v in ref_ms)} ms; a step by the host "
        f"clock {1e3 * wall:.2f} ms, device busy {1e3 * busy:.2f} ms "
        f"(profiled step; {100 * busy / wall:.1f}% busy), K1f "
        f"{1e3 * k1f:.2f} ms ({100 * k1f / busy:.1f}% of the device time) "
        f"on {name}")
    want = TRAIN_K1F_PER_STEP * TRAIN_STEPS
    if (max(loss_rel) > TOL_TRAIN_LOSS or grad_rel[worst] > TOL_TRAIN_GRAD
            or not all(math.isfinite(v) for v in losses)
            or counts["conv3x3_f32"] != want
            or any(counts[k] for k in ("conv3x3", "conv3x3_plain"))
            or ref_counts["conv3x3_f32"]):
        raise AssertionError(f"full-width training: loss rel {loss_rel}, "
                             f"gradient {grad_rel[worst]} ({worst}), counts "
                             f"{counts} (want {want} K1f launches only), "
                             f"plain path {ref_counts}")
    return counts["conv3x3_f32"]


def run_counted(args: list, label: str):
    """Popen of SCRIPT_COUNTED on ``args`` (a script and its flags)."""
    log(f"{label}: python3 {' '.join(args)}")
    return subprocess.Popen([sys.executable, "-c", SCRIPT_COUNTED, *args],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_counted(proc, label: str, t0: float):
    """(stdout, counts) of a run_counted process; fails on a non-zero
    exit."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    log(f"{label}: rc {proc.returncode} in {time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{label} failed:\n{out[-3000:]}{err[-3000:]}")
    counts = json.loads(next(line for line in out.splitlines()
                             if line.startswith("COUNTS "))[7:])
    return out, counts


def drive_training_and_entry_points(torch, np, gen, sd, ckpt: str,
                                    name: str) -> dict:
    """The training path and the entry points that mirror the JAX
    package's scripts, as subprocesses all at once:
    tools/torch_train_tiny_esrgan.py at its defaults (its s/step; the loss
    must fall), examples/torch_quickstart.py,
    standalone/torch_direct_esrgan.py on the full-width 12-channel
    checkpoint, standalone/torch_superres_project.py on a seeded
    full-width x2plus one and tools/torch_compare_reference.py --check on
    esrgan goldens recorded here with the plain convs standing in for the
    reference stack; then the trainer's checkpoint through the pipeline
    against bicubic; the x2plus form's forward and K1
    at the stock trunk's shapes against the plain versions;
    Conv3x3Function at every conv of a full-width step; the full-width
    training step. Returns the launch counts (K1: the entry points; K1f:
    the tiny trainer and the full-width steps)."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv3x3, conv3x3_plain)
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNetConfig, init_rrdbnet, rrdbnet, save_state_dict)
    from neural_enhanced_super_resolution_torch.ops.resize import resize
    from neural_enhanced_super_resolution_torch.utils import psnr, ssim
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)
    t_phase = time.perf_counter()
    d = os.path.join(OUT, "entry")
    os.makedirs(d, exist_ok=True)
    hh, ww = ENTRY_IMAGE
    img_path = os.path.join(d, "entry.png")
    imwrite_rgb(img_path, _noisy_images(np, 1, hh, ww, SEED + 41)[0])
    x2ckpt = save_state_dict(
        init_rrdbnet(RRDBNetConfig(**X2PLUS_ARCH),
                     torch.Generator().manual_seed(SEED + 1)),
        os.path.join(d, "synthetic_x2plus_3ch.pth"))
    # esrgan goldens: the port's tool records, the plain convs standing in
    # for basicsr (the JAX package's test stands its own forward in)
    pt = repo_script("tools/torch_compare_reference.py")

    def plain_reference(weights, inp):
        with plain_k1():
            return pt.run_ours(weights, inp, "cuda")

    pt.run_reference = plain_reference
    gold = os.path.join(d, "esrgan_goldens.npz")
    if pt.main(["--record", gold, "--weights", ckpt, "--images", img_path,
                "--crop", "512"]) != 0:
        raise AssertionError("compare_reference --record failed")

    # All five start at once: a process takes ~8 s to reach the card, the
    # four entry points end within ~11 s and the trainer's ~14 s start-up
    # (its clock starts at its first step) outlasts them.
    tiny = os.path.join(d, "tiny_trained_x4_torch.safetensors")
    t0 = time.perf_counter()
    procs = {
        "tiny trainer": run_counted(["tools/torch_train_tiny_esrgan.py",
                                     "--out", tiny], "tiny trainer"),
        "quickstart": run_counted(["examples/torch_quickstart.py",
                                   "--output_dir", os.path.join(d, "qs")],
                                  "quickstart"),
        "direct_esrgan": run_counted(
            ["standalone/torch_direct_esrgan.py", img_path, "-o",
             os.path.join(d, "direct.png"), "-m", ckpt], "direct_esrgan"),
        "superres_project": run_counted(
            ["standalone/torch_superres_project.py", "-i", img_path, "-o",
             os.path.join(d, "superres"), "--model", x2ckpt],
            "superres_project"),
        "compare --check": run_counted(
            ["tools/torch_compare_reference.py", "--check", gold,
             "--weights", ckpt], "compare_reference --check")}
    outs, counts = {}, {}
    try:
        for label, proc in list(procs.items())[::-1]:
            outs[label], counts[label] = finish_counted(proc, label, t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    tcounts = counts.pop("tiny trainer")
    db = {k: float(line.split("PSNR")[1].split("dB")[0])
          for line in outs["quickstart"].splitlines()
          for k in ("bicubic", "enhanced") if line.startswith(k)}
    direct = imread_rgb(os.path.join(d, "direct.png"))
    superres = imread_rgb(os.path.join(d, "superres",
                                       "entry_enhanced_x4.0.png"))
    log(f"entry points: "
        f"quickstart PSNR {db}; direct_esrgan {direct.shape}; "
        f"superres_project -n 2 {superres.shape}; compare --check: "
        + next(line for line in outs["compare --check"].splitlines()
               if line.startswith("worst"))
        + f"; counts {counts}")
    # K1, its 2x2 form, the K1 step and the head 3x3 form a forward:
    # K1_STOCK and none (the 12-channel checkpoint, stock trunk, one tile;
    # x2plus, stock trunk, two iterations), K1_FOLDED, K1_2X2, RDB_STEPS
    # and K1_HEAD (the check's fused trunk, one image)
    want = {"quickstart": None, "direct_esrgan": (K1_STOCK, 0, 0, 0),
            "superres_project": (2 * K1_STOCK, 0, 0, 0),
            "compare --check": (K1_FOLDED, K1_2X2, RDB_STEPS, K1_HEAD)}
    for label, c in counts.items():
        if (c["conv3x3_plain"] or c["conv3x3_f32"] or c["conv3x3"] == 0
                or c["conv2x2_s2d_plain"] or c["conv2x2_s2d_f32"]
                or c["conv3x3_rdb_plain"] or c["conv3x3_head_f32"]
                or want[label] not in (None, (c["conv3x3"],
                                              c["conv2x2_s2d"],
                                              c["conv3x3_rdb"],
                                              c["conv3x3_head"]))):
            raise AssertionError(f"{label}: counts {c}, K1, 2x2 form, K1 "
                                 f"step and head 3x3 form want "
                                 f"{want[label]}")
    if (not db.get("enhanced", 0) > db.get("bicubic", 1e9)
            or direct.shape != (4 * hh, 4 * ww, 3)
            or superres.shape != (4 * hh, 4 * ww, 3)):
        raise AssertionError(f"entry points: quickstart {db}, direct "
                             f"{direct.shape}, superres {superres.shape}")

    # the tiny trainer at its defaults
    lines = outs["tiny trainer"].splitlines()
    per_step = next(line for line in lines if "s/step" in line)
    first, final = (float(v) for v in next(
        line for line in lines if line.startswith("first loss")
    ).split("first loss ")[1].split(";")[0].split(" -> final "))
    log(f"tiny trainer (800 steps, batch 32, 48-px patches, 16/2/8): "
        f"{per_step}; loss {first} -> {final}; counts {tcounts} on {name}")
    if (not final < first or tcounts["conv3x3_f32"] == 0
            or tcounts["conv3x3_plain"] or tcounts["conv3x3"]):
        raise AssertionError(f"tiny trainer: loss {first} -> {final}, "
                             f"counts {tcounts}")
    # its checkpoint through the pipeline on the card, as
    # tests/test_quality.py::test_trained_model_beats_bicubic runs it
    hr = imread_rgb(os.path.join(ROOT, "tests", "fixtures", "test.jpeg"))
    lr = resize(torch.from_numpy(hr.copy()),
                dsize=(hr.shape[1] // 4, hr.shape[0] // 4),
                interpolation="bicubic").numpy()
    pipe = SuperResolutionPipeline("cuda", {
        "iterations": 1, "use_diffusion": False, "segment_enhancement": False,
        "denoise_level": 0, "adaptive_sharpening": False,
        "esrgan_model_path": tiny, "esrgan_arch": dict(FIXTURE_ARCH),
        "output_dir": os.path.join(d, "quality")})
    enhanced = pipe.enhance_array(lr)
    bicubic = resize(torch.from_numpy(lr), dsize=(hr.shape[1], hr.shape[0]),
                     interpolation="bicubic").numpy()
    q = {"psnr": (psnr(hr, enhanced), psnr(hr, bicubic)),
         "ssim": (ssim(hr, enhanced), ssim(hr, bicubic))}
    log(f"tiny trainer's checkpoint through the pipeline on the card (bf16)"
        f" at the fixture: PSNR {q['psnr'][0]:.3f} dB vs bicubic "
        f"{q['psnr'][1]:.3f}, SSIM {q['ssim'][0]:.4f} vs {q['ssim'][1]:.4f}")
    if not (q["psnr"][0] > q["psnr"][1] and q["ssim"][0] > q["ssim"][1]):
        raise AssertionError(f"the trained checkpoint does not beat bicubic: "
                             f"{q}")
    del pipe

    # the x2plus form (stock trunk, bf16, whole image) against its plain
    # versions, and K1 at every shape it gave
    sr = repo_script("standalone/torch_superres_project.py"
                     ).SuperResolutionPipeline("cuda", 1, True, 0.5, x2ckpt)
    src = torch.from_numpy(imread_rgb(img_path)).to("cuda")
    shapes = set()

    def conv_key(x, w, bias=None, lrelu=False, packed=None, d2s=False,
                 round_first=False):
        return (*x.shape, w.shape[3], bias is not None, bool(lrelu))

    with recording(rrdbnet, "conv3x3", shapes, conv_key):
        got = sr._esrgan_x2(src)
    with plain_k1():
        ref = sr._esrgan_x2(src)
    x = src.flip(-1).float()[None] / 255.0
    dy, ry = rel_err(sr.model(x), sr.model(x, plain=True))
    diff = (got.int() - ref.int()).abs()
    log(f"x2plus form (full width, stock trunk, bf16) on {tuple(x.shape)}: "
        f"forward rel err {ry:.3g} vs the plain versions (tol "
        f"{TOL_FORWARD}); uint8 output max diff {diff.max().item()}, "
        f"{100 * (diff > 0).float().mean().item():.3f}% differ")
    if not ry <= TOL_FORWARD or got.shape != (2 * hh, 2 * ww, 3):
        raise AssertionError(f"x2plus form: rel err {ry}")
    for n, h, w, cin, cout, bias, act in sorted(shapes):
        xs = _rnd(torch, gen, n, h, w, cin)
        wt = _rnd(torch, gen, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        b = _rnd(torch, gen, cout, scale=0.1, dtype=torch.float32)
        da, ra = rel_err(conv3x3(xs, wt, b, act), conv3x3_plain(xs, wt, b,
                                                               act))
        ms = cuda_ms(lambda: conv3x3(xs, wt, b, act))
        bms, by = bound(2.0 * n * h * w * 9 * cin * cout,
                        2.0 * (n * h * w * (cin + cout) + 9 * cin * cout))
        log(f"K1 conv3x3 x2plus {(n, h, w, cin)} -> {cout} lrelu {act}: "
            f"rel {ra:.3g} (tol {TOL_KERNEL}) kernel {ms:.4f} ms (packing "
            f"included) bound {bms:.4f} ms ({by})")
        if not ra <= TOL_KERNEL:
            raise AssertionError(f"K1 at the x2plus shape {(n, h, w, cin)} "
                                 f"-> {cout}: rel {ra}")
    del sr, src, x, got, ref
    torch.cuda.empty_cache()

    check_conv3x3_train(torch, gen, name)
    k1f = train_full_width(torch, np, sd, name)
    log(f"training and entry points phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"conv3x3": sum(c["conv3x3"] for c in counts.values()),
            "conv2x2_s2d": sum(c["conv2x2_s2d"] for c in counts.values()),
            "conv3x3_rdb": sum(c["conv3x3_rdb"] for c in counts.values()),
            "conv3x3_head": sum(c["conv3x3_head"] for c in counts.values()),
            "conv3x3_f32": k1f + tcounts["conv3x3_f32"]}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        import torch
        import neural_enhanced_super_resolution_torch as pkg
        from neural_enhanced_super_resolution_torch.models import (
            RRDBNetConfig, init_rrdbnet, save_state_dict)
    except ImportError as exc:
        print(f"chip_smoke: the port package is not importable ({exc}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2
    if not os.path.abspath(pkg.__file__).startswith(
            os.path.join(ROOT, PKG) + os.sep):
        print(f"chip_smoke: imported {PKG} from {pkg.__file__}, not from "
              f"this checkout ({ROOT})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 3
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    os.makedirs(OUT, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    name = f"{card} (nvidia-smi name, power.limit)"
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"CUDA {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(machine_line(torch))
    gen = torch.Generator().manual_seed(SEED)
    t_start = time.perf_counter()

    drive_precompile(name)
    build_kernels()
    log(library_line())
    results = {}
    (results["conv3x3"], results["conv2x2_s2d"],
     results["conv3x3_head"]) = check_conv3x3(torch, gen)
    results.update({"rdb_fused": check_rdb_fused(torch, gen),
                    "flash_attention": check_flash_attention(torch, gen),
                    "conv3x3_int8": check_conv3x3_int8(torch, gen)})
    results["conv3x3_int8_rdb"], results["int8_amax"] = (
        check_conv3x3_int8_rdb(torch, gen))
    results["conv3x3_rdb"] = check_conv3x3_rdb(torch, gen)
    results["conv3x3_rdb_f32"], k1f_trunk_shapes = check_conv3x3_rdb_f32(
        torch, gen)
    check_f32_unaligned(torch)
    sd = init_rrdbnet(RRDBNetConfig(**ARCH), torch.Generator().manual_seed(
        SEED))
    check_forward(torch, gen, sd, name)
    check_forward_int8(torch, gen, sd, name)
    check_int8_quality(torch, np)
    ckpt = save_state_dict(sd, os.path.join(OUT, "synthetic_x4_12ch.pth"))
    snap = write_sd_snapshot(torch)
    check_diffusion_forward(torch, snap, name)
    vae_counts = drive_vae_encode(torch, snap, name)
    seg = write_segformer_snapshot(torch)
    check_segformer(torch, seg, name)
    results["nl_means"] = check_nlmeans(torch, np, name)
    counts = drive_product_path(torch, np, ckpt)
    sd_counts, sd_cli_counts = drive_diffusion_path(torch, np, ckpt, snap)
    default_counts = drive_default_config(torch, np, ckpt, snap, seg,
                                          sd_cli_counts)
    default_ip_counts = drive_default_in_process(torch, np, ckpt, snap, seg,
                                                 name)
    tiled_counts = drive_denoise_segmentation(torch, np, ckpt, seg, name)
    swin = write_swinir_checkpoint(torch)
    check_swinir_forward(torch, np, swin, name)
    swin_counts = drive_swinir_requests(torch, np, ckpt, swin, snap, seg,
                                        name)
    batch_counts = drive_batch_cli(np, ckpt, swin, seg)
    mode_counts = drive_int8_and_parity(torch, np, ckpt, name)
    stream_counts = drive_streamed_overlap(torch, np, ckpt, name)
    md_counts = drive_multi_device(torch, np, sd, ckpt, snap, seg, name)
    check_against_cpu(torch, np, ckpt)
    check_against_cpu(torch, np, ckpt, seg)
    check_parity_against_cpu(torch, np, ckpt)
    check_diffusion_against_cpu(torch, np)
    (f32_counts, k1f_shapes, k2x2f_shapes, k3f_shapes,
     k1hf_shapes) = drive_float32(torch, np, ckpt, snap, name)
    fwd_k1f, fwd_shapes, fwd_2x2, fwd_head = check_forward_f32(
        torch, gen, sd, name)
    (results["conv3x3_f32"], results["conv2x2_s2d_f32"],
     results["conv3x3_head_f32"]) = check_conv3x3_f32(
        torch, gen,
        sorted(set(k1f_shapes) | set(fwd_shapes) | set(k1f_trunk_shapes)),
        sorted(set(k2x2f_shapes) | set(fwd_2x2)),
        sorted(set(k1hf_shapes) | set(fwd_head)))
    results["flash_attention_f32"] = check_flash_attention_f32(
        torch, gen, k3f_shapes)
    train_launches = drive_training_and_entry_points(torch, np, gen, sd,
                                                     ckpt, name)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    # Launches: each path's count, zeroed before it and read after it.
    launches = {"conv3x3": counts["conv3x3"] + sd_counts["conv3x3"]
                + default_counts["conv3x3"] + default_ip_counts["conv3x3"]
                + tiled_counts["conv3x3"] + swin_counts["conv3x3"]
                + batch_counts["conv3x3"]
                + sum(c["conv3x3"] for c in mode_counts.values())
                + stream_counts["conv3x3"] + md_counts["conv3x3"]
                + train_launches["conv3x3"],
                "rdb_fused": counts["rdb_fused"],
                "conv3x3_rdb": counts["conv3x3_rdb"]
                + sd_counts["conv3x3_rdb"] + default_counts["conv3x3_rdb"]
                + default_ip_counts["conv3x3_rdb"]
                + tiled_counts["conv3x3_rdb"] + swin_counts["conv3x3_rdb"]
                + batch_counts["conv3x3_rdb"]
                + sum(c["conv3x3_rdb"] for c in mode_counts.values())
                + stream_counts["conv3x3_rdb"] + md_counts["conv3x3_rdb"]
                + train_launches["conv3x3_rdb"],
                "conv3x3_int8_rdb": mode_counts["int8"]["conv3x3_int8_rdb"]
                + mode_counts["int8_cli"]["conv3x3_int8_rdb"],
                "int8_amax": mode_counts["int8"]["int8_amax"]
                + mode_counts["int8_cli"]["int8_amax"],
                "flash_attention": sd_counts["flash_attention"]
                + default_counts["flash_attention"]
                + default_ip_counts["flash_attention"]
                + swin_counts["flash_attention"]
                + vae_counts["flash_attention"]
                + md_counts["flash_attention"],
                "conv2x2_s2d": counts["conv2x2_s2d"]
                + sum(c["conv2x2_s2d"] for c in mode_counts.values())
                + md_counts["conv2x2_s2d"] + train_launches["conv2x2_s2d"],
                "conv3x3_head": counts["conv3x3_head"]
                + sd_counts["conv3x3_head"] + default_counts["conv3x3_head"]
                + default_ip_counts["conv3x3_head"]
                + tiled_counts["conv3x3_head"] + swin_counts["conv3x3_head"]
                + batch_counts["conv3x3_head"]
                + sum(c["conv3x3_head"] for c in mode_counts.values())
                + stream_counts["conv3x3_head"] + md_counts["conv3x3_head"]
                + train_launches["conv3x3_head"],
                "conv3x3_f32": f32_counts["conv3x3_f32"] + fwd_k1f[0]
                + train_launches["conv3x3_f32"],
                "conv2x2_s2d_f32": f32_counts["conv2x2_s2d_f32"] + fwd_k1f[1],
                "conv3x3_head_f32": f32_counts["conv3x3_head_f32"]
                + fwd_k1f[2],
                "conv3x3_rdb_f32": f32_counts["conv3x3_rdb_f32"]
                + fwd_k1f[3],
                "flash_attention_f32": f32_counts["flash_attention_f32"],
                "nl_means": default_counts["nl_means_fields"]
                + default_ip_counts["nl_means_fields"]
                + tiled_counts["nl_means_fields"]
                + swin_counts["nl_means_fields"]
                + batch_counts["nl_means_fields"]
                + md_counts["nl_means_fields"]}
    # NL-means' plain version ran on no path: every path that zeroes the
    # counts reads it (the paths without denoise included).
    plain_nlm = {label: c["nl_means_fields_plain"] for label, c in (
        ("product", counts), ("diffusion", sd_counts),
        ("default CLI", default_counts), ("default", default_ip_counts),
        ("1024x768 denoise", tiled_counts), ("SwinIR", swin_counts),
        ("batch CLI", batch_counts), ("streamed", stream_counts),
        ("float32", f32_counts))}
    if any(plain_nlm.values()):
        raise AssertionError(f"NL-means' plain version ran: {plain_nlm}")
    sources = {"conv3x3": "csrc/conv3x3.cu", "rdb_fused": "csrc/rdb_fused.cu",
               "conv3x3_head": "csrc/conv3x3_head.cu",
               "conv3x3_head_f32": "csrc/conv3x3_head_f32.cu",
               "conv3x3_rdb": "csrc/rdb_bf16.cu",
               "conv3x3_rdb_f32": "csrc/rdb_f32.cu",
               "conv2x2_s2d": "csrc/conv2x2.cu",
               "conv2x2_s2d_f32": "csrc/conv2x2_f32.cu",
               "flash_attention": "csrc/flash_attn.cu",
               "conv3x3_int8_rdb": "csrc/rdb_int8.cu",
               "int8_amax": "csrc/rdb_int8.cu",
               "conv3x3_f32": "csrc/conv3x3_f32.cu",
               "flash_attention_f32": "csrc/flash_attn_f32.cu",
               "nl_means": "csrc/nlmeans.cu"}
    # K1 also carries the math of kernels/conv3x3_v2.py:103 and of
    # rdb_pallas.py:190 (rows_s2d_conv3x3), whose trunk shapes the K1 step
    # runs on the main path.
    replaces = {
        "conv3x3": "neural_enhanced_super_resolution_tpu/kernels/"
                   "conv3x3.py:106",
        "rdb_fused": "neural_enhanced_super_resolution_tpu/kernels/"
                     "rdb_dform.py:575",
        "flash_attention": "neural_enhanced_super_resolution_tpu/kernels/"
                           "attention.py:125",
        # XLA's int8 conv (conv_q of _rdb_fused_int8), not a Pallas
        # kernel, with the quantise and the assembly around it; and
        # conv_q's per-tensor max|h|
        "conv3x3_int8_rdb": "neural_enhanced_super_resolution_tpu/models/"
                            "rrdbnet.py:255",
        "int8_amax": "neural_enhanced_super_resolution_tpu/models/"
                     "rrdbnet.py:252",
        # XLA's bf16 convs of the default trunk's _rdb_fused, not a
        # Pallas kernel, with their dense-block assembly
        "conv3x3_rdb": "neural_enhanced_super_resolution_tpu/models/"
                       "rrdbnet.py:167",
        # the same _rdb_fused in float32 (the parity mode)
        "conv3x3_rdb_f32": "neural_enhanced_super_resolution_tpu/models/"
                           "rrdbnet.py:167",
        # the float32 forms: the same Pallas kernels on float32 operands
        "conv3x3_f32": "neural_enhanced_super_resolution_tpu/kernels/"
                       "conv3x3.py:106",
        # no Pallas kernel: XLA's convs of the folded head (_head_forward),
        # in bf16 and in float32
        "conv2x2_s2d": "neural_enhanced_super_resolution_tpu/models/"
                       "rrdbnet.py:586",
        "conv3x3_head": "neural_enhanced_super_resolution_tpu/models/"
                        "rrdbnet.py:586",
        "conv3x3_head_f32": "neural_enhanced_super_resolution_tpu/models/"
                            "rrdbnet.py:586",
        "conv2x2_s2d_f32": "neural_enhanced_super_resolution_tpu/models/"
                           "rrdbnet.py:586",
        "flash_attention_f32": "neural_enhanced_super_resolution_tpu/"
                               "kernels/attention.py:125",
        # no Pallas kernel: XLA's NL-means, the joint Lab pass (and
        # _nl_means_f32 at :80, the one-field form)
        "nl_means": "neural_enhanced_super_resolution_tpu/ops/nlmeans.py:109"}
    # ms, plain_ms, bound_ms and library_ms at one shape a kernel: K1 at
    # conv_body on the tile batch, its 2x2 form and K1f's at the folded
    # head's hr on the tile batch (4 x 536^2 x 256 -> 4 x 537^2 x 256), its
    # head 3x3 form and K1f's at up2 there (4 x 536^2 x 64 -> 256), K2
    # on the tile batch, K3 at the UNet's 64^2 self-attention, the K1 step
    # and the K4 step each as one RDB's five launches on the tile batch
    # (each bound the RDB's own, the five-launch floor printed beside it),
    # int8_amax on the trunk's input there, the float32 RDB step as one
    # RDB's five launches on the tile batch (CUDA events, the RDB's own
    # bound), K1f at conv_body on TILE_BATCH (the full-width float32
    # forward's), K3f at the VAE mid-block's 1920^2, d 512 (the 48x40
    # float32 request's). K1f's three times are CUDA events over a call;
    # K3f's are device time (its plain version's too). K4's standalone
    # entry (conv3x3_int8) left the main path with this redesign: its shape
    # checks still run, and no path launches it.
    kernels = [{"name": k, "route": "cuda",
                "source": f"{PKG}/{sources[k]}", "replaces": replaces[k],
                "launches": launches[k],
                **{key: results[k][key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for k in ("conv3x3", "conv3x3_head", "conv2x2_s2d",
                         "conv3x3_rdb", "rdb_fused", "flash_attention",
                         "conv3x3_int8_rdb", "int8_amax", "conv3x3_rdb_f32",
                         "conv3x3_f32",
                         "conv3x3_head_f32", "conv2x2_s2d_f32",
                         "flash_attention_f32", "nl_means")]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels no path launched: {idle}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
