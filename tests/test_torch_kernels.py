"""The port's kernel modules: plain versions against the JAX kernels on the
CPU (the CUDA kernels against their plain versions are in
``test_torch_cuda.py``).

On the CPU the wrappers run their plain versions, and the JAX Pallas
kernels run in interpret mode as the JAX package's own tests run them.
Tolerances: f32 1e-5 absolute (same math, other summation order); bf16
1e-2 (K1) and 2e-2 (whole RDB) relative to max(1, max|ref|): bf16 rounding
points differ by at most an ulp at each of the RDB's materialisations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_tpu.kernels.conv3x3 import (
    conv3x3_lrelu)
from neural_enhanced_super_resolution_tpu.kernels.rdb_dform import (
    dform_rdb_weights, rdb_dform_reference)
from neural_enhanced_super_resolution_tpu.kernels.rdb_pallas import (
    from_rows_s2d, rearrange_w_rows_s2d, rows_s2d_conv3x3, to_rows_s2d)
from neural_enhanced_super_resolution_tpu.models import rrdbnet as jr
from neural_enhanced_super_resolution_torch.kernels import (
    KernelInputError, conv3x3, conv3x3_f32, conv3x3_plain, rdb_fused,
    rdb_fused_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    TILE_WIDTHS, pack_conv3x3_weights, pass_width, tile_width)
from neural_enhanced_super_resolution_torch.models.rrdbnet import (
    FusedRDB, fuse_rdb)


def _rel(got, ref) -> float:
    got = np.asarray(torch.as_tensor(got).float() if torch.is_tensor(got)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("cin,cout,bias,act", [
    (12, 64, True, False), (32, 64, True, True), (16, 3, True, False)])
def test_conv3x3_plain_matches_pallas_conv3x3(rng, cin, cout, bias, act):
    x = rng.standard_normal((2, 13, 16, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    if not bias:
        b = np.zeros_like(b)
    ref = conv3x3_lrelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        apply_act=act, block_rows=8, interpret=True)
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(b) if bias else None, act)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize("cin,cout,bias,act", [
    (12, 64, True, False), (64, 192, False, False), (64, 3, True, True)])
def test_conv3x3_f32_on_cpu_matches_pallas_conv3x3(rng, cin, cout, bias,
                                                   act):
    """K1's float32 form takes the plain version on the CPU, and that
    matches the JAX conv kernel on float32 operands (what K1f replaces in
    the parity mode), with no launch."""
    x = rng.standard_normal((1, 11, 18, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    if not bias:
        b = np.zeros_like(b)
    ref = conv3x3_lrelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        apply_act=act, block_rows=8, interpret=True)
    launches, calls = conv3x3_f32.launches, conv3x3_plain.calls
    got = conv3x3_f32(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b) if bias else None, act)
    assert (conv3x3_f32.launches, conv3x3_plain.calls) == (launches,
                                                           calls + 1)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 96)])
def test_conv3x3_plain_matches_pallas_rows_s2d(rng, cin, cout):
    """Bias-free bf16 conv with bf16 output: the fused trunk's conv."""
    x = jnp.asarray(rng.standard_normal((2, 10, 16, cin)), jnp.bfloat16)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    wk = jnp.asarray(rearrange_w_rows_s2d(w), jnp.bfloat16)
    ref = from_rows_s2d(rows_s2d_conv3x3(to_rows_s2d(x), wk, interpret=True))
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got = conv3x3(xt, torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 1e-2


def _unpack_by_descriptor(packed, cin, cout, lbo=128, sbo=256):
    """Read K1's packed weights back to HWIO the way the kernel's wgmma
    does: with kc = pass_width(Cin) and Kp = Cin padded to kc, slab i =
    (pass i // 9, tap i % 9) of N tile `tile` at (tile * 9 * Kp + i * kc)
    * N elements, k-step s of a slab at s * 16 * N, and within a k-step
    element (k, n) at byte (n // 8) * SBO + (n % 8) * 16 + (k // 8) * LBO
    + (k % 8) * 2 from the descriptor's start (K-major, no swizzle).
    Returns (HWIO padded to (3, 3, Kp, tiles * N), how many times each
    packed element was read)."""
    nw, tiles = tile_width(cout)
    kc = pass_width(cin)
    kp = -(-cin // kc) * kc
    flat = packed.view(torch.int16)
    out = torch.zeros((3, 3, kp, tiles * nw), dtype=torch.int16)
    hits = torch.zeros(flat.numel(), dtype=torch.int64)
    k = torch.arange(16).view(16, 1)
    n = torch.arange(nw).view(1, nw)
    inner = ((n // 8) * sbo + (n % 8) * 16 + (k // 8) * lbo
             + (k % 8) * 2) // 2
    for tile in range(tiles):
        for i in range(9 * kp // kc):
            c0, t = i // 9 * kc, i % 9
            for s in range(kc // 16):
                idx = (tile * 9 * kp + i * kc + s * 16) * nw + inner
                out[t // 3, t % 3, c0 + 16 * s:c0 + 16 * s + 16,
                    tile * nw:(tile + 1) * nw] = flat[idx]
                hits.index_add_(0, idx.reshape(-1),
                                torch.ones(idx.numel(), dtype=torch.int64))
    return out.view(torch.bfloat16), hits


@pytest.mark.parametrize("cin,cout", [
    (12, 64), (64, 192), (32, 160), (32, 128), (32, 96), (32, 64), (64, 64),
    (64, 3), (8, 24), (130, 300)],
    ids=["conv_first", "w0", "w1", "w2", "w3", "w4", "conv_body",
         "conv_last", "tiny_nf8_gc4", "two_passes_two_tiles"])
def test_pack_conv3x3_weights_matches_descriptor_layout(rng, cin, cout):
    """K1's weight image, read back through the wgmma descriptor's
    addressing, is the HWIO weight, zero-padded past Cin and Cout, and
    every packed element is read exactly once."""
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(
        np.float32)).bfloat16()
    packed = pack_conv3x3_weights(w)
    nw, tiles = tile_width(cout)
    kp = -(-cin // pass_width(cin)) * pass_width(cin)
    assert nw in TILE_WIDTHS and nw % 8 == 0 and tiles * nw >= cout
    assert kp == {12: 16, 8: 16, 32: 32, 64: 64, 130: 192}[cin]
    assert packed.dtype == torch.bfloat16 and packed.dim() == 1
    assert packed.numel() == tiles * 9 * kp * nw
    got, hits = _unpack_by_descriptor(packed, cin, cout)
    assert torch.equal(got[:, :, :cin, :cout], w)
    assert not got[:, :, cin:].any() and not got[:, :, :, cout:].any()
    assert torch.equal(hits, torch.ones_like(hits))


@pytest.mark.parametrize("cout,want", [(3, (8, 1)), (24, (32, 1)),
                                       (64, (64, 1)), (128, (128, 1)),
                                       (160, (80, 2)), (192, (96, 2)),
                                       (256, (128, 2)), (300, (128, 3))])
def test_tile_width(cout, want):
    assert tile_width(cout) == want


def _fused_rdb(nf, gc, seed=0):
    """One RDB's source-major weights (numpy, from a seed): stock conv1..5
    regrouped by ``fuse_rdb``, exact against the JAX package's fuse."""
    r = np.random.default_rng(seed)
    ws, bs = [], []
    for k in range(5):
        cin, cout = nf + k * gc, gc if k < 4 else nf
        ws.append(torch.from_numpy((r.standard_normal((3, 3, cin, cout))
                                    * (2.0 / (9 * cin)) ** 0.5)
                                   .astype(np.float32)))
        bs.append(torch.from_numpy((r.standard_normal(cout) * 0.05)
                                   .astype(np.float32)))
    fw, fb = fuse_rdb(ws, bs)
    return {**{f"w{i}": w.numpy() for i, w in enumerate(fw)}, "b": fb.numpy()}


def _torch_rdb(rdb):
    return ([torch.tensor(rdb[f"w{i}"]).bfloat16() for i in range(5)],
            torch.tensor(rdb["b"]).float())


@pytest.mark.parametrize("nf,gc,h,w", [(8, 4, 24, 16), (64, 32, 32, 48)])
def test_rdb_fused_plain_matches_dform_reference_v2(rng, nf, gc, h, w):
    rdb = _fused_rdb(nf, gc)
    x = jnp.asarray(rng.normal(0, 0.5, (2, h, w, nf)), jnp.bfloat16)
    ref = from_rows_s2d(jax.jit(rdb_dform_reference, static_argnums=(2, 3))(
        to_rows_s2d(x), dform_rdb_weights(rdb), gc, True))
    ws, b = _torch_rdb(rdb)
    got = rdb_fused(torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
                    ws, b)
    assert got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 2e-2


@pytest.mark.parametrize("nf,gc,h,w", [(8, 4, 24, 16), (64, 32, 32, 48)])
@pytest.mark.parametrize("kernel", [True, False], ids=["k2", "k1_fused"])
def test_fused_rdb_matches_jax_rdb_fused(rng, nf, gc, h, w, kernel):
    """Both port trunks' RDB (one K2 call, or five K1 convs with the
    elementwise assembly) against the JAX package's production fused RDB
    in bf16."""
    rdb = _fused_rdb(nf, gc, seed=1)
    x = jnp.asarray(rng.normal(0, 0.5, (2, h, w, nf)), jnp.bfloat16)
    ref = jr._rdb_fused(x, {k: jnp.asarray(v) for k, v in rdb.items()}, gc,
                        jnp.bfloat16)
    ws, b = _torch_rdb(rdb)
    mod = FusedRDB(ws, b, torch.bfloat16, "cpu", kernel=kernel)
    got = mod(torch.from_numpy(np.asarray(x, np.float32)).bfloat16())
    assert _rel(got, ref) <= 2e-2


def test_cpu_wrappers_take_the_plain_version(rng):
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, 64)).astype(
        np.float32)).bfloat16()
    ws = [torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16)
          for cin, cout in ((64, 192), (32, 160), (32, 128), (32, 96),
                            (32, 64))]
    b = torch.zeros(192)
    k1, k2 = conv3x3.launches, rdb_fused.launches
    p1, p2 = conv3x3_plain.calls, rdb_fused_plain.calls
    torch.testing.assert_close(rdb_fused(x, ws, b), x, rtol=0, atol=0)
    conv3x3(x, ws[0])
    assert (conv3x3.launches, rdb_fused.launches) == (k1, k2)
    assert rdb_fused_plain.calls == p2 + 1
    assert conv3x3_plain.calls >= p1 + 6


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on any other non-CUDA device gets no silent plain run."""
    x = torch.empty((1, 6, 7, 64), dtype=torch.bfloat16, device="meta")
    ws = [torch.empty((3, 3, cin, cout), dtype=torch.bfloat16, device="meta")
          for cin, cout in ((64, 192), (32, 160), (32, 128), (32, 96),
                            (32, 64))]
    calls = (conv3x3_plain.calls, rdb_fused_plain.calls)
    with pytest.raises(KernelInputError, match="no kernel"):
        conv3x3(x, ws[0])
    with pytest.raises(KernelInputError, match="no kernel"):
        rdb_fused(x, ws, torch.empty(192, device="meta"))
    with pytest.raises(KernelInputError, match="no kernel"):
        conv3x3_f32(x.float(), ws[0].float())
    assert (conv3x3_plain.calls, rdb_fused_plain.calls) == calls

