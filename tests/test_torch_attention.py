"""K3's plain version and the attention dispatcher against the JAX package.

The JAX side runs as its own tests run it on the CPU: ``flash_attention``
in Pallas interpret mode, with ``NESR_FLASH_KV_VMEM_MB`` lowered to reach
the KV-gridded lowering (tests/test_kernels.py:49-80); ``attention_auto``
through the XLA path. Inputs are made with numpy from a seed.

Tolerances: float32, max|port - jax| < 2e-5 (as tests/test_kernels.py:33);
bfloat16, max|port - jax| <= 1e-2 * max|jax| (both round P to bf16, at
different running maxima); ``attention_auto`` in float32, 1e-5 *
max(1, max|jax|) (normalised vs unnormalised softmax).
"""

import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_enhanced_super_resolution_tpu.kernels.attention import (
    attention_auto as jax_attention_auto, flash_attention as jax_flash)
from neural_enhanced_super_resolution_torch.kernels import (
    KernelInputError, attention_auto, flash_attention, flash_attention_f32,
    flash_attention_plain)
from neural_enhanced_super_resolution_torch.kernels.attention import (
    F32_TILES, flash_f32_splits)

# (id, B, H, Sq, Skv, d, block_q, block_k, kv budget MB or None)
CASES = [
    ("s256", 1, 2, 256, 256, 64, 128, 128, None),
    ("s300_ragged", 1, 2, 300, 300, 64, 128, 128, None),
    ("cross_200x100_d32", 1, 2, 200, 100, 32, 128, 64, None),
    ("d512_s300_kvgrid", 1, 1, 300, 300, 512, 128, 64, "0.5"),
]


def _inputs(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, skv, d)).astype(np.float32),
            rng.standard_normal((b, h, skv, d)).astype(np.float32))


def _jax(q, k, v, dtype, block_q, block_k):
    out = jax_flash(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                    block_q=block_q, block_k=block_k)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, dtype):
    return flash_attention_plain(
        *(torch.from_numpy(t).to(dtype) for t in (q, k, v))).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_plain_matches_jax_flash(case, dtype, monkeypatch):
    """Tolerance: f32 2e-5 absolute; bf16 1e-2 of max|jax|."""
    _, b, h, sq, skv, d, bq, bk, budget = case
    if budget:
        monkeypatch.setenv("NESR_FLASH_KV_VMEM_MB", budget)
    q, k, v = _inputs(sum(map(ord, case[0])), b, h, sq, skv, d)
    ref = _jax(q, k, v, getattr(jnp, dtype), bq, bk)
    got = _port(q, k, v, getattr(torch, dtype))
    assert got.shape == ref.shape
    if dtype == "float32":
        assert np.abs(got - ref).max() < 2e-5
    else:
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_padded_keys_extreme_scores(dtype):
    """Every real score is -2048 (q = 16, k = -16, d = 64), Skv = 100 is
    ragged: the softmax is uniform over the real keys, in both packages.
    Tolerance 2e-3 absolute, as tests/test_kernels.py:213."""
    rng = np.random.default_rng(7)
    q = np.full((1, 1, 8, 64), 16.0, np.float32)
    k = np.full((1, 1, 100, 64), -16.0, np.float32)
    v = rng.normal(size=(1, 1, 100, 64)).astype(np.float32)
    ref = _jax(q, k, v, getattr(jnp, dtype), 8, 64)
    got = _port(q, k, v, getattr(torch, dtype))
    want = v.mean(axis=2, keepdims=True).repeat(8, axis=2)
    np.testing.assert_allclose(ref, want, atol=2e-3)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_flash_attention_on_cpu_takes_the_plain_version():
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 1, 2, 40, 50, 16))
    launches, calls = flash_attention.launches, flash_attention_plain.calls
    out = flash_attention(q, k, v)
    assert (flash_attention.launches, flash_attention_plain.calls) == (
        launches, calls + 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(16)
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
    assert torch.allclose(out, ref, atol=1e-5)


def test_flash_attention_refuses_other_devices():
    q = torch.zeros((1, 1, 8, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(KernelInputError):
        flash_attention(q, q, q)
    with pytest.raises(KernelInputError):
        flash_attention_f32(q.float(), q.float(), q.float())


@pytest.mark.parametrize("case", CASES[1:], ids=[c[0] for c in CASES[1:]])
def test_flash_attention_f32_on_cpu_matches_jax_flash(case, monkeypatch):
    """K3's float32 form takes the plain version on the CPU, and that
    matches the JAX kernel on float32 operands (what K3f replaces in the
    parity mode) to 2e-5 absolute, with no launch."""
    _, b, h, sq, skv, d, bq, bk, budget = case
    if budget:
        monkeypatch.setenv("NESR_FLASH_KV_VMEM_MB", budget)
    q, k, v = _inputs(sum(map(ord, case[0])) + 1, b, h, sq, skv, d)
    ref = _jax(q, k, v, jnp.float32, bq, bk)
    launches, calls = (flash_attention_f32.launches,
                       flash_attention_plain.calls)
    got = flash_attention_f32(*(torch.from_numpy(t) for t in (q, k, v)))
    assert (flash_attention_f32.launches, flash_attention_plain.calls) == (
        launches, calls + 1)
    assert np.abs(got.numpy() - ref).max() < 2e-5


@pytest.mark.parametrize("b,s,dm,heads", [(2, 64, 32, 2), (1, 100, 64, 1),
                                          (1, 117, 256, 2)])
def test_attention_auto_matches_jax(b, s, dm, heads):
    """Unmasked packed-heads attention, f32: 1e-5 of max(1, max|jax|)."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((b, s, dm)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jax_attention_auto(*(jnp.asarray(t) for t in (q, k, v)),
                                        heads, dtype=jnp.float32))
    calls = flash_attention_plain.calls
    got = attention_auto(*(torch.from_numpy(t) for t in (q, k, v)), heads,
                         dtype=torch.float32)
    assert flash_attention_plain.calls == calls + 1
    assert got.dtype == torch.float32 and got.shape == (b, s, dm)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_attention_auto_bf16_matches_jax():
    """bf16 compute, f32 out: 1e-2 of max|jax|."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 96, 64)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jax_attention_auto(*(jnp.asarray(t) for t in (q, k, v)),
                                        2, dtype=jnp.bfloat16))
    got = attention_auto(*(torch.from_numpy(t) for t in (q, k, v)), 2,
                         dtype=torch.bfloat16).numpy()
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


def test_attention_auto_masked_takes_the_plain_attention():
    """A mask (CLIP's causal tower) routes to layers.attention, never to
    K3, in both packages; f32 within 1e-5."""
    rng = np.random.default_rng(12)
    b, s, dm, heads = 2, 12, 32, 2
    q, k, v = (rng.standard_normal((b, s, dm)).astype(np.float32)
               for _ in range(3))
    mask = np.where(np.arange(s)[None, :] <= np.arange(s)[:, None], 0.0,
                    -np.inf).astype(np.float32)[None, None]
    ref = np.asarray(jax_attention_auto(*(jnp.asarray(t) for t in (q, k, v)),
                                        heads, mask=jnp.asarray(mask),
                                        dtype=jnp.float32))
    calls = flash_attention_plain.calls
    got = attention_auto(*(torch.from_numpy(t) for t in (q, k, v)), heads,
                         mask=torch.from_numpy(mask), dtype=torch.float32)
    assert flash_attention_plain.calls == calls
    assert np.abs(got.numpy() - ref).max() < 1e-5


# ---- K3f's key-range split and its merge ---------------------------------

def _f32_tile(d):
    return F32_TILES[next(p for p in sorted(F32_TILES) if p >= d)]


@pytest.mark.parametrize("sq,skv,bh,d", [
    (16384, 16384, 1, 512), (4096, 4096, 8, 64), (1872, 1872, 8, 64),
    (64 * 132, 1000, 1, 64), (32 * 132, 333, 1, 512), (1024, 1024, 8, 64)],
    ids=["vae_128", "unet_64", "ragged_52x36", "one_wave_d64",
         "one_wave_d512", "unet_32"])
def test_flash_f32_splits_one_split_when_query_blocks_fill_the_card(
        sq, skv, bh, d):
    """Where the query blocks alone fill 132 SMs (one a SM or more), the
    keys are not split; below that (the UNet's 32^2 grid) they are."""
    bq, bk = _f32_tile(d)
    nsplit, kps = flash_f32_splits(sq, skv, bh, d)
    qblocks = bh * -(-sq // bq)
    assert (nsplit == 1) == (qblocks >= 132)
    assert kps % bk == 0 and kps >= (skv if nsplit == 1 else bk)


def test_flash_f32_splits_fill_the_card_at_the_vae_request_shape():
    """The VAE mid-block of a 48x40 request (1920^2, d 512) runs at least
    240 blocks, in whole 128-key tiles."""
    nsplit, kps = flash_f32_splits(1920, 1920, 1, 512)
    bq, bk = _f32_tile(512)
    assert -(-1920 // bq) * nsplit >= 240
    assert kps % bk == 0 and (nsplit - 1) * kps < 1920 <= nsplit * kps


def test_flash_f32_splits_never_make_a_split_without_a_real_key():
    """Every split starts below Skv and the splits cover it, over query
    and key lengths from 1 to above the tile sizes, 1 to 64 (batch, head)
    pairs, every instantiation and 132 or 2 SMs."""
    for d in (4, 32, 64, 100, 128, 200, 256, 512):
        _, bk = _f32_tile(d)
        for sq in (1, 7, 64, 100, 1920):
            for skv in (1, 31, 32, 33, 130, 405, 1000, 4097):
                for bh in (1, 3, 64):
                    for sms in (132, 2):
                        nsplit, kps = flash_f32_splits(sq, skv, bh, d, sms)
                        assert nsplit >= 1 and kps % bk == 0
                        assert (nsplit - 1) * kps < skv <= nsplit * kps


def _split_flash(q, k, v, kps):
    """K3f's order of operations in plain PyTorch (csrc/flash_attn_f32.cu),
    float32: the keys cut into ranges of ``kps`` keys (whole BK-key tiles,
    as ``flash_f32_splits`` plans them); per split, per tile, scores q k^T
    scaled by log2(e) / sqrt(d) (base 2), the online softmax (m, l and the
    output rescaled by exp2(m_old - m_new)), the unnormalised output, m and
    l kept; then the merge: the same online step over the splits in order,
    and the division by l."""
    d, skv = q.shape[-1], k.shape[-2]
    _, bk = _f32_tile(d)
    sl = math.log2(math.e) / math.sqrt(d)
    lead = (*q.shape[:-1], 1)
    splits = []
    for s0 in range(0, skv, kps):
        m, l = torch.full(lead, -math.inf), torch.zeros(lead)
        acc = torch.zeros(q.shape)
        for k0 in range(s0, min(skv, s0 + kps), bk):
            kt, vt = k[..., k0:k0 + bk, :], v[..., k0:k0 + bk, :]
            sc = (q @ kt.transpose(-1, -2)) * sl
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha, p = torch.exp2(m - m_new), torch.exp2(sc - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vt
            m = m_new
        splits.append((acc, m, l))
    m, l = torch.full(lead, -math.inf), torch.zeros(lead)
    acc = torch.zeros(q.shape)
    for acc_s, m_s, l_s in splits:
        m_new = torch.maximum(m, m_s)
        alpha, beta = torch.exp2(m - m_new), torch.exp2(m_s - m_new)
        l = l * alpha + l_s * beta
        acc = acc * alpha + acc_s * beta
        m = m_new
    return acc / l


# splits -> the SM count for which flash_f32_splits plans them at
# (B*H 2, Sq 100, Skv 405, d 64): 4 query blocks, 13 key tiles
SMS_FOR_SPLITS = {1: 2, 2: 5, 3: 6, 7: 14}


@pytest.mark.parametrize("against", ["plain", "jax"])
@pytest.mark.parametrize("nsplit", [1, 2, 3, 7])
def test_split_walk_and_merge_match_plain_and_jax(nsplit, against):
    """The split walk, as flash_f32_splits plans it for a small SM count,
    over a ragged Skv (405 keys: 13 tiles of 32, the last ragged) against
    flash_attention_plain and the JAX Pallas kernel in float32 (interpret
    mode), q and k of std 2; 2e-5 absolute, as
    test_flash_plain_matches_jax_flash."""
    planned, kps = flash_f32_splits(100, 405, 2, 64, SMS_FOR_SPLITS[nsplit])
    assert planned == nsplit
    q, k, v = _inputs(405 + nsplit, 1, 2, 100, 405, 64)
    q, k = q * 2.0, k * 2.0
    got = _split_flash(*(torch.from_numpy(t) for t in (q, k, v)),
                       kps).numpy()
    if against == "plain":
        ref = _port(q, k, v, torch.float32)
    else:
        ref = _jax(q, k, v, jnp.float32, 128, 128)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 2e-5


@pytest.mark.parametrize("against", ["plain", "jax"])
def test_split_walk_padded_keys_extreme_scores(against):
    """Every real score -2048 (q = 16, k = -16, d = 64) over a ragged Skv
    of 90, in the 3 splits flash_f32_splits plans on 2 SMs: each split's m
    is the same, the merge weights the splits by their key counts, and the
    output is uniform over the real keys. 2e-5 absolute against the
    reference, 2e-3 against the mean (as
    test_flash_plain_padded_keys_extreme_scores)."""
    nsplit, kps = flash_f32_splits(8, 90, 1, 64, sms=2)
    assert nsplit == 3
    v = np.random.default_rng(7).normal(size=(1, 1, 90, 64)).astype(
        np.float32)
    q = np.full((1, 1, 8, 64), 16.0, np.float32)
    k = np.full((1, 1, 90, 64), -16.0, np.float32)
    got = _split_flash(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), kps).numpy()
    ref = (_port(q, k, v, torch.float32) if against == "plain"
           else _jax(q, k, v, jnp.float32, 8, 64))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    want = v.mean(axis=2, keepdims=True).repeat(8, axis=2)
    np.testing.assert_allclose(got, want, atol=2e-3)


# ---- K3's order of operations and its shared-memory layouts -------------

BK = 64   # keys a tile in both of the kernel's forms (csrc/flash_attn.cu)


def _tiled_flash(q, k, v, bk=BK):
    """K3's order of operations in plain PyTorch: bk-key tiles, S = q k^T
    once a tile in fp32 from bf16 operands, keys past Skv masked, the row
    max of each tile shared by every output column, alpha = exp(m_old -
    m_new) rescaling l and the accumulator, P = exp(S scale - m) rounded
    to bf16 for P v in fp32, l summed from the fp32 P, o = acc / l in
    bf16."""
    q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
    *lead, sq, d = q.shape
    skv = k.shape[-2]
    scale = 1.0 / math.sqrt(d)
    m = torch.full((*lead, sq, 1), -1e30)
    l = torch.zeros((*lead, sq, 1))
    acc = torch.zeros((*lead, sq, d))
    for k0 in range(0, skv, bk):
        s = q @ k[..., k0:k0 + bk, :].transpose(-1, -2)
        if s.shape[-1] < bk:   # the ragged last tile: keys past Skv
            s = torch.cat([s, torch.full((*lead, sq, bk - s.shape[-1]),
                                         -math.inf)], dim=-1)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s * scale - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = v[..., k0:k0 + bk, :]
        acc = acc * alpha + p[..., :vt.shape[-2]].to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / l).to(torch.bfloat16)


# (id, B, H, Sq, Skv, d): every padded head dim's form, ragged Skv, Sq != Skv
TILED_CASES = [("d8", 1, 2, 70, 45, 8), ("d64_ragged", 1, 2, 130, 190, 64),
               ("d128_cross", 1, 1, 200, 100, 128),
               ("d136", 1, 1, 77, 150, 136), ("d512", 1, 1, 100, 200, 512)]


@pytest.mark.parametrize("against", ["plain", "jax"])
@pytest.mark.parametrize("case", TILED_CASES, ids=[c[0] for c in TILED_CASES])
def test_tiled_reference_matches_plain_and_jax(case, against):
    """q and k of std 2 (peaked rows). Tolerance 1e-2 of max|ref|: all
    round P to bf16, at different running maxima (the plain version at the
    row's max, the JAX kernel at its own tiles' maxima)."""
    _, b, h, sq, skv, d = case
    rng = np.random.default_rng(sum(map(ord, case[0])))
    q, k, v = (rng.standard_normal(shape).astype(np.float32) * s
               for shape, s in (((b, h, sq, d), 2.0), ((b, h, skv, d), 2.0),
                                ((b, h, skv, d), 1.0)))
    got = _tiled_flash(*(torch.from_numpy(t) for t in (q, k, v))).float()
    if against == "plain":
        ref = _port(q, k, v, torch.bfloat16)
    else:
        ref = _jax(q, k, v, jnp.bfloat16, 128, 64)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


def test_tiled_reference_padded_keys_extreme_scores():
    """Every real score -2048 on a ragged Skv of 100 (two tiles, the second
    ragged): uniform over the real keys. Tolerance 2e-3 absolute."""
    v = np.random.default_rng(7).normal(size=(1, 1, 100, 64)).astype(
        np.float32)
    got = _tiled_flash(torch.full((1, 1, 8, 64), 16.0),
                       torch.full((1, 1, 100, 64), -16.0),
                       torch.from_numpy(v)).float().numpy()
    want = v.astype(np.float32).mean(axis=2, keepdims=True).repeat(8, axis=2)
    np.testing.assert_allclose(got, want, atol=2e-3)


def _swizzle(off, cw):
    """The TMA / wgmma swizzle over 2 cw bytes: the 16-byte chunk index
    within a 2 cw-byte row XOR-ed with the row's place in its 8-row atom."""
    mask = {64: 7, 32: 3, 16: 1}[cw]
    return off ^ (((off >> 7) & mask) << 4)


def _tma_tile(x, dp):
    """A rows x D bf16 tile (as uint16) as K3's tensor maps write it for
    padded head dim dp: dp / cw boxes of rows x 2 cw bytes, one after the
    other, chunks swizzled, columns past D zero."""
    rows, d = x.shape
    cw = min(dp, 64)
    img = np.zeros(rows * dp, np.uint16)   # 2-byte words
    for r in range(rows):
        for c in range(dp):
            box, cc = divmod(c, cw)
            off = _swizzle(r * cw * 2 + cc * 2, cw)
            img[(box * rows * cw * 2 + off) // 2] = x[r, c] if c < d else 0
    return img


def _desc_read(img, start, lbo, sbo, cw, n_rows, trans):
    """What a wgmma operand descriptor (start, LBO, SBO, swizzle over 2 cw
    bytes) reads for one 16-deep k-step: K-major (trans False) returns
    [row n][k] for n < n_rows; transposed (trans True) returns [k][n] with
    N = n_rows columns."""
    out = np.zeros((n_rows, 16) if not trans else (16, n_rows), np.uint16)
    for n in range(n_rows):
        for kk in range(16):
            if trans:   # 8-row groups of K at SBO, cw-column blocks at LBO
                addr = (start + (n // cw) * lbo + (kk // 8) * sbo
                        + (kk % 8) * cw * 2 + (n % cw) * 2)
                out[kk, n] = img[_swizzle(addr, cw) // 2]
            else:       # 8-row groups of M/N at SBO, k within the row
                addr = start + (n // 8) * sbo + (n % 8) * cw * 2 + kk * 2
                out[n, kk] = img[_swizzle(addr, cw) // 2]
    return out


@pytest.mark.parametrize("dp", [16, 32, 64, 128, 256, 512])
def test_kv_tile_layout_matches_wgmma_descriptors(dp):
    """A 64-key K or V tile as TMA writes it, read back through the
    descriptors csrc/flash_attn.cu builds: K-major for K (kmajor_desc:
    k-step kk at box 16 kk / cw, 32 (kk mod cw / 16) bytes in, SBO 16 cw)
    and transposed for V (trans_desc: k-step kk 32 cw kk bytes on, LBO one
    box, SBO 16 cw). D is dp - 8, so the last columns are the zero fill."""
    cw, d = min(dp, 64), dp - 8
    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "neural_enhanced_super_resolution_torch",
        "csrc", "flash_attn.cu")).read()
    assert "nesr::wgmma_desc(addr, 16, 16 * CW)" in src
    assert ("nesr::wgmma_desc(tile + kk * 32 * CW, ROWS * CW * 2, 16 * CW)"
            in src)
    x = np.random.default_rng(dp).integers(1, 1 << 16, (BK, d),
                                           dtype=np.uint16)
    img = _tma_tile(x, dp)
    full = np.zeros((BK, dp), np.uint16)
    full[:, :d] = x
    for kk in range(dp // 16):   # S = Q K^T: K is B, K-major, N = 64 keys
        start = (16 * kk // cw) * BK * cw * 2 + (16 * kk % cw) * 2
        got = _desc_read(img, start, 16, 16 * cw, cw, BK, trans=False)
        np.testing.assert_array_equal(got, full[:, 16 * kk:16 * kk + 16])
    for kk in range(BK // 16):   # P V: V is B transposed, N = dp columns
        got = _desc_read(img, kk * 32 * cw, BK * cw * 2, 16 * cw, cw, dp,
                         trans=True)
        np.testing.assert_array_equal(got, full[16 * kk:16 * kk + 16, :])
