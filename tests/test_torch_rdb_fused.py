"""K2's weight walk on the CPU: the slab sequence ``csrc/rdb_fused.cu``
reads, mirrored in Python and held to the packed buffers.

The kernel reads w0..w4 packed by K1's ``pack_conv3x3_weights`` as one
sequence of 63 slabs across its five stages (``stage_cin`` .. ``stage_g0``
in the source). The mirror below walks that sequence, stage by stage:
slab g = (stage, N tile, pass, tap) -> byte offset and byte count in the
stage's packed buffer. Reading every slab back through the ``wgmma``
B-descriptor addressing (K-major, no swizzle, leading byte offset 128,
stride byte offset 256) must give the HWIO weights of ``fuse_rdb`` exactly,
each packed value read once. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    pack_conv3x3_weights, pass_width, tile_width)
from neural_enhanced_super_resolution_torch.models.rrdbnet import (
    FusedRDB, fuse_rdb)

NF, GC = 64, 32          # the kernel's compiled widths
RING_SLOT_BYTES = 12288  # the kernel's ring slot: the largest slab


def slab_walk():
    """The kernel's slab sequence: (stage, g, tile, pass, tap, byte offset
    in the stage's packed buffer, bytes, N, kc), in the order thread 0
    issues it."""
    walk, g = [], 0
    for s in range(5):
        cin, cout = (NF if s == 0 else GC), 4 * GC + NF - s * GC
        nt = 2 if cout > 128 else 1
        n, kc = cout // nt, cin          # one pass: Cin is 64 or 32
        for tile in range(nt):
            for tap in range(9):
                walk.append((s, g, tile, 0, tap,
                             (tile * 9 + tap) * kc * n * 2, kc * n * 2, n, kc))
                g += 1
    return walk


def _fused_weights(seed=0):
    """w0..w4 HWIO from ``fuse_rdb`` on seeded stock conv1..conv5."""
    r = np.random.default_rng(seed)
    ws, bs = [], []
    for k in range(5):
        cin, cout = NF + k * GC, GC if k < 4 else NF
        ws.append(torch.from_numpy(r.standard_normal((3, 3, cin, cout))
                                   .astype(np.float32) * 0.05))
        bs.append(torch.from_numpy(r.standard_normal(cout).astype(
            np.float32) * 0.1))
    fw, fb = fuse_rdb(ws, bs)
    return [w.bfloat16() for w in fw], fb


def _read_slab(flat, offset, n, kc, lbo=128, sbo=256):
    """A slab of kc x n read as wgmma's B descriptors do, one per k-step
    of 16 channels at offset + kk * 32 * n bytes: element (k, j) at byte
    (j // 8) * SBO + (j % 8) * 16 + (k // 8) * LBO + (k % 8) * 2. Returns
    the (kc, n) values and the element indices read."""
    k = torch.arange(16).view(16, 1)
    j = torch.arange(n).view(1, n)
    inner = (j // 8) * sbo + (j % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    idx = torch.cat([(offset + kk * 32 * n + inner) // 2
                     for kk in range(kc // 16)])
    return flat[idx], idx


def test_slab_walk_is_k1s_packing():
    """63 slabs, 479,232 bytes an RDB; every slab fits one ring slot; each
    stage's tiles and passes are K1's (tile_width, pass_width)."""
    walk = slab_walk()
    assert [w[1] for w in walk] == list(range(63))
    assert sum(w[6] for w in walk) == 479232
    assert max(w[6] for w in walk) == RING_SLOT_BYTES
    for s in range(5):
        cin, cout = (NF if s == 0 else GC), 4 * GC + NF - s * GC
        n, tiles = tile_width(cout)
        assert {(w[7], w[8]) for w in walk if w[0] == s} == {
            (n, pass_width(cin))}
        assert max(w[2] for w in walk if w[0] == s) == tiles - 1


@pytest.mark.parametrize("stage", range(5))
def test_slab_walk_covers_the_packed_buffer(stage):
    """Stage s's slabs tile its packed buffer end to end, in the order the
    kernel issues them."""
    fw, _ = _fused_weights()
    packed = pack_conv3x3_weights(fw[stage])
    steps = [w for w in slab_walk() if w[0] == stage]
    offset = 0
    for _, _, _, _, _, off, nbytes, _, _ in steps:
        assert off == offset and nbytes % 16 == 0
        offset += nbytes
    assert offset == packed.numel() * 2


@pytest.mark.parametrize("stage", range(5))
def test_slab_walk_reads_back_the_hwio_weights(stage):
    """Each slab of stage s read through the B descriptors is tap t, input
    channels of its pass, output channels of its N tile of fuse_rdb's
    w_s; every packed value is read exactly once."""
    fw, _ = _fused_weights(seed=stage)
    w = fw[stage]
    flat = pack_conv3x3_weights(w).view(torch.int16)
    hits = torch.zeros(flat.numel(), dtype=torch.int64)
    for _, _, tile, c, tap, off, _, n, kc in (
            x for x in slab_walk() if x[0] == stage):
        got, idx = _read_slab(flat, off, n, kc)
        want = w[tap // 3, tap % 3, c * kc:(c + 1) * kc,
                 tile * n:(tile + 1) * n]
        assert torch.equal(got.view(torch.bfloat16), want)
        hits.index_add_(0, idx.reshape(-1),
                        torch.ones(idx.numel(), dtype=torch.int64))
    assert torch.equal(hits, torch.ones_like(hits))


def test_fused_rdb_packs_the_buffers_the_walk_reads():
    """FusedRDB(kernel=True) packs w0..w4 at build into buffers of the
    walk's sizes, equal to packing each weight on the fly."""
    fw, fb = _fused_weights(seed=5)
    mod = FusedRDB(fw, fb, torch.bfloat16, "cpu", kernel=True)
    walk = slab_walk()
    for s, p in enumerate(mod.packed()):
        assert p.dtype == torch.bfloat16 and p.is_contiguous()
        assert p.numel() * 2 == sum(w[6] for w in walk if w[0] == s)
        assert torch.equal(p, pack_conv3x3_weights(fw[s]))
