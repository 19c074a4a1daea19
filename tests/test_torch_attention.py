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

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_enhanced_super_resolution_tpu.kernels.attention import (
    attention_auto as jax_attention_auto, flash_attention as jax_flash)
from neural_enhanced_super_resolution_torch.kernels import (
    KernelInputError, attention_auto, flash_attention, flash_attention_plain)

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
