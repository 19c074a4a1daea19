"""The port's multi-device layer across two real CUDA cards.

Every test here needs at least two CUDA GPUs and skips otherwise (the
CPU tests of the layer, in tests/test_torch_parallel.py, run over a list
of CPU slots, where a move between devices is a move to the same one).
The file imports no JAX and uses no conftest fixture, so on a machine
with several cards and without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_multicard.py
"""

import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.kernels import flash_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs: the move is between cards")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_to_device_keeps_the_seeded_draws_across_cards(two_cards, tmp_path):
    """UpscalePipeline.to_device from cuda:0 to cuda:1 (the stage-overlap
    placement): the seeded Philox draws are the same numbers on either
    card, so the moved pipeline's output equals the unmoved one's bit for
    bit, its K3 launches on the new card."""
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        CLIPTextConfig, UNetConfig, VAEConfig, load_upscale_pipeline)
    from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
        write_synthetic_snapshot)
    first, second = two_cards
    snap = write_synthetic_snapshot(str(tmp_path / "sd"), (
        UNetConfig(block_out_channels=(8, 16), layers_per_block=1,
                   down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                   up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                   cross_attention_dim=16, attention_head_dim=2,
                   num_class_embeds=50, norm_num_groups=4),
        VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                  norm_num_groups=4),
        CLIPTextConfig(vocab_size=100, hidden_size=16, intermediate_size=32,
                       num_hidden_layers=2, num_attention_heads=2,
                       max_position_embeddings=12)),
        torch.Generator().manual_seed(0), init="fixed")
    draws = [torch.randn((4, 64), device=d, generator=torch.Generator(
        d).manual_seed(7)).cpu() for d in two_cards]
    assert torch.equal(draws[0], draws[1])
    pipe = load_upscale_pipeline(snap, device=first)
    img = np.random.default_rng(4).integers(0, 256, (24, 40, 3), np.uint8)
    before = pipe("a photo", img, num_inference_steps=3, seed=5).cpu()
    assert pipe.to_device(second) is pipe
    launches = flash_attention.launches
    after = pipe("a photo", img, num_inference_steps=3, seed=5)
    assert after.device == second
    # 4 self-attentions a UNet pass, 2 passes a step, and the VAE's
    assert flash_attention.launches - launches == 4 * 2 * 3 + 1
    assert torch.equal(after.cpu(), before)
