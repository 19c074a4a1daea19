"""The port's entry-point scripts on the CPU: the reference-parity harness
(``tools/torch_compare_reference.py``), the quickstart and the standalone
runners, each beside its JAX-side counterpart.

Goldens are recorded with ``tools/compare_reference.py``'s own machinery
and the stand-ins its tests use for the reference stack (the JAX forward
for basicsr, real ``transformers`` SegFormer inference, and the torch
twin's DDIM loop for diffusers), then checked by the port's tool; goldens
with a planted fault must fail it. The x2plus runner is held to its JAX
counterpart within 1 uint8 level.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))  # tests.torch_twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_SCRIPTS = ("tools/torch_train_tiny_esrgan.py",
               "tools/torch_compare_reference.py",
               "examples/torch_quickstart.py",
               "standalone/torch_direct_esrgan.py",
               "standalone/torch_superres_project.py",
               "standalone/torch_download_x3_model.py")


def _load(rel: str):
    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cr = _load("tools/compare_reference.py")
pt = _load("tools/torch_compare_reference.py")
transformers = pytest.importorskip("transformers")


def _jax_args(**kw):
    base = dict(record=None, check=None, stack="esrgan", weights=None,
                images=[], crop=512, tolerance=0.1, seg_agreement=0.999,
                lat_tolerance=0.05, steps=20,
                prompt="a high resolution, detailed photograph")
    base.update(kw)
    import argparse
    return argparse.Namespace(**base)


TINY_ARCH = dict(num_feat=8, num_block=2, num_grow_ch=4)
# the JAX x2plus runner loads 23 blocks (its converter's default)
X2PLUS_ARCH = dict(num_feat=8, num_block=23, num_grow_ch=4)


def _esrgan_goldens(tmp_path, test_image, monkeypatch) -> tuple[str, str]:
    """(goldens, checkpoint): the JAX tool records, its own forward
    standing in for basicsr (tests/test_cli_and_utils.py)."""
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNetConfig, init_rrdbnet, save_state_dict)
    from neural_enhanced_super_resolution_torch.utils.io import imwrite_rgb

    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, **TINY_ARCH)
    ckpt = save_state_dict(init_rrdbnet(cfg, torch.Generator().manual_seed(
        0)), str(tmp_path / "tiny12.pth"))
    monkeypatch.setattr(cr, "ARCH", TINY_ARCH)
    monkeypatch.setattr(cr, "run_reference",
                        lambda weights, inp: cr.run_ours(weights, inp))
    img = str(tmp_path / "in.png")
    imwrite_rgb(img, test_image)
    gold = str(tmp_path / "esrgan.npz")
    assert cr.record(_jax_args(record=gold, weights=ckpt, images=[img],
                               crop=64)) == 0
    monkeypatch.setattr(pt, "ARCH", TINY_ARCH)
    return gold, ckpt


@pytest.fixture(scope="module")
def segformer_snapshot(tmp_path_factory):
    """A tiny random HF SegFormer (tests/test_compare_reference.py's)."""
    cfg = transformers.SegformerConfig(
        num_channels=3, num_encoder_blocks=4, depths=[1, 1, 1, 1],
        sr_ratios=[4, 2, 2, 1], hidden_sizes=[8, 16, 16, 32],
        patch_sizes=[7, 3, 3, 3], strides=[4, 2, 2, 2],
        num_attention_heads=[1, 2, 2, 4], mlp_ratios=[2, 2, 2, 2],
        decoder_hidden_size=16, num_labels=10)
    torch.manual_seed(0)
    model = transformers.SegformerForSemanticSegmentation(cfg).eval()
    snap = tmp_path_factory.mktemp("segformer_snap")
    model.save_pretrained(str(snap), safe_serialization=True)
    return str(snap)


def _segformer_goldens(tmp_path, test_image, snapshot) -> str:
    from neural_enhanced_super_resolution_torch.utils.io import imwrite_rgb
    img = str(tmp_path / "in.png")
    imwrite_rgb(img, test_image[:96, :96])
    gold = str(tmp_path / "seg.npz")
    assert cr.record_segformer(_jax_args(record=gold, weights=snapshot,
                                         images=[img],
                                         stack="segformer")) == 0
    return gold


@pytest.fixture(scope="module")
def diffusion_snapshot(tmp_path_factory):
    """A tiny diffusers-layout snapshot (tests/test_compare_reference.py's
    shapes): seeded JAX-layout params saved as torch state dicts."""
    from neural_enhanced_super_resolution_tpu.models.diffusion import (
        CLIPTextConfig, UNetConfig, VAEConfig)
    from neural_enhanced_super_resolution_tpu.models.diffusion.specs import (
        clip_param_shapes, unet_param_shapes, vae_param_shapes)

    root = tmp_path_factory.mktemp("sd_snap")
    rng = np.random.default_rng(0)

    def save_sd(shapes, path):
        sd = {}
        for name, shape in shapes.items():
            a = (0.05 * rng.standard_normal(shape)).astype(np.float32)
            if name.endswith(".weight") and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif (name.endswith(".weight") and a.ndim == 2
                  and not any(m in name for m in ("token_embedding",
                                                  "position_embedding",
                                                  "class_embedding"))):
                a = a.T
            sd[name] = torch.from_numpy(np.ascontiguousarray(a))
        torch.save(sd, path)

    ucfg = dict(sample_size=8, in_channels=7, out_channels=4,
                down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
                up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"],
                block_out_channels=[8, 16], layers_per_block=1,
                cross_attention_dim=16, attention_head_dim=2,
                num_class_embeds=350, norm_num_groups=4)
    vcfg = dict(block_out_channels=[8, 16], layers_per_block=1,
                latent_channels=4, norm_num_groups=4, scaling_factor=0.08333,
                in_channels=3, out_channels=3)
    tcfg = dict(vocab_size=100, hidden_size=16, intermediate_size=32,
                num_hidden_layers=2, num_attention_heads=2,
                max_position_embeddings=12)
    for sub, cfg, shapes, fname in (
            ("unet", ucfg, unet_param_shapes(UNetConfig(**ucfg)),
             "diffusion_pytorch_model.bin"),
            ("vae", vcfg, vae_param_shapes(VAEConfig(**vcfg)),
             "diffusion_pytorch_model.bin"),
            ("text_encoder", tcfg, clip_param_shapes(CLIPTextConfig(**tcfg)),
             "pytorch_model.bin")):
        d = root / sub
        d.mkdir()
        (d / "config.json").write_text(json.dumps(cfg))
        save_sd(shapes, str(d / fname))
    for sname, cls in (("scheduler", "DDIMScheduler"),
                       ("low_res_scheduler", "DDPMScheduler")):
        d = root / sname
        d.mkdir()
        (d / "scheduler_config.json").write_text(json.dumps({
            "_class_name": cls, "num_train_timesteps": 1000,
            "beta_start": 0.0001, "beta_end": 0.02,
            "beta_schedule": "scaled_linear",
            "prediction_type": "epsilon"}))
    (root / "model_index.json").write_text(json.dumps(
        {"max_noise_level": 350}))
    return str(root)


def _diffusion_goldens(tmp_path, snapshot) -> str:
    """The explicit DDIM loop record_diffusion runs, driven by the torch
    twin (tests/test_compare_reference.py's golden)."""
    from tests.torch_twin import (TorchScheduler, torch_unet_forward,
                                  torch_vae_decode)
    from neural_enhanced_super_resolution_tpu.models.diffusion import (
        load_upscale_pipeline)

    pipe = load_upscale_pipeline(snapshot, compute_dtype="float32")
    prompt = "a photo of a cat"
    steps, nl, gs = 4, 20, 7.5
    rng = np.random.default_rng(7)
    img_u8 = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    image_noise = rng.standard_normal((8, 8, 3)).astype(np.float32)
    init_latents = rng.standard_normal((8, 8, 4)).astype(np.float32)
    embeds = np.asarray(pipe.encode_prompt(prompt))
    unet_sd, vae_sd = (torch.load(os.path.join(snapshot, sub,
                                               "diffusion_pytorch_model.bin"),
                                  map_location="cpu", weights_only=True)
                       for sub in ("unet", "vae"))
    twin, twin_low = TorchScheduler("ddim"), TorchScheduler("ddpm")
    noisy = twin_low.add_noise(img_u8[None].astype(np.float32) / 127.5 - 1.0,
                               image_noise[None], nl)
    img2 = np.concatenate([noisy, noisy], axis=0)
    ts = twin.timesteps(steps)
    lat = init_latents[None].copy()
    lats = []
    for i, t in enumerate(ts):
        prev_t = int(ts[i + 1]) if i + 1 < steps else -1
        unet_in = np.concatenate([np.concatenate([lat, lat]), img2], axis=-1)
        with torch.no_grad():
            out = torch_unet_forward(
                unet_sd, torch.from_numpy(unet_in.transpose(0, 3, 1, 2)),
                int(t), torch.from_numpy(embeds),
                torch.from_numpy(np.asarray([nl, nl])), pipe.unet_cfg)
        u, c = np.split(out.numpy().transpose(0, 2, 3, 1), 2, axis=0)
        lat = twin.step(u + gs * (c - u), int(t), prev_t, lat)
        lats.append(lat[0])
    with torch.no_grad():
        dec = torch_vae_decode(vae_sd, torch.from_numpy(
            (lat / pipe.vae_cfg.scaling_factor).transpose(0, 3, 1, 2)),
            pipe.vae_cfg)
    final = np.clip((dec[0].numpy().transpose(1, 2, 0) + 1) * 127.5, 0,
                    255).round().astype(np.uint8)
    gold = str(tmp_path / "diff.npz")
    np.savez_compressed(
        gold, stack="diffusion", prompt=np.array(prompt), image=img_u8,
        steps=steps, noise_level=nl, guidance=gs, image_noise=image_noise,
        init_latents=init_latents, timesteps=ts.astype(np.int64),
        latents=np.stack(lats), final=final)
    return gold


def _goldens(stack, tmp_path, test_image, monkeypatch, request):
    """(goldens, weights, extra check flags) of one stack."""
    if stack == "esrgan":
        return (*_esrgan_goldens(tmp_path, test_image, monkeypatch), [])
    if stack == "segformer":
        snap = request.getfixturevalue("segformer_snapshot")
        # f32 on both sides; random-weight logits can have tight top-2
        # gaps (the JAX tool's test takes 0.98 too)
        return (_segformer_goldens(tmp_path, test_image, snap), snap,
                ["--seg-agreement", "0.98"])
    snap = request.getfixturevalue("diffusion_snapshot")
    return _diffusion_goldens(tmp_path, snap), snap, ["--lat-tolerance",
                                                      "5e-3"]


def _perturb(gold: str, stack: str) -> str:
    """The same goldens with a planted fault in the reference outputs."""
    data = dict(np.load(gold, allow_pickle=False))
    if stack == "esrgan":
        data["ref_0"] = data["ref_0"] // 2
    elif stack == "segformer":
        data["logits_0"] = np.roll(data["logits_0"], 1, axis=-1)
    else:
        data["latents"] = data["latents"] + 0.1 * np.abs(
            data["latents"]).mean()
    bad = gold.replace(".npz", "_bad.npz")
    np.savez_compressed(bad, **data)
    return bad


@pytest.mark.parametrize("stack", ["esrgan", "segformer", "diffusion"])
def test_jax_goldens_pass_the_ports_check_and_faults_fail_it(
        stack, tmp_path, test_image, monkeypatch, request, capsys):
    gold, weights, flags = _goldens(stack, tmp_path, test_image, monkeypatch,
                                    request)
    argv = ["--stack", stack, "--weights", weights, "--device", "cpu"] + flags
    assert pt.main(["--check", gold] + argv) == 0
    assert "PASS" in capsys.readouterr().out
    assert pt.main(["--check", _perturb(gold, stack)] + argv) == 1
    assert "FAIL" in capsys.readouterr().out


def test_compare_reference_command_line_is_the_jax_tools():
    """Every flag of the JAX tool parses the same, and --device is added
    (default cuda)."""
    argv = ["--check", "g.npz", "--stack", "segformer", "--weights", "w",
            "--crop", "64", "--tolerance", "0.2", "--seg-agreement", "0.9",
            "--lat-tolerance", "0.01", "--steps", "3", "--prompt", "p"]
    ours, ref = pt.build_parser().parse_args(argv), \
        cr.build_parser().parse_args(argv)
    assert {**vars(ours), "device": None} == {**vars(ref), "device": None}
    assert ours.device == "cuda"


def test_quickstart_beats_bicubic_on_the_cpu(tmp_path, capsys):
    quickstart = _load("examples/torch_quickstart.py")
    assert quickstart.main(["--device", "cpu", "--output_dir",
                            str(tmp_path)]) == 0
    lines = {ln.split(":")[0].strip(): ln for ln in
             capsys.readouterr().out.splitlines()}
    db = {k: float(lines[k].split("PSNR")[1].split("dB")[0])
          for k in ("bicubic", "enhanced")}
    assert db["enhanced"] > db["bicubic"], db
    assert os.path.exists(tmp_path / "quickstart_comparison.png")


@pytest.mark.parametrize("script", [s for s in NEW_SCRIPTS
                                    if s.startswith("standalone/")])
def test_standalone_scripts_parse_help(script, capsys):
    with pytest.raises(SystemExit) as exc:
        _load(script).main(["--help"])
    assert exc.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_superres_project_matches_the_jax_runner(tmp_path, test_image):
    """The x2plus runner at tiny-width x2plus weights (23 blocks: the JAX
    runner's converter loads 23) on an odd-sized input, against
    standalone/superres_project.py on the same input, flags and weights:
    the same output file and shape, and a mean difference of at most 1
    uint8 level, the bar the bf16 trunks hold against the JAX default
    (tests/test_torch_pipeline.py). In bf16 over 69 RDBs the JAX runner is
    not within 1 level of itself (jitted against op by op: up to 26
    levels, mean 0.30 here), so no bar on the largest difference is set."""
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNetConfig, init_rrdbnet, save_state_dict)
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)

    cfg = RRDBNetConfig(num_in_ch=3, num_out_ch=3, scale=2, **X2PLUS_ARCH)
    ckpt = save_state_dict(init_rrdbnet(cfg, torch.Generator().manual_seed(
        5)), str(tmp_path / "x2plus.pth"))
    src = str(tmp_path / "img.png")
    imwrite_rgb(src, test_image[:45, :38])
    outs = []
    for rel in ("standalone/torch_superres_project.py",
                "standalone/superres_project.py"):
        out_dir = str(tmp_path / rel.split("/")[1].split(".")[0])
        assert _load(rel).main(["-i", src, "-o", out_dir, "-n", "1", "-d",
                                "cpu", "--model", ckpt]) == 0
        outs.append(imread_rgb(os.path.join(out_dir,
                                            "img_enhanced_x2.0.png")))
    assert outs[0].shape == outs[1].shape == (90, 76, 3)
    assert np.abs(outs[0].astype(int) - outs[1].astype(int)).mean() <= 1.0


def test_download_x3_model_over_file_urls(tmp_path, monkeypatch):
    dl = _load("standalone/torch_download_x3_model.py")
    payload = {}
    for key in dl.X3_MODELS:
        src = tmp_path / f"{key}.src"
        src.write_bytes(key.encode() * 100)
        payload[key] = src.read_bytes()
        monkeypatch.setitem(dl.X3_MODELS, key, dict(
            dl.X3_MODELS[key], url=src.resolve().as_uri()))
    models = tmp_path / "models"
    monkeypatch.setenv("NESR_MODELS_DIR", str(models))
    x2 = models / "weights" / "RealESRGAN_x2plus.pth"
    x2.parent.mkdir(parents=True)
    x2.write_bytes(b"old")
    assert dl.main(["--install-as-x2plus"]) == 0
    for key, info in dl.X3_MODELS.items():
        assert (models / info["path"]).read_bytes() == payload[key]
    assert x2.read_bytes() == payload["realesr-general-x4v3"]
    assert (models / "weights" / "RealESRGAN_x2plus.pth.backup"
            ).read_bytes() == b"old"


_FORBIDDEN = ("jax", "optax", "flax", "neural_enhanced_super_resolution_tpu",
              "nesr", "tools.compare_reference", "tools.train_tiny_esrgan",
              "standalone.direct_esrgan", "standalone.superres_project",
              "standalone.download_x3_model")


def test_new_scripts_import_no_jax():
    """No new script names JAX, optax or the JAX package in an import (at
    any depth), and importing them all in a fresh interpreter loads no
    jax."""
    for rel in NEW_SCRIPTS:
        tree = ast.parse(open(os.path.join(ROOT, rel)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert not any(name == f or name.startswith(f + ".")
                               for f in _FORBIDDEN), (rel, name)
    code = ("import importlib.util, sys\n"
            f"for rel in {list(NEW_SCRIPTS)!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        rel.replace('/', '_')[:-3], rel)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "print(sorted(m for m in ('jax', 'optax', "
            "'neural_enhanced_super_resolution_tpu') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip().splitlines()[-1] == "[]", out
