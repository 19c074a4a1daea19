"""Configuration kind ``nesr_pipeline``: the port's SuperResolutionPipeline
with its networks made on the device from the seed.

``build`` makes every weight with one ``torch.Generator`` on the device,
in a few large draws (one normal draw and one uniform draw a network, cut
into the layers' shapes and scaled per layer), rounded to bf16, the type
the networks are served in; it hands them to the port's own modules, puts
those into a ``SuperResolutionPipeline`` built with the configuration's
pipeline keys, and keeps the raw weights for the reference. Inits: the
RRDBNet's of ``models/weights.init_rrdbnet`` (basicsr: Kaiming-normal x
0.1 in the trunk, PyTorch's default in the head), SegFormer's of its
synthetic snapshot (uniform +-1/sqrt(fan_in)), the SD x4 components'
fan-in normal (norms 1, biases 0).
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["build", "System"]


class System:
    """The pipeline under test and what the reference needs besides it."""

    def __init__(self, pipeline, weights: dict, config: dict, device):
        self.pipeline = pipeline
        self.weights = weights        # {"esrgan": sd, "segformer": sd, ...}
        self.config = config
        self.device = device
        self.records = None           # request -> its denoise steps
        self.pcfg = {}

    def free(self) -> None:
        """Drop the program's state; the weights stay for the reference."""
        self.pipeline = None


def _draw(gen, device, shapes: dict, kinds: dict, scales: dict) -> dict:
    """One normal and one uniform draw for all leaves, cut and scaled:
    kinds[k] in {"normal", "uniform", "zeros", "ones"}; a uniform leaf is
    U(-1, 1) x scale, a normal one N(0, 1) x scale."""
    out = {}
    for kind, fn in (("normal", torch.randn), ("uniform", torch.rand)):
        keys = [k for k in shapes if kinds[k] == kind]
        sizes = [int(torch.Size(shapes[k]).numel()) for k in keys]
        if not keys:
            continue
        flat = fn(sum(sizes), generator=gen, device=device)
        if kind == "uniform":
            flat = flat.mul_(2).sub_(1)
        for k, part in zip(keys, torch.split(flat, sizes)):
            out[k] = (part.view(shapes[k]) * scales[k]).to(torch.bfloat16)
        del flat
    for k in shapes:
        if kinds[k] in ("zeros", "ones"):
            out[k] = (torch.zeros if kinds[k] == "zeros" else torch.ones)(
                shapes[k], dtype=torch.bfloat16, device=device)
    return out


def rrdbnet_weights(cfg: dict, gen, device) -> dict:
    nf, g = cfg["num_feat"], cfg["num_grow_ch"]
    cin = cfg["num_in_ch"] * {1: 16, 2: 4, 4: 1}[cfg["scale"]]
    shapes, kinds, scales = {}, {}, {}

    def conv(key, ci, co, body):
        fan_in = ci * 9
        shapes[f"{key}.weight"], shapes[f"{key}.bias"] = (co, ci, 3, 3), (co,)
        if body:
            kinds[f"{key}.weight"] = "normal"
            scales[f"{key}.weight"] = 0.1 * (2.0 / fan_in) ** 0.5
            kinds[f"{key}.bias"], scales[f"{key}.bias"] = "uniform", 0.01
        else:
            for p in ("weight", "bias"):
                kinds[f"{key}.{p}"] = "uniform"
                scales[f"{key}.{p}"] = fan_in ** -0.5

    conv("conv_first", cin, nf, False)
    for i in range(cfg["num_block"]):
        for r in ("rdb1", "rdb2", "rdb3"):
            for c in range(1, 6):
                conv(f"body.{i}.{r}.conv{c}", nf + (c - 1) * g,
                     g if c < 5 else nf, True)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        conv(name, nf, nf, False)
    conv("conv_last", nf, cfg["num_out_ch"], False)
    return _draw(gen, device, shapes, kinds, scales)


def segformer_weights(shapes: dict, gen, device) -> dict:
    kinds, scales = {}, {}
    for name, shape in shapes.items():
        if name.endswith("running_var") or (
                "norm" in name and name.endswith(".weight")):
            kinds[name] = "ones"
        elif "norm" in name or name.endswith("running_mean"):
            kinds[name] = "zeros"
        elif name.endswith(".weight"):
            fan_in = int(torch.Size(shape[1:]).numel())
            kinds[name], scales[name] = "uniform", fan_in ** -0.5
        else:
            kinds[name], scales[name] = "uniform", 0.02
    return _draw(gen, device, shapes, kinds, scales)


def fan_in_weights(shapes: dict, gen, device) -> dict:
    """Norm weights 1, biases 0, every other tensor N(0, 1/fan_in)."""
    kinds, scales = {}, {}
    for name, shape in shapes.items():
        parent = name.split(".")[-2] if "." in name else ""
        if name.endswith(".bias"):
            kinds[name] = "zeros"
        elif "norm" in parent:
            kinds[name] = "ones"
        else:
            fan_in = (int(torch.Size(shape[1:]).numel()) if len(shape) > 1
                      else int(shape[0]))
            kinds[name], scales[name] = "normal", fan_in ** -0.5
    return _draw(gen, device, shapes, kinds, scales)


def _shapes(module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def build(config: dict, seed: int, device: str,
          out_dir: str | None = None) -> System:
    """The pipeline of ``config`` with weights from ``seed``."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        RRDBNet, RRDBNetConfig)
    from neural_enhanced_super_resolution_torch.models.segformer import (
        SegFormer, SegFormerConfig, SegFormerModel)
    from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
        materialize)

    pcfg = dict(config["pipeline"])
    pcfg["output_dir"] = out_dir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "portbench_out")
    pipe = SuperResolutionPipeline(device, pcfg)
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[pipe.config["precision"]]
    gen = torch.Generator(device).manual_seed(int(seed))
    weights = {}

    ecfg = config["esrgan"]
    weights["esrgan"] = rrdbnet_weights(ecfg, gen, device)
    trunk = pcfg.get("esrgan_trunk") or "fused"
    trunk = "fused" if trunk in ("xla", "s2d") else trunk
    rcfg = RRDBNetConfig(**{k: ecfg[k] for k in (
        "num_in_ch", "num_out_ch", "scale", "num_feat", "num_block",
        "num_grow_ch")})
    pipe.models["esrgan"] = {"model": RRDBNet(rcfg, weights["esrgan"], dtype,
                                              device, trunk).eval(),
                             "cfg": rcfg}

    if pcfg.get("segment_enhancement", True):
        scfg = SegFormerConfig(**config["segformer"])
        with torch.device("meta"):
            net = SegFormer(scfg)
        weights["segformer"] = segformer_weights(_shapes(net), gen, device)
        pipe.models["segmentation"] = SegFormerModel(materialize(
            net, dict(weights["segformer"]), dtype, device))

    if pcfg.get("use_diffusion"):
        weights.update(_build_diffusion(pipe, config, gen, device, dtype))
    system = System(pipe, weights, config, device)
    # the keys as the port resolved them (defaults, device overlay)
    system.pcfg = {k: v for k, v in pipe.config.items() if not callable(v)}
    return system


def _build_diffusion(pipe, config, gen, device, dtype) -> dict:
    from neural_enhanced_super_resolution_torch.models.diffusion.clip_text \
        import CLIPTextConfig, CLIPTextModel
    from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
        materialize)
    from neural_enhanced_super_resolution_torch.models.diffusion.pipeline \
        import UpscalePipeline
    from neural_enhanced_super_resolution_torch.models.diffusion.scheduler \
        import DDIMScheduler, DDPMScheduler
    from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
        UNet2DConditionModel, UNetConfig)
    from neural_enhanced_super_resolution_torch.models.diffusion.vae import (
        AutoencoderKL, VAEConfig)

    sd_cfg = config["diffusion"]
    weights, mods = {}, {}
    for key, cfg_cls, cls in (("unet", UNetConfig, UNet2DConditionModel),
                              ("vae", VAEConfig, AutoencoderKL),
                              ("text_encoder", CLIPTextConfig,
                               CLIPTextModel)):
        with torch.device("meta"):
            mod = cls(cfg_cls(**sd_cfg[key]))
        weights[key] = fan_in_weights(_shapes(mod), gen, device)
        mods[key] = materialize(mod, dict(weights[key]), dtype, device)

    class RecordingDDIM(DDIMScheduler):
        """The configuration's DDIM scheduler; while ``record`` is a list
        it keeps each step's (t, prev_t, sample, guided eps, result)."""
        record = None

        def step(self, model_output, t, prev_t, sample):
            out = super().step(model_output, t, prev_t, sample)
            if self.record is not None:
                self.record.append((int(t), int(prev_t), sample,
                                    model_output, out))
            return out

    sch = sd_cfg["scheduler"]
    pipe.models["diffusion"] = UpscalePipeline(
        mods["unet"], mods["vae"], mods["text_encoder"], RecordingDDIM(**sch),
        DDPMScheduler(**sd_cfg["low_res_scheduler"]), None,
        max_noise_level=sd_cfg.get("max_noise_level", 350),
        cfg_split=sd_cfg.get("cfg_split", True))
    return weights


# ------------------------------------------------------------------ check --

def window_hook(system: System, keep: set):
    """For the checked requests only: keep the image the upscaling
    branches receive (the pre-stages' and segmentation's answer) and, with
    the diffusion branch, each denoise step."""
    pipe = system.pipeline
    diff = pipe.models.get("diffusion")
    name = "_apply_esrgan" if diff is not None else "_streamed_esrgan_final"
    stage = getattr(pipe, name)
    system.stage_inputs, system.records = {}, {}
    now = {"i": None}

    def kept_input(image, *args, **kwargs):
        if now["i"] in keep:
            system.stage_inputs[now["i"]] = image
        return stage(image, *args, **kwargs)

    setattr(pipe, name, kept_input)

    def on_start(i):
        now["i"] = i
        if diff is not None:
            diff.scheduler.record = system.records[i] = [] if i in keep \
                else None

    return on_start


def take_record(system: System):
    diff = system.pipeline.models.get("diffusion")
    if diff is not None:
        diff.scheduler.record = None
    return {"steps": system.records, "inputs": system.stage_inputs}


def check(system: System, inputs: dict, kept: dict, held, mix, seed: int,
          control: str | None) -> dict:
    """The compared numbers, each the worst over the checked requests.

    Each stage is held to the reference from the program's own input to
    it, so that one stage's rounding flips do not reach the next stage's
    number:

    * ``pre_mad``: the image the upscaling branches received (NL-means,
      CLAHE, SegFormer's mask and the masked sharpening) against the
      reference's from the request's input, mean |diff| in uint8 levels.
    * ``out_mse``, ``block_mse``: the answer against the reference's from
      that same received image, mean squared diff in levels^2 over the
      image and over its worst 64 x 64 block (``out_mad`` and
      ``block_mad``, the mean |diff|, are printed beside them).
    * With the diffusion branch, the denoise loop is followed step by step
      from the program's own latents: at three steps drawn from the seed,
      the first and the last among them, ``step_rel`` is |latents after the
      step - the reference's step from the same latents| / |the
      reference's| (L2): both UNet passes, the guidance and the DDIM
      update; ``init_gap`` is the first step's latents against the noise
      the reference draws itself (exact). The answer's reference decodes
      the program's final latents.

    The control, "lower": each stage's answer is the reference's from the
    same input one precision below the configuration's (every network's
    operands in float8, NL-means in bfloat16), in the program's place.
    """
    import torch
    from portbench.reference import nets, ops, request as R

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lower = control == "lower"
    cfg, dev, pcfg, w = system.config, system.device, system.pcfg, \
        system.weights
    esd = R.f32(w["esrgan"])
    ssd = R.f32(w["segformer"]) if "segformer" in w else None
    out = {}

    def worst(name, v):
        out[name] = max(out.get(name, float("-inf")), float(v))

    def low(fn, *args):
        """fn one precision below (the control, in the program's place)."""
        nets.set_precision("fp8")
        ops.NLM["dtype"] = torch.bfloat16
        try:
            return fn(*args)
        finally:
            nets.set_precision("float32")
            ops.NLM["dtype"] = torch.float32

    def pre_seg(img):
        x = R.pre(img, pcfg)
        return R.segment_sharpen(x, ssd, cfg["segformer"]) \
            if ssd is not None else x

    sharpen = pcfg.get("adaptive_sharpening", True)
    rng = np.random.default_rng([int(seed), 4])
    for i, ans in sorted(kept.items()):
        with torch.no_grad():
            img = torch.as_tensor(inputs[i], device=dev)
            x_prog = held["inputs"][i]
            ref_x = pre_seg(img)
            if lower:
                x_prog = low(pre_seg, img)
            worst("pre_mad", (x_prog.float() - ref_x.float()).abs().mean())
            del ref_x
            if not pcfg.get("use_diffusion"):
                ref = R.esrgan_streamed(x_prog, esd, cfg["esrgan"], pcfg,
                                        sharpen)
                if lower:
                    ans = low(R.esrgan_streamed, x_prog, esd, cfg["esrgan"],
                              pcfg, sharpen).cpu().numpy()
            else:
                steps = held["steps"][i]
                esr = R.esrgan_whole(x_prog, esd, cfg["esrgan"], pcfg)
                diff_img = _check_diffusion(system, x_prog, steps, mix, rng,
                                            lower, low, worst)
                ref = R.ensemble([esr, diff_img])
                if sharpen:
                    ref = ops.adaptive_sharpen(ref)
                if lower:
                    esr_c = low(R.esrgan_whole, x_prog, esd, cfg["esrgan"],
                                pcfg)
                    dcfg = cfg["diffusion"]
                    d_c = low(R.vae_to_image, steps[-1][4], R.f32(w["vae"]),
                              dcfg["vae"])
                    ans = R.ensemble([esr_c, d_c])
                    if sharpen:
                        ans = ops.adaptive_sharpen(ans)
                    ans = ans.cpu().numpy()
            gaps = R.image_gaps(np.asarray(ans), ref.cpu().numpy())
        for k, v in gaps.items():
            worst(k, v)
        del img, x_prog, ref
    return out


def _check_diffusion(system, x, steps, mix, rng, lower, low, worst):
    import torch
    from portbench.reference import nets, request as R

    cfg, dev, w = system.config, system.device, system.weights
    dcfg = cfg["diffusion"]
    ucfg, vcfg, tcfg = dcfg["unet"], dcfg["vae"], dcfg["text_encoder"]
    usd, vsd, tsd = R.f32(w["unet"]), R.f32(w["vae"]), R.f32(w["text_encoder"])
    guidance, level = float(dcfg["guidance_scale"]), int(dcfg["noise_level"])
    prompt = mix.prompt or dcfg["default_prompt"]
    length = tcfg["max_position_embeddings"]
    ids = torch.tensor([nets.tokenize("", length),
                        nets.tokenize(prompt, length)], device=dev)
    h, wd = int(x.shape[0]), int(x.shape[1])
    gen = torch.Generator(dev).manual_seed(0)   # the branch's own draws
    image_noise = torch.randn((1, h, wd, 3), generator=gen, device=dev)
    init = torch.randn((1, h, wd, ucfg["out_channels"]), generator=gen,
                       device=dev)
    low_sched = nets.Scheduler(**dcfg["low_res_scheduler"])
    main = nets.Scheduler(**dcfg["scheduler"])
    noisy = low_sched.add_noise((x.float() / 127.5 - 1.0)[None], image_noise,
                                level)
    labels = torch.full((1,), level, dtype=torch.long, device=dev)
    worst("init_gap", (steps[0][2] - init).abs().max().item())

    def step(sample, t, prev_t):
        embeds = nets.clip_text(tsd, tcfg, ids)
        unet_in = torch.cat([sample, noisy], dim=-1).permute(0, 3, 1, 2)
        eu = nets.unet(usd, ucfg, unet_in, t, embeds[:1], labels)
        ec = nets.unet(usd, ucfg, unet_in, t, embeds[1:], labels)
        eps = (eu + guidance * (ec - eu)).permute(0, 2, 3, 1)
        return eps, main.ddim_step(eps, t, prev_t, sample.float())

    n = len(steps)
    for k in sorted({0, n - 1, int(rng.integers(1, n - 1))}):
        t, prev_t, sample, eps_prog, res = steps[k]
        eps_ref, res_ref = step(sample, t, prev_t)
        if lower:
            eps_prog, res = low(step, sample, t, prev_t)
        worst("eps_rel", ((eps_prog - eps_ref).norm() / eps_ref.norm()).item())
        worst("step_rel", ((res - res_ref).norm() / res_ref.norm()).item())
        del eps_ref, res_ref
    return R.vae_to_image(steps[-1][4], vsd, vcfg)
