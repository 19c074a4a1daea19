"""SuperResolutionPipeline on PyTorch: the JAX package's default request.

Counterpart of ``neural_enhanced_super_resolution_tpu/pipeline.py`` with the
same constructor, config keys, ``enhance_image`` / ``enhance_array``
contract, stage names, progress and image callbacks, cooperative
cancellation and output naming (``{name}_enhanced_x{scale}{ext}``). Per
iteration: NL-means denoise and CLAHE contrast -> SegFormer segmentation
and masked sharpening -> tiled ESRGAN (RRDBNet on K1, its trunk on K1,
K2 or, with ``esrgan_trunk: "int8"``, K4; ``parity_tiling`` runs the
reference's per-tile loop), SwinIR (its
convs on K1; ``use_swinir``) and the Stable Diffusion x4 upscaler (its
self-attention on K3) -> ensemble
-> adaptive sharpen. An input above ``diffusion_max_megapixels`` skips
diffusion; a last iteration with ESRGAN as the only branch runs ESRGAN +
sharpen per tile and streams the tiles to the host, each chunk's copy
overlapping the next chunk's compute. ``precision: "float32"`` (the JAX
package's parity mode) runs K1's and K3's float32 forms on the card with
TF32 off, and the fused trunk for ``esrgan_trunk: "dform"``.

Several devices (``runtime/device.visible_devices``): with
``data_parallel`` ``"auto"`` (or an int cap) the tile batch is sharded
over them (``shard_strategy: "strips"`` strip-shards the image with halo
exchange), each device running its own replica of the model; with the
diffusion branch on and ``stage_overlap``, the last quarter of the
devices is kept for the denoise loop, which runs while ESRGAN's tiles
are still in flight; ``sd_cfg_shard`` splits the CFG pair over the last
two devices. One process drives them all; ``runtime/distributed``
joins hosts.

The graceful-degradation ladder (primary -> 3-channel -> tiled-3ch(256) ->
bicubic, a stage skipped, a branch whose weights do not load turned off,
the parity tiler's bicubic probe and tile rungs) is kept for ordinary
failures, but a kernel failure or a wrapper's refusal
of its input (``KernelError``, ``KernelInputError``) or a CUDA runtime
error is re-raised, like cancellation: a broken device or kernel never
comes out as a bicubic or unprocessed image. Nothing moves to the CPU when
the GPU is missing.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels._build import (
    is_device_fault)
from neural_enhanced_super_resolution_torch.kernels.rdb_fused import (
    KERNEL_GC, KERNEL_NF)
from neural_enhanced_super_resolution_torch.models.diffusion.pipeline import (
    load_upscale_pipeline)
from neural_enhanced_super_resolution_torch.models.rrdbnet import (
    RRDBNet, RRDBNetConfig)
from neural_enhanced_super_resolution_torch.models.segformer import (
    load_segformer)
from neural_enhanced_super_resolution_torch.models.swinir import load_swinir
from neural_enhanced_super_resolution_torch.models.weights import (
    load_state_dict)
from neural_enhanced_super_resolution_torch.ops.blur import gaussian_blur
from neural_enhanced_super_resolution_torch.ops.enhance import (
    adaptive_sharpen, adaptive_sharpen_batch, contrast_stage, denoise_stage,
    ensemble, masked_sharpen)
from neural_enhanced_super_resolution_torch.ops.resize import resize
from neural_enhanced_super_resolution_torch.parallel import sharded
from neural_enhanced_super_resolution_torch.parallel.mesh import module_on
from neural_enhanced_super_resolution_torch.parallel.overlap import (
    split_mesh)
from neural_enhanced_super_resolution_torch.parallel.tiling import (
    TilingCancelled, process_tiled, process_tiled_to_host,
    process_with_tiling_parity)
from neural_enhanced_super_resolution_torch.runtime import device as devices
from neural_enhanced_super_resolution_torch.runtime.config import merge_config
from neural_enhanced_super_resolution_torch.runtime.device import (
    default_compute_dtype, determine_device, device_fetch, torch_dtype)
from neural_enhanced_super_resolution_torch.runtime.distributed import (
    init_multihost)
from neural_enhanced_super_resolution_torch.runtime.profiler import StageTimer

logger = logging.getLogger("nesr")

__all__ = ["SuperResolutionPipeline", "EnhancementCancelled", "esrgan_step"]


class EnhancementCancelled(Exception):
    """Raised when config["cancel_check"] fires; never swallowed."""


def _reraise(exc: BaseException, what: str) -> None:
    if isinstance(exc, (EnhancementCancelled, TilingCancelled)):
        raise EnhancementCancelled(f"cancelled during {what}") from exc
    if is_device_fault(exc):
        raise exc


@torch.no_grad()
def esrgan_step(model: RRDBNet, tiles_u8: torch.Tensor,
                mode: str = "stack12") -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB tiles -> (N, sH, sW, 3) uint8 RGB.

    The 12-channel input is the BGR variant stack [bgr, bgr*1.1, bgr*0.9,
    GaussianBlur3(bgr)] ("stack12", the blur on uint8 with cv2 rounding) or
    [bgr]*4 ("repeat12"); "direct" feeds BGR to a 3-input model. Scale-2
    models get odd sizes edge-padded; the output is clip(y*255) truncated
    to uint8 and flipped back to RGB.
    """
    bgr_u8 = tiles_u8.flip(-1)
    bgr = bgr_u8.float() / 255.0
    if mode == "repeat12":
        x = torch.cat([bgr, bgr, bgr, bgr], dim=-1)
    elif mode == "stack12":
        blurred = gaussian_blur(bgr_u8, (3, 3), 0.0).float() / 255.0
        x = torch.cat([bgr, torch.clamp(bgr * 1.1, 0.0, 1.0),
                       torch.clamp(bgr * 0.9, 0.0, 1.0), blurred], dim=-1)
    elif mode == "direct":
        x = bgr
    else:
        raise ValueError(f"unknown esrgan input mode {mode!r}")
    scale = model.cfg.scale
    h, w = x.shape[1], x.shape[2]
    ph, pw = (h % 2, w % 2) if scale == 2 else (0, 0)
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                  mode="replicate").permute(0, 2, 3, 1)
    out = model(x.contiguous())
    if ph or pw:
        out = out[:, :h * scale, :w * scale]
    out = torch.clamp(out * 255.0, 0.0, 255.0).to(torch.uint8)  # truncates
    return out.flip(-1)


class SuperResolutionPipeline:
    """Iterative super-resolution with ESRGAN, SwinIR and the SD x4
    upscaler, NL-means denoise and segmentation-guided sharpening
    (reference-compatible API)."""

    def __init__(self, device: str = "auto", config: dict | None = None):
        # Multi-host init: a no-op without a coordinator in the environment
        # (runtime/distributed.py).
        init_multihost()
        self.device = determine_device(device)
        logger.info("Using device: %s", self.device)
        self.config = merge_config(self.device, config)
        if self.config["precision"] is None:
            self.config["precision"] = default_compute_dtype(self.device)
        if self.device == "cuda" and self.config["precision"] == "float32":
            # The parity mode: K1 and K3 run their float32 forms, and the
            # convolutions and products left to PyTorch run without TF32.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            logger.info("precision float32 on cuda: the kernels' float32 "
                        "forms run (TF32 off)")
        os.makedirs(self.config["output_dir"], exist_ok=True)
        self.models: dict = {}
        self.timer = StageTimer()
        self._dp_state: dict | None = None   # the multi-device layout
        self._replicas: dict = {}            # (model, device) -> replica

    # --------------------------------------------------------- parallelism --

    def _parallel_layout(self) -> dict:
        """The multi-device layout, resolved once.

        config["data_parallel"]: "auto" spreads the tile batch over every
        visible device when there is more than one; "off" (or 0/1) keeps
        one device; an int caps the count. With the diffusion branch on
        and stage_overlap, the devices are split (parallel/overlap
        .split_mesh): ESRGAN's tile batch shards over the first slots and
        the denoise loop owns the last one, so both branches run at once.

        Returns {"mesh": tuple of devices | None, "slots": their slots,
        "diffusion_slot": int | None, "diffusion_device": device | None};
        slots index the device list, which may repeat a device.
        """
        if self._dp_state is not None:
            return self._dp_state
        mode = self.config.get("data_parallel", "auto")
        devs = devices.visible_devices(self.device)
        if mode in ("off", False, None, 0, 1):
            want = 1
        elif mode == "auto":
            want = len(devs)
        else:
            want = min(int(mode), len(devs))
        state = {"mesh": None, "slots": (), "diffusion_slot": None,
                 "diffusion_device": None}
        if want > 1:
            devs = devs[:want]
            slots, diff = tuple(range(want)), None
            if self.config["use_diffusion"] and self.config.get(
                    "stage_overlap", True):
                slots, diff_slots = split_mesh(devs)
                diff = diff_slots[-1]
            state = {"mesh": tuple(devs[i] for i in slots), "slots": slots,
                     "diffusion_slot": diff,
                     "diffusion_device": None if diff is None else devs[diff]}
            logger.info("Data parallelism: %d-slot tile mesh%s", len(slots),
                        "" if diff is None else
                        f" + diffusion on slot {diff} ({devs[diff]})")
        self._dp_state = state
        return state

    def _use_strips(self, image, mesh, halo: int) -> bool:
        """config["shard_strategy"]: "tiles" (default) shards the tile
        batch; "strips" strip-shards the image; "auto" strips above 16 MP
        (the reference's force-tiling threshold), tiles below. A strip must
        be at least halo + 1 rows (the edge strips reflect strip[1:halo+1]),
        else tiles; ``halo`` is the one this _run_tiled call uses."""
        strategy = self.config.get("shard_strategy", "tiles")
        if strategy not in ("strips", "auto"):
            return False
        h, w = int(image.shape[0]), int(image.shape[1])
        if strategy == "auto" and (h * w) / 1e6 <= 16:
            return False
        rows = -(-h // len(mesh))
        if rows < halo + 1:
            logger.warning("shard_strategy=%s: %d rows a slot over %d slots "
                           "is thinner than the %d-px halo; using tiles",
                           strategy, rows, len(mesh), halo)
            return False
        return True

    def _replica(self, key: str, device) -> torch.nn.Module:
        """The model of branch ``key`` on ``device``: itself, or a replica
        made once (K1's packed weights moved along)."""
        model = self.models[key]
        if isinstance(model, dict):
            model = model["model"]
        cache_key = (key, id(model), torch.device(device))
        if cache_key not in self._replicas:
            self._replicas[cache_key] = module_on(model, device)
        return self._replicas[cache_key]

    # ------------------------------------------------------------- models --

    def _esrgan_weight_paths(self, fname="RealESRGAN_x2plus.pth") -> list[str]:
        home = os.path.expanduser("~")
        candidates = []
        if self.config.get("esrgan_model_path"):
            candidates.append(self.config["esrgan_model_path"])
        if "NESR_MODELS_DIR" in os.environ:
            candidates.append(os.path.join(os.environ["NESR_MODELS_DIR"],
                                           "weights", fname))
        candidates += [
            os.path.join(home, ".nesr", "models", "weights", fname),
            os.path.join("models", "weights", fname),
            os.path.join("weights", fname),
            os.path.join(os.getcwd(), "models", "weights", fname),
        ]
        return candidates + [c[:-4] + ".safetensors"
                             for c in candidates if c.endswith(".pth")]

    def _load_models(self):
        self._load_esrgan()
        self._load_swinir()
        self._load_diffusion()
        self._load_segmentation()

    def _load_esrgan(self):
        cfg = self.config
        if not cfg["use_esrgan"] or "esrgan" in self.models:
            return
        # Config errors raise; only loading the weights may disable the
        # branch (the ladder's first rung).
        arch, fname = {
            "12ch": (dict(num_in_ch=12, num_out_ch=3, scale=4),
                     "RealESRGAN_x2plus.pth"),
            "x2plus": (dict(num_in_ch=3, num_out_ch=3, scale=2),
                       "RealESRGAN_x2plus.pth"),
            "x4plus": (dict(num_in_ch=3, num_out_ch=3, scale=4),
                       "RealESRGAN_x4plus.pth"),
        }[cfg.get("esrgan_variant", "12ch")]
        arch.update(num_feat=64, num_block=23, num_grow_ch=32)
        if cfg.get("esrgan_arch"):
            arch.update(cfg["esrgan_arch"])
        model_cfg = RRDBNetConfig(**arch)
        # As in the JAX package the dform and int8 trunks are options of the
        # fused layout: fuse_rdb false keeps the stock trunk for any value,
        # and dform applies in bfloat16 only (else the fused trunk runs).
        if not cfg.get("fuse_rdb", True):
            trunk = "stock"
        elif cfg.get("esrgan_trunk") == "int8" or (
                cfg.get("esrgan_trunk") == "dform"
                and cfg["precision"] == "bfloat16"):
            trunk = cfg["esrgan_trunk"]
        else:
            trunk = "fused"
        if (trunk == "dform" and self.device == "cuda"
                and (model_cfg.num_feat, model_cfg.num_grow_ch)
                != (KERNEL_NF, KERNEL_GC)):
            raise ValueError(
                f"esrgan_trunk 'dform': the kernel takes {KERNEL_NF} "
                f"features and growth {KERNEL_GC}, got "
                f"{model_cfg.num_feat} and {model_cfg.num_grow_ch}")
        try:
            logger.info("Loading Real-ESRGAN model...")
            path = next((p for p in self._esrgan_weight_paths(fname)
                         if p and os.path.exists(p)), None)
            if path is None:
                raise FileNotFoundError(
                    f"{fname} not found; set esrgan_model_path or "
                    "NESR_MODELS_DIR")
            logger.info("Found ESRGAN model at: %s", path)
            model = RRDBNet(model_cfg, load_state_dict(path),
                            dtype=torch_dtype(cfg["precision"]),
                            device=self.device, trunk=trunk).eval()
        except Exception as exc:  # noqa: BLE001 - ladder: branch disabled
            _reraise(exc, "model load")
            logger.error("Error loading Real-ESRGAN model: %s", exc)
            return
        self.models["esrgan"] = {"model": model, "cfg": model_cfg}
        logger.info("Real-ESRGAN model loaded (%s trunk, %s)", trunk,
                    cfg["precision"])

    def _load_swinir(self):
        cfg = self.config
        if not cfg.get("use_swinir") or "swinir" in self.models:
            return
        try:
            logger.info("Loading SwinIR model...")
            self.models["swinir"] = load_swinir(
                cfg.get("swinir_model_path"), compute_dtype=cfg["precision"],
                device=self.device)
            logger.info("SwinIR model loaded successfully (%s)",
                        self.models["swinir"].cfg)
        except Exception as exc:  # noqa: BLE001 - ladder: branch disabled
            _reraise(exc, "SwinIR model load")
            logger.warning("SwinIR model loading failed: %s", exc)
            cfg["use_swinir"] = False

    def _load_diffusion(self):
        cfg = self.config
        if not cfg["use_diffusion"] or "diffusion" in self.models:
            return
        try:
            logger.info("Loading Stable Diffusion upscaler...")
            pipe = load_upscale_pipeline(
                cfg.get("diffusion_model_path"), device=self.device,
                compute_dtype=cfg["precision"],
                cfg_split=cfg.get("sd_cfg_split"))
            diff_dev = self._parallel_layout()["diffusion_device"]
            if diff_dev is not None:
                # stage overlap: the denoise loop on its own slot
                pipe.to_device(diff_dev)
            devs = devices.visible_devices(self.device)
            if cfg.get("sd_cfg_shard") and len(devs) >= 2:
                # the last two devices: with the overlap split, the tail of
                # the list is the diffusion slot, so this composes with the
                # tile mesh on the head of it
                pipe.cfg_shard_mesh = tuple(devs[-2:])
                logger.info("Split-CFG sharded over %s", devs[-2:])
            self.models["diffusion"] = pipe
            logger.info("Stable Diffusion upscaler loaded successfully")
        except Exception as exc:  # noqa: BLE001 - ladder: branch disabled
            _reraise(exc, "diffusion model load")
            logger.error("Error loading Stable Diffusion upscaler: %s", exc)
            cfg["use_diffusion"] = False
            # the layout kept a slot for a branch that will not run
            self._dp_state = None

    def _load_segmentation(self):
        cfg = self.config
        if not cfg["segment_enhancement"] or "segmentation" in self.models:
            return
        try:
            logger.info("Loading segmentation model for targeted "
                        "enhancement...")
            self.models["segmentation"] = load_segformer(
                cfg.get("segmentation_model_path"),
                compute_dtype=cfg["precision"], device=self.device)
            logger.info("Segmentation model loaded successfully")
        except Exception as exc:  # noqa: BLE001 - ladder: branch disabled
            _reraise(exc, "segmentation model load")
            logger.error("Error loading segmentation model: %s", exc)
            cfg["segment_enhancement"] = False

    # ------------------------------------------------------------ helpers --

    def _home_device(self) -> torch.device:
        """The device a request starts and ends on (its index resolved)."""
        home = torch.device(self.device)
        if home.type == "cuda" and home.index is None:
            home = torch.device("cuda", torch.cuda.current_device())
        return home

    def _sync_devices(self) -> tuple:
        """The devices a stage synchronises: the home device, the layout's
        tile mesh and diffusion slot, and the split-CFG pair, each once."""
        layout = self._parallel_layout()
        devs = [self._home_device(), *(layout["mesh"] or ())]
        if layout["diffusion_device"] is not None:
            devs.append(layout["diffusion_device"])
        devs.extend(getattr(self.models.get("diffusion"), "cfg_shard_mesh",
                            None) or ())
        return tuple(dict.fromkeys(torch.device(d) for d in devs))

    def _stage(self, name: str, **sync):
        return self.timer.stage(name, devices=self._sync_devices(), **sync)

    def _callback(self, stage, iteration, total, message):
        cb = self.config.get("progress_callback")
        if cb:
            cb(stage, iteration, total, message)

    def _cancel_check(self):
        return self.config.get("cancel_check")

    def _check_cancelled(self):
        cc = self._cancel_check()
        if cc is not None and cc():
            raise EnhancementCancelled("enhancement cancelled")

    @staticmethod
    def _bicubic_upscale(image, factor):
        h, w = image.shape[:2]
        return resize(image, dsize=(int(w * factor), int(h * factor)),
                      interpolation="bicubic")

    def _tile(self) -> int:
        return min(int(self.config["max_tile_size"]), 256)

    # ------------------------------------------------------------- stages --

    def _preprocess_image(self, image):
        """NL-means denoise (when denoise_level > 0), then CLAHE contrast,
        timed as separate stages."""
        try:
            if self.config["denoise_level"] > 0:
                with self._stage("pre/denoise"):
                    image = denoise_stage(
                        image, self.config["denoise_level"],
                        max_megapixels=self.config.get(
                            "denoise_max_megapixels"))
            with self._stage("pre/contrast"):
                return contrast_stage(image)
        except Exception as exc:  # noqa: BLE001 - ladder: skip step
            _reraise(exc, "preprocessing")
            logger.warning("Preprocessing failed: %s, skipping", exc)
            return image

    def _segment_and_enhance(self, image):
        """SegFormer class map -> object mask (class > 0), resized as the
        reference does (nearest, then bilinear) -> masked sharpening."""
        try:
            seg = self.models.get("segmentation")
            if seg is None:
                return image
            h, w = int(image.shape[0]), int(image.shape[1])
            seg_map = seg.segment(image)
            if tuple(seg_map.shape) != (h, w):
                seg_map = resize(seg_map.to(torch.uint8), dsize=(w, h),
                                 interpolation="nearest")
            mask = (seg_map > 0).to(torch.uint8)
            mask = resize(mask, dsize=(w, h), interpolation="bilinear")
            return masked_sharpen(image, mask)
        except Exception as exc:  # noqa: BLE001 - ladder: skip step
            _reraise(exc, "segmentation")
            logger.warning("Segmentation enhancement failed: %s", exc)
            return image

    def _esrgan_batch_forward(self, tiles_u8, three_channel: bool):
        """esrgan_step on the model replica of the tiles' device."""
        if self.models["esrgan"]["cfg"].num_in_ch == 12:
            mode = "repeat12" if three_channel else "stack12"
        else:
            mode = "direct"
        return esrgan_step(self._replica("esrgan", tiles_u8.device),
                           tiles_u8, mode)

    def _esrgan_out_scale(self) -> int:
        return self.models["esrgan"]["cfg"].scale

    def _run_tiled(self, model_fn, image, tile_size: int, halo: int,
                   scale: int, batch_tiles: int | None = None):
        """Tiled execution: strip-sharded or tile-sharded over the mesh
        when one is active, else on the image's device. ``model_fn`` runs
        a batch on whatever device it is given (each branch picks its
        replica by the tiles' device). An ordinary failure of a sharded
        rung falls back to the next one; cancellation and device faults
        propagate (``_reraise``). batch_tiles overrides the config's
        tile_batch for a branch with its own batch size (SwinIR's
        swinir_tile_batch)."""
        if batch_tiles is None:
            batch_tiles = self.config.get("tile_batch")
        mesh = self._parallel_layout()["mesh"]
        if mesh is not None and self._use_strips(image, mesh, halo):
            try:
                return sharded.process_strips_sharded(
                    model_fn, image, mesh, halo=halo, scale=scale)
            except Exception as exc:  # noqa: BLE001 - ladder
                _reraise(exc, "strip-sharded tiling")
                logger.warning("Strip-sharded path failed (%s); falling "
                               "back to tile sharding", exc)
        if mesh is not None:
            try:
                return sharded.process_tiled_sharded(
                    model_fn, image, mesh, tile_size=tile_size, halo=halo,
                    scale=scale, batch_tiles=batch_tiles,
                    cancel_check=self._cancel_check(), timer=self.timer)
            except Exception as exc:  # noqa: BLE001 - ladder
                _reraise(exc, "sharded tiling")
                logger.warning("Sharded tile path failed (%s); falling back "
                               "to single-device tiling", exc)
        return process_tiled(model_fn, image, tile_size=tile_size, halo=halo,
                             scale=scale, batch_tiles=batch_tiles,
                             cancel_check=self._cancel_check(),
                             timer=self.timer)

    def _esrgan_whole(self, image, three_channel: bool):
        """model(image) at its raw scale; above half a tile the forward runs
        through the tile machinery (same geometry, one program shape)."""
        h, w = int(image.shape[0]), int(image.shape[1])
        tile = self._tile()
        if min(h, w) <= tile // 2:
            return self._esrgan_batch_forward(image[None], three_channel)[0]
        return self._run_tiled(
            lambda tiles: self._esrgan_batch_forward(tiles, three_channel),
            image, tile_size=tile, halo=self.config.get("tile_halo", 16),
            scale=self._esrgan_out_scale())

    def _esrgan_tiled(self, image, three_channel, tile_size, padding):
        """Tiled ESRGAN, then one Lanczos resize to the upscale_factor
        canvas (the reference's tiled geometry); under ``parity_tiling``
        the reference's own per-tile loop, each tile through the whole-image
        forward."""
        upscale = self.config["upscale_factor"]
        if self.config["parity_tiling"]:
            return process_with_tiling_parity(
                lambda t: self._esrgan_whole(t, three_channel), image,
                upscale_factor=upscale, tile_size=tile_size, padding=padding,
                cancel_check=self._cancel_check())
        out = self._run_tiled(
            lambda tiles: self._esrgan_batch_forward(tiles, three_channel),
            image, tile_size=tile_size, halo=padding,
            scale=self._esrgan_out_scale())
        h, w = int(image.shape[0]), int(image.shape[1])
        target = (int(w * upscale), int(h * upscale))
        if out.shape[1] == target[0] and out.shape[0] == target[1]:
            return out
        return resize(out, dsize=target, interpolation="lanczos4")

    def _apply_esrgan(self, image):
        """Primary mode -> 3-channel -> tiled 3-channel (256) -> bicubic."""
        if not self.config["use_esrgan"] or "esrgan" not in self.models:
            return None
        h, w = int(image.shape[0]), int(image.shape[1])
        megapixels = (h * w) / (1024 * 1024)
        use_tiling = False
        if self.config["enable_tiling"]:
            threshold = self.config.get("max_megapixels", 2)
            use_tiling = megapixels > threshold
        use_3channel = self.config["force_3channel"]
        if megapixels > 16:
            use_tiling = True
            use_3channel = True
            logger.info("Forcing tiling and 3-channel mode for %.1f MP image",
                        megapixels)
        tile_size = self.config["max_tile_size"]
        if self.config.get("memory_efficient"):
            use_tiling = True
            tile_size = min(tile_size, 256)
            if self.config.get("tile_batch") is None:
                self.config["tile_batch"] = 4

        def primary():
            if use_tiling:
                logger.info("Using tiled processing with %dx%d tiles",
                            tile_size, tile_size)
                return self._esrgan_tiled(
                    image, use_3channel, tile_size,
                    padding=self.config.get("tile_halo", 16))
            return self._esrgan_whole(image, three_channel=use_3channel)

        rungs = [("primary", primary)]
        if not use_3channel:
            rungs.append(("3-channel mode",
                          lambda: self._esrgan_whole(image, True)))
        rungs.append(("tiled 3-channel (256px)",
                      lambda: self._esrgan_tiled(image, True, 256,
                                                 padding=16)))
        for name, rung in rungs:
            try:
                if name != "primary":
                    logger.info("Falling back to %s", name)
                return rung()
            except Exception as exc:  # noqa: BLE001 - ladder by design
                _reraise(exc, "ESRGAN")
                logger.warning("ESRGAN %s failed: %s", name, exc)
        logger.warning("All ESRGAN methods failed, using bicubic upscaling")
        return self._bicubic_upscale(image, self.config["upscale_factor"])

    def _apply_swinir(self, image):
        """The third upscaling branch: the whole image in one forward up to
        twice the tile, else tiled like ESRGAN at swinir_tile_batch tiles a
        forward. An ordinary failure skips the branch (None); cancellation
        and device faults propagate."""
        model = self.models.get("swinir")
        if model is None:
            return None
        try:
            h, w = int(image.shape[0]), int(image.shape[1])
            tile = self._tile()
            if max(h, w) <= 2 * tile:
                return model.upscale_batch(image[None])[0]
            return self._run_tiled(
                lambda t: self._replica("swinir", t.device).upscale_batch(t),
                image, tile_size=tile,
                halo=self.config.get("tile_halo", 16), scale=model.cfg.scale,
                batch_tiles=int(self.config.get("swinir_tile_batch", 1)))
        except Exception as exc:  # noqa: BLE001 - ladder: branch skipped
            _reraise(exc, "SwinIR")
            logger.warning("SwinIR upscaling failed: %s", exc)
            return None

    def _diffusion_capped(self, image) -> bool:
        """Above ``diffusion_max_megapixels`` the branch is skipped: the
        4x-grown canvas of a later iteration would run O(tokens^2)
        attention."""
        cap = self.config.get("diffusion_max_megapixels")
        return bool(cap) and (int(image.shape[0]) * int(image.shape[1])
                              / 1e6 > float(cap))

    def _apply_diffusion(self, image, prompt):
        """The SD x4 upscaler on an (H, W, 3) uint8 device tensor; None when
        the branch is off or the input is above ``diffusion_max_megapixels``.
        A kernel or CUDA fault propagates (``_reraise``): a broken K3 must
        not come out as an ESRGAN-only image."""
        if "diffusion" not in self.models:
            return None
        try:
            if self._diffusion_capped(image):
                logger.info(
                    "Skipping diffusion for %.2f MP input (> %.2f MP cap; "
                    "set diffusion_max_megapixels=None to force)",
                    image.shape[0] * image.shape[1] / 1e6,
                    float(self.config["diffusion_max_megapixels"]))
                return None
            pipe = self.models["diffusion"]
            pipe.timer = self.timer
            steps = self.config.get("num_inference_steps")
            if steps is None:
                # the reference's tiers by device: cuda 20, cpu 10
                steps = {"cuda": 20}.get(self.device, 10)
            out = pipe(prompt=prompt, image=image, noise_level=20,
                       num_inference_steps=steps, guidance_scale=7.5)
            # from the diffusion slot to the home slot, for the ensemble
            return out.to(image.device, non_blocking=True)
        except Exception as exc:  # noqa: BLE001 - ladder: branch skipped
            _reraise(exc, "diffusion")
            logger.warning("Diffusion-based upscaling failed: %s", exc)
            return None

    def _overlap_active(self) -> bool:
        """Stage overlap applies when both model branches run: ESRGAN's
        work is left in flight while diffusion is dispatched."""
        return bool(self.config.get("stage_overlap", True)
                    and self.config["use_diffusion"]
                    and "diffusion" in self.models)

    def _postprocess_image(self, image):
        if self.config["adaptive_sharpening"]:
            try:
                return adaptive_sharpen(image)
            except Exception as exc:  # noqa: BLE001 - ladder: skip step
                _reraise(exc, "postprocessing")
                logger.warning("Adaptive sharpening failed: %s", exc)
        return image

    # Streamed final iteration ---------------------------------------------

    def _stream_final_ok(self, iteration, iterations, image) -> bool:
        """The fused streamed tail applies to the last iteration when the
        output keeps the model's raw scale (no canvas-shrink tiling) and no
        mesh is active (the sharded flows own their output)."""
        cfg = self.config
        if not cfg.get("streamed_output", True):
            return False
        if iteration != iterations - 1:
            return False
        if not (cfg["use_esrgan"] and "esrgan" in self.models):
            return False
        if (cfg["use_diffusion"] and "diffusion" in self.models
                and not self._diffusion_capped(image)):
            return False  # diffusion joins this iteration's ensemble
        if cfg.get("use_swinir") and "swinir" in self.models:
            return False  # SwinIR joins the ensemble
        if cfg["parity_tiling"] or cfg.get("memory_efficient"):
            return False
        if self._parallel_layout()["mesh"] is not None:
            return False
        h, w = int(image.shape[0]), int(image.shape[1])
        megapixels = (h * w) / (1024 * 1024)
        if cfg["enable_tiling"] and megapixels > cfg.get("max_megapixels", 2):
            return False
        if megapixels > 16:
            return False
        # pad_to_grid reflects at most tile-1 rows: need min side > tile/2
        return min(h, w) > self._tile() // 2

    def _streamed_esrgan_final(self, image) -> np.ndarray:
        """ESRGAN + adaptive sharpen fused per tile, landed on the host.

        The image is tiled on the card. Each output tile is sharpened with
        its halo as context (halo*scale >= the sharpen radius), cropped and
        copied into the host canvas while the next chunk computes."""
        cfg = self.config
        three = cfg["force_3channel"]
        sharpen = cfg["adaptive_sharpening"]

        def model_fn(tiles):
            out = self._esrgan_batch_forward(tiles, three)
            return adaptive_sharpen_batch(out) if sharpen else out

        return process_tiled_to_host(
            model_fn, image, tile_size=self._tile(),
            halo=max(4, int(cfg.get("tile_halo", 16))),
            scale=self._esrgan_out_scale(),
            batch_tiles=int(cfg.get("tile_batch") or 16),
            cancel_check=self._cancel_check(), timer=self.timer)

    # --------------------------------------------------------------- main --

    def enhance_array(self, image: np.ndarray, prompt: str | None = None,
                      iterations: int | None = None) -> np.ndarray:
        """Array in, array out (RGB uint8). ``prompt`` steers the diffusion
        branch. One request of ``timer`` (``runtime/profiler``): its spans
        read the home device's clock, resolved when it ends."""
        self._load_models()
        if not self.models:
            logger.warning("No models were loaded. Using basic upscaling only.")
        iterations = iterations or self.config["iterations"]
        if prompt is None and self.config["use_diffusion"]:
            prompt = "a high resolution, detailed photograph"
        with self.timer.request(self._home_device()):
            with self.timer.span("request/upload"):
                current = torch.tensor(np.asarray(image), device=self.device)
            return self._iterate(current, prompt, iterations)

    def _iterate(self, current: torch.Tensor, prompt: str | None,
                 iterations: int) -> np.ndarray:
        """enhance_array's iterations on the uploaded image."""
        for iteration in range(iterations):
            t0 = time.time()
            self._check_cancelled()
            logger.info("Starting iteration %d/%d", iteration + 1, iterations)
            self._callback("Enhancement", iteration, iterations,
                           f"Starting iteration {iteration+1}/{iterations}")
            self._callback("Preprocessing", iteration, iterations,
                           "Applying denoising and contrast enhancement")
            current = self._preprocess_image(current)

            if (self.config["segment_enhancement"]
                    and "segmentation" in self.models):
                self._callback("Segmentation", iteration, iterations,
                               "Performing region-based analysis and "
                               "enhancement")
                with self._stage("segmentation"):
                    current = self._segment_and_enhance(current)

            streamed = None
            if self._stream_final_ok(iteration, iterations, current):
                try:
                    logger.info("Applying Real-ESRGAN upscaling (streamed "
                                "final iteration)...")
                    self._callback("ESRGAN", iteration, iterations,
                                   "Applying Real-ESRGAN upscaling")
                    with self._stage("esrgan+post/streamed"):
                        streamed = self._streamed_esrgan_final(current)
                    self._callback("Ensemble", iteration, iterations,
                                   "Combining results from multiple models")
                    self._callback("Postprocessing", iteration, iterations,
                                   "Applying final enhancements")
                except Exception as exc:  # noqa: BLE001 - ladder
                    _reraise(exc, "ESRGAN")
                    logger.warning("Streamed final path failed (%s); using "
                                   "the standard stage chain", exc)
            if streamed is not None:
                current = streamed
            else:
                # Under stage overlap the branches' stages do not wait for
                # their work: ESRGAN's stays in flight while diffusion is
                # dispatched (on its own slot when the layout split the
                # devices), and the ensemble stage waits for both. Their
                # times are then dispatch times.
                overlap = self._overlap_active()
                upscaled = []
                if self.config["use_esrgan"] and "esrgan" in self.models:
                    logger.info("Applying Real-ESRGAN upscaling...")
                    self._callback("ESRGAN", iteration, iterations,
                                   "Applying Real-ESRGAN upscaling")
                    with self._stage("esrgan", sync_end=not overlap):
                        result = self._apply_esrgan(current)
                    if result is not None:
                        upscaled.append(result)
                if self.config.get("use_swinir") and "swinir" in self.models:
                    logger.info("Applying SwinIR upscaling...")
                    self._callback("SwinIR", iteration, iterations,
                                   "Applying SwinIR upscaling")
                    with self._stage("swinir", sync_start=not overlap,
                                     sync_end=not overlap):
                        result = self._apply_swinir(current)
                    if result is not None:
                        upscaled.append(result)
                if self.config["use_diffusion"] and "diffusion" in self.models:
                    logger.info("Applying diffusion-based upscaling...")
                    self._callback("Diffusion", iteration, iterations,
                                   "Applying diffusion-based upscaling with "
                                   f"prompt: {prompt}")
                    with self._stage("diffusion", sync_start=not overlap,
                                     sync_end=not overlap):
                        result = self._apply_diffusion(current, prompt)
                    if result is not None:
                        upscaled.append(result)
                self._callback("Ensemble", iteration, iterations,
                               "Combining results from multiple models")
                if upscaled:
                    with self._stage("ensemble", sync_start=not overlap):
                        current = ensemble(upscaled)
                else:
                    logger.warning("All models failed, falling back to "
                                   "bicubic upscaling")
                    current = self._bicubic_upscale(
                        current, self.config["upscale_factor"])
                self._callback("Postprocessing", iteration, iterations,
                               "Applying final enhancements")
                with self._stage("postprocess"):
                    current = self._postprocess_image(current)

            if self.config["intermediate_saves"]:
                from neural_enhanced_super_resolution_torch.utils.io import (
                    imwrite_rgb)
                path = os.path.join(self.config["output_dir"],
                                    f"intermediate_iter{iteration+1}.png")
                imwrite_rgb(path, device_fetch(current))
                logger.info("Saved intermediate result: %s", path)
            if self.config.get("image_callback"):
                self.config["image_callback"](device_fetch(current))
            logger.info("Completed iteration %d in %.1fs", iteration + 1,
                        time.time() - t0)
        if isinstance(current, np.ndarray):
            return current  # the streamed final iteration landed on host
        with self.timer.stage("finalize/d2h", devices=self._sync_devices()):
            return device_fetch(current)

    def enhance_image(self, image_path: str, prompt: str | None = None) -> str:
        """Enhance an image file; returns the saved output path."""
        from neural_enhanced_super_resolution_torch.utils.io import (
            imread_rgb, imwrite_rgb)
        image = imread_rgb(image_path)
        original_h, original_w = image.shape[:2]
        self._callback("Starting enhancement", 0, self.config["iterations"],
                       f"Image size: {original_w}x{original_h}")
        profile_dir = os.environ.get("NESR_PROFILE_DIR")
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                final = self.enhance_array(image, prompt)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            logger.info("Profiler trace written to %s", profile_dir)
        else:
            final = self.enhance_array(image, prompt)

        final_h, final_w = final.shape[:2]
        scale_achieved = round(final_h / original_h, 1)
        base_name, ext = os.path.splitext(os.path.basename(image_path))
        final_path = os.path.join(
            self.config["output_dir"],
            f"{base_name}_enhanced_x{scale_achieved}{ext}")
        imwrite_rgb(final_path, final)
        logger.info("Enhancement complete. Final image saved to: %s",
                    final_path)
        logger.info("Original size: %dx%d, Enhanced size: %dx%d (x%s)",
                    original_w, original_h, final_w, final_h, scale_achieved)
        self._callback("Complete", self.config["iterations"],
                       self.config["iterations"],
                       f"Enhancement complete: {original_w}x{original_h} → "
                       f"{final_w}x{final_h} (x{scale_achieved})")
        self.timer.log_summary()
        return final_path
