"""Model downloader: the registry, resumable downloads with size and MD5
checks, Hugging Face snapshots, and where the weights live on disk.

Counterpart of the JAX package's ``utils/downloader.py``, with the same
names, registry and semantics. ``download_file`` uses ``urllib.request``
(no ``requests``): a ``.partial`` file that resumes with a ``Range``
header, a restart when the server ignores the range, MD5 verification and
a size check. ``download_huggingface_model`` imports ``huggingface_hub``
when it runs and, without it, logs and returns False as the JAX one does.
``get_models_dir`` creates no directory (a missing snapshot disables its
branch, ``pipeline._load_models``); the downloads create what they write.
"""

from __future__ import annotations

import hashlib
import logging
import os
import sys
import urllib.error
import urllib.request

logger = logging.getLogger("nesr.downloader")

__all__ = ["MODELS", "get_models_dir", "get_model_path", "check_models_exist",
           "calculate_md5", "download_file", "download_huggingface_model",
           "download_models", "get_model_info"]

MODELS = {
    "esrgan_x2": {
        "name": "Real-ESRGAN x2 Model",
        "url": ("https://github.com/xinntao/Real-ESRGAN/releases/download/"
                "v0.2.5.0/RealESRGAN_x2plus.pth"),
        "path": "weights/RealESRGAN_x2plus.pth",
        "size": 67010191,
        "md5": "5db904e3e9f0dbf5c64b7ae665527e62",
        "required": True,
    },
    "esrgan_x4": {
        "name": "Real-ESRGAN x4 Model",
        "url": ("https://github.com/xinntao/Real-ESRGAN/releases/download/"
                "v0.1.0/RealESRGAN_x4plus.pth"),
        "path": "weights/RealESRGAN_x4plus.pth",
        "size": 67010191,
        "md5": "94df4e7c584b55e2e9a5d2b8f161860e",
        "required": False,
    },
    "swinir": {
        # the published real-world SwinIR-M x4 GAN checkpoint (the optional
        # use_swinir branch); no MD5 is published for this release asset
        "name": "SwinIR Real-World x4 Model",
        "url": ("https://github.com/JingyunLiang/SwinIR/releases/download/"
                "v0.0/003_realSR_BSRGAN_DFO_s64w8_SwinIR-M_x4_GAN.pth"),
        "path": "weights/SwinIR_realSR_M_x4_GAN.pth",
        "size": None,
        "required": False,
    },
    "sd_upscaler": {
        "name": "Stable Diffusion Upscaler",
        "huggingface_id": "stabilityai/stable-diffusion-x4-upscaler",
        "path": None,
        "size": 1789525015,
        "required": True,
    },
    "segmentation": {
        "name": "Segmentation Model",
        "huggingface_id": "nvidia/segformer-b0-finetuned-ade-512-512",
        "path": None,
        "size": 31256892,
        "required": True,
    },
}

_CHUNK = 1 << 20


def get_models_dir() -> str:
    """``NESR_MODELS_DIR`` if set, else the platform's default."""
    if "NESR_MODELS_DIR" in os.environ:
        return os.environ["NESR_MODELS_DIR"]
    if sys.platform == "win32":
        base_dir = os.path.join(os.environ.get("APPDATA", ""), "NESR")
    elif sys.platform == "darwin":
        base_dir = os.path.join(os.path.expanduser("~"), "Library",
                                "Application Support", "NESR")
    else:
        base_dir = os.path.join(os.path.expanduser("~"), ".nesr")
    return os.path.join(base_dir, "models")


def get_model_path(model_key: str) -> str:
    """A file entry lives at its ``path`` under the models directory, a
    Hugging Face snapshot under its repo id's last part."""
    info = MODELS[model_key]
    if info.get("path"):
        return os.path.join(get_models_dir(), info["path"])
    return os.path.join(get_models_dir(), "huggingface",
                        info["huggingface_id"].split("/")[-1])


def check_models_exist() -> dict[str, bool]:
    """Map model key -> whether its weights are on disk (a snapshot: a
    non-empty directory, or the Hugging Face cache without the network)."""
    result = {}
    for key, info in MODELS.items():
        local = get_model_path(key)
        if info.get("huggingface_id"):
            if os.path.isdir(local) and os.listdir(local):
                result[key] = True
                continue
            try:
                import huggingface_hub
                result[key] = huggingface_hub.model_info(
                    info["huggingface_id"], token=None,
                    local_files_only=True) is not None
            except Exception:  # noqa: BLE001 - absent, offline or unknown
                result[key] = False
        else:
            result[key] = os.path.exists(local)
    return result


def calculate_md5(file_path: str) -> str:
    h = hashlib.md5()
    with open(file_path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def download_file(url: str, dest_path: str, expected_size: int | None = None,
                  expected_md5: str | None = None,
                  progress_callback=None) -> bool:
    """Resumable chunked download with a Range header and MD5 verification.

    Bytes go to ``dest_path + ".partial"``, which a later call resumes; a
    server that answers 200 to a range restarts the file, 416 means it is
    complete. A failed request keeps the partial file and returns False; an
    MD5 mismatch deletes it and returns False; a size more than 5% off
    ``expected_size`` is logged. ``progress_callback(fraction)`` follows
    the bytes. Returns True once the file is in place."""
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    temp_path = dest_path + ".partial"
    resume_pos = os.path.getsize(temp_path) if os.path.exists(temp_path) else 0
    headers = {"Range": f"bytes={resume_pos}-"} if resume_pos else {}
    try:
        req = urllib.request.Request(url, headers=headers)
        try:
            resp = urllib.request.urlopen(req, timeout=30)
        except urllib.error.HTTPError as err:
            if err.code != 416:   # 416: range beyond EOF, already complete
                logger.error("Download failed: HTTP %s", err.code)
                return False
            resp = None
        if resp is not None:
            with resp:
                status = resp.getcode() or 200   # file:// has no status
                if status not in (200, 206):
                    logger.error("Download failed: HTTP %s", status)
                    return False
                if status == 200:
                    resume_pos = 0   # the range was ignored: start over
                total = int(resp.headers.get("content-length") or 0)
                total += resume_pos
                done = resume_pos
                with open(temp_path, "ab" if resume_pos else "wb") as f:
                    for chunk in iter(lambda: resp.read(_CHUNK), b""):
                        f.write(chunk)
                        done += len(chunk)
                        if progress_callback and total:
                            progress_callback(done / total)
    except Exception as exc:  # noqa: BLE001 - reported, partial kept
        logger.error("Download error: %s (partial file kept for resume)", exc)
        return False

    if expected_md5:
        actual = calculate_md5(temp_path)
        if actual != expected_md5:
            logger.error("MD5 mismatch: expected %s got %s", expected_md5,
                         actual)
            os.remove(temp_path)
            return False
    if expected_size and abs(os.path.getsize(temp_path) - expected_size) > (
            expected_size * 0.05):
        logger.warning("Size mismatch for %s", dest_path)
    os.replace(temp_path, dest_path)
    return True


def download_huggingface_model(model_key: str, progress_callback=None) -> bool:
    """``huggingface_hub.snapshot_download`` into ``get_model_path``; False
    (logged) when it fails, the package missing included."""
    info = MODELS[model_key]
    try:
        from huggingface_hub import snapshot_download
        snapshot_download(info["huggingface_id"],
                          local_dir=get_model_path(model_key))
        if progress_callback:
            progress_callback(1.0)
        return True
    except Exception as exc:  # noqa: BLE001 - reported to the caller
        logger.error("HuggingFace download failed for %s: %s", model_key, exc)
        return False


def download_models(model_keys=None, progress_callback=None) -> dict[str, bool]:
    """Download the required (or the named) models that are not on disk,
    with one progress fraction over all of them, weighted by size."""
    if model_keys is None:
        model_keys = [k for k, v in MODELS.items() if v.get("required")]
    existing = check_models_exist()
    to_get = [k for k in model_keys if not existing.get(k)]
    results = {k: True for k in model_keys if existing.get(k)}

    def weight(key):   # entries without a published size weigh 64 MB
        return MODELS[key]["size"] or (64 << 20)

    total_size = sum(weight(k) for k in to_get) or 1
    done_size = 0
    for key in to_get:
        info = MODELS[key]

        def agg(frac, _key=key):
            if progress_callback:
                progress_callback(
                    (done_size + frac * weight(_key)) / total_size)

        if info.get("huggingface_id"):
            ok = download_huggingface_model(key, agg)
        else:
            ok = download_file(info["url"], get_model_path(key),
                               info.get("size"), info.get("md5"), agg)
        results[key] = ok
        done_size += weight(key)
        logger.info("%s: %s", info["name"], "ok" if ok else "FAILED")
    return results


def get_model_info() -> dict:
    """The registry with each model's presence and path (for the GUI and
    the command line)."""
    existing = check_models_exist()
    return {k: {"name": v["name"], "size": v["size"],
                "required": v.get("required", False),
                "exists": existing.get(k, False),
                "path": get_model_path(k)}
            for k, v in MODELS.items()}


def _main(argv=None):  # pragma: no cover - thin CLI
    import argparse
    parser = argparse.ArgumentParser(description="NESR model downloader")
    parser.add_argument("--models", nargs="*", default=None,
                        help="model keys to download (default: required)")
    parser.add_argument("--info", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.info:
        for key, info in get_model_info().items():
            print(f"{key}: {info}")
        return
    results = download_models(args.models)
    for key, ok in results.items():
        print(f"{key}: {'ok' if ok else 'FAILED'}")


if __name__ == "__main__":  # pragma: no cover
    _main()
