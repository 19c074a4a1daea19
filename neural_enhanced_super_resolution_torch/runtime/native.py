"""The host stager: ctypes bindings of ``csrc/nesr_host.cpp``.

Counterpart of the JAX package's ``runtime/native.py``, without its numpy
fallback. The library is built with ``g++ -O3 -shared`` at first use into
the kernels' build directory (``kernels/_build.build_dir()``, keyed by the
source's hash) and loaded with ``ctypes``; a failed build or load raises
``KernelError``, which no ladder rung hides. ``extract_tiles_u8_plain``,
``stitch_tiles_u8_plain`` and ``stack12_u8_plain`` are the numpy versions
the tests hold it to. Nothing here runs at import time. No request path
calls it: the pipeline's image is on the card before the streamed final,
which tiles it there (``parallel/tiling.process_tiled_to_host``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelError, build_dir)

__all__ = ["load_host_library", "host_library_path", "extract_tiles_u8",
           "stitch_tiles_u8", "stack12_u8", "extract_tiles_u8_plain",
           "stitch_tiles_u8_plain", "stack12_u8_plain"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "nesr_host.cpp")
_lock = threading.Lock()
_lib = None
_lib_path = None


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and shutil.which(cand):
            return cand
    raise KernelError("host stager: no C++ compiler (set CXX or install "
                      "g++)")


def load_host_library() -> ctypes.CDLL:
    """Build (if needed) and load the host stager; cached per process."""
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, f"libnesr_host_{tag}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_compiler(), "-O3", "-fPIC", "-shared", "-std=c++17",
                   "-pthread", "-Wall", "-o", tmp, _SRC]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise KernelError(f"host stager build failed "
                                  f"({proc.returncode}): {' '.join(cmd)}\n"
                                  f"{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as exc:
            raise KernelError(f"cannot load {so}: {exc}") from exc
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nesr_extract_tiles_u8.argtypes = [vp] + [ci] * 5 + [vp]
        lib.nesr_extract_tiles_u8.restype = None
        lib.nesr_stitch_tiles_u8.argtypes = [vp] + [ci] * 5 + [vp]
        lib.nesr_stitch_tiles_u8.restype = None
        lib.nesr_stack12_u8.argtypes = [vp, ci, ci, vp]
        lib.nesr_stack12_u8.restype = None
        _lib, _lib_path = lib, so
        return lib


def host_library_path() -> str:
    """The shared library ``load_host_library`` built and loaded."""
    load_host_library()
    return _lib_path


def _out(out: np.ndarray | None, shape: tuple, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if (out.shape != shape or out.dtype != dtype
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous {dtype} "
                         f"array of shape {shape}, got {out.dtype} "
                         f"{out.shape}")
    return out


def _grid(image: np.ndarray, tile: int) -> tuple[int, int, int, int, int]:
    if image.ndim != 3 or image.dtype != np.uint8:
        raise ValueError(f"need an (H, W, C) uint8 image, got {image.dtype} "
                         f"{image.shape}")
    h, w, c = image.shape
    if tile < 1 or h % tile or w % tile:
        raise ValueError(f"{h}x{w} is not a multiple of the tile {tile}: "
                         "pad to the tile grid first")
    return h, w, c, h // tile, w // tile


def extract_tiles_u8(image: np.ndarray, tile: int, halo: int,
                     out: np.ndarray | None = None) -> np.ndarray:
    """(H, W, C) uint8 -> (ny*nx, k, k, C), k = tile + 2*halo, with
    reflect-101 halos, tiles in row-major order. H and W must be multiples
    of ``tile``. ``out`` (optional) is filled in place, e.g. the numpy view
    of a pinned tensor."""
    image = np.ascontiguousarray(image)
    h, w, c, ny, nx = _grid(image, tile)
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    k = tile + 2 * halo
    out = _out(out, (ny * nx, k, k, c), np.uint8)
    load_host_library().nesr_extract_tiles_u8(
        image.ctypes.data, h, w, c, tile, halo, out.ctypes.data)
    return out


def stitch_tiles_u8(tiles: np.ndarray, ny: int, nx: int, tile_out: int,
                    halo_out: int) -> np.ndarray:
    """(ny*nx, ko, ko, C) uint8, ko = tile_out + 2*halo_out ->
    (ny*tile_out, nx*tile_out, C): the tiles' cores."""
    tiles = np.ascontiguousarray(tiles)
    ko = tile_out + 2 * halo_out
    if (tiles.dtype != np.uint8 or tiles.ndim != 4
            or tiles.shape[:3] != (ny * nx, ko, ko)):
        raise ValueError(f"need ({ny * nx}, {ko}, {ko}, C) uint8 tiles, got "
                         f"{tiles.dtype} {tiles.shape}")
    c = tiles.shape[-1]
    out = np.empty((ny * tile_out, nx * tile_out, c), np.uint8)
    load_host_library().nesr_stitch_tiles_u8(
        tiles.ctypes.data, ny, nx, tile_out, halo_out, c, out.ctypes.data)
    return out


def stack12_u8(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W, 12) float32 BGR variant stack
    [bgr, min(bgr*1.1, 1), bgr*0.9, GaussianBlur3(bgr)]."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"need an (H, W, 3) uint8 image, got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w, _ = rgb.shape
    out = np.empty((h, w, 12), np.float32)
    load_host_library().nesr_stack12_u8(rgb.ctypes.data, h, w,
                                        out.ctypes.data)
    return out


# ---- the plain versions (numpy) -------------------------------------------

def extract_tiles_u8_plain(image: np.ndarray, tile: int,
                           halo: int) -> np.ndarray:
    h, w, c, ny, nx = _grid(np.asarray(image), tile)
    k = tile + 2 * halo
    padded = np.pad(image, ((halo, halo), (halo, halo), (0, 0)),
                    mode="reflect")
    out = np.empty((ny * nx, k, k, c), np.uint8)
    for t in range(ny * nx):
        ty, tx = divmod(t, nx)
        out[t] = padded[ty * tile:ty * tile + k, tx * tile:tx * tile + k]
    return out


def stitch_tiles_u8_plain(tiles: np.ndarray, ny: int, nx: int,
                          tile_out: int, halo_out: int) -> np.ndarray:
    c = tiles.shape[-1]
    core = tiles[:, halo_out:halo_out + tile_out,
                 halo_out:halo_out + tile_out, :]
    core = core.reshape(ny, nx, tile_out, tile_out, c)
    return core.transpose(0, 2, 1, 3, 4).reshape(ny * tile_out,
                                                 nx * tile_out, c)


def stack12_u8_plain(rgb: np.ndarray) -> np.ndarray:
    bgr_u8 = rgb[..., ::-1]
    bgr = bgr_u8.astype(np.float32) / 255.0
    tmp = np.pad(bgr_u8.astype(np.uint16), ((0, 0), (1, 1), (0, 0)),
                 mode="reflect")
    hsum = tmp[:, :-2] + 2 * tmp[:, 1:-1] + tmp[:, 2:]
    vpad = np.pad(hsum, ((1, 1), (0, 0), (0, 0)), mode="reflect")
    acc = vpad[:-2] + 2 * vpad[1:-1] + vpad[2:]
    blurred = ((acc + 8) // 16).astype(np.float32) / 255.0
    return np.concatenate([bgr, np.minimum(bgr * 1.1, 1.0), bgr * 0.9,
                           blurred], axis=-1).astype(np.float32)
