"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each ``.cu`` is compiled by its own ``nvcc``, all started together, and the
objects are linked into one shared library with a plain C interface, loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds. The build
runs at first use, into ``build/torch_kernels/`` beside the package
(``NESR_TORCH_BUILD_DIR`` overrides it), and is redone whenever the hash of
the sources changes. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["KernelError", "KernelInputError", "load_library", "build_dir",
           "library_path", "cuda_tool", "check", "stream_ptr",
           "is_device_fault"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_lock = threading.Lock()
_lib = None
_lib_path = None


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch."""


class KernelInputError(KernelError, ValueError):
    """A wrapper refused a device tensor its kernel does not take, so the
    kernel did not launch. A ``ValueError`` to the caller and a
    ``KernelError`` to the pipeline, whose ladder re-raises it."""


def is_device_fault(exc: BaseException) -> bool:
    """A kernel or CUDA runtime failure, which no fallback may hide (the
    pipeline's ladder, the parity tiler's bicubic rungs). Out-of-memory is
    not one: smaller tiles are what the ladder is for."""
    import torch
    if isinstance(exc, KernelError):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA" in str(exc)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def build_dir() -> str:
    return os.environ.get("NESR_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "torch_kernels")


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set NVCC or put the CUDA toolkit's "
                      "bin directory on PATH)")


def cuda_tool(name: str) -> str:
    """A binary of the CUDA toolkit that builds the kernels (``cuobjdump``,
    ``nvdisasm``): the one beside nvcc."""
    path = os.path.join(os.path.dirname(_nvcc()), name)
    if not os.path.exists(path):
        raise KernelError(f"{name} not found beside nvcc ({path})")
    return path


def _compile(srcs: list[str], out_dir: str, tag: str, so: str) -> None:
    """One nvcc per ``.cu``, all started together, then one link."""
    nvcc, arch = _nvcc(), ["-gencode", "arch=compute_90a,code=sm_90a"]
    work = f"{so}.{os.getpid()}.d"
    os.makedirs(work, exist_ok=True)
    jobs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        stem = os.path.splitext(os.path.basename(src))[0]
        obj, log = (os.path.join(work, stem + ext) for ext in (".o", ".log"))
        cmd = [nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", src, "-o", obj]
        with open(log, "w") as f:
            f.write(" ".join(cmd) + "\n")
            f.flush()
            jobs.append((obj, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT)))
    failed = []
    with open(os.path.join(out_dir, f"build_{tag}.log"), "w") as out:
        for obj, log, proc in jobs:
            rc = proc.wait()
            with open(log) as f:
                text = f.read()
            out.write(text)
            if rc != 0:
                failed.append(f"{os.path.basename(obj)} ({rc}):\n"
                              f"{text[-4000:]}")
        if not failed:
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc, *arch, "-shared", "-o", tmp,
                   *(obj for obj, _, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            out.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
            else:
                os.replace(tmp, so)
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise KernelError("nvcc failed: " + "\n".join(failed))


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        digest = hashlib.sha256()
        for path in srcs:
            with open(path, "rb") as f:
                digest.update(os.path.basename(path).encode())
                digest.update(f.read())
        tag = digest.hexdigest()[:16]
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, f"libnesr_torch_{tag}.so")
        if not os.path.exists(so):
            _compile(srcs, out_dir, tag, so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as exc:
            raise KernelError(f"cannot load {so}: {exc}") from exc
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nesr_conv3x3.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        lib.nesr_conv3x3.restype = ci
        lib.nesr_conv3x3_f32.argtypes = [vp] * 4 + [ci] * 6 + [vp]
        lib.nesr_conv3x3_f32.restype = ci
        lib.nesr_conv3x3_head.argtypes = [vp] * 4 + [ci] * 9 + [vp]
        lib.nesr_conv3x3_head.restype = ci
        lib.nesr_conv3x3_head_f32.argtypes = [vp] * 4 + [ci] * 6 + [vp]
        lib.nesr_conv3x3_head_f32.restype = ci
        lib.nesr_conv2x2.argtypes = [vp] * 4 + [ci] * 8 + [vp]
        lib.nesr_conv2x2.restype = ci
        lib.nesr_conv2x2_f32.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        lib.nesr_conv2x2_f32.restype = ci
        lib.nesr_conv3x3_int8.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib.nesr_conv3x3_int8.restype = ci
        lib.nesr_rdb_int8_step.argtypes = [vp] * 11 + [ci] * 12 + [vp]
        lib.nesr_rdb_int8_step.restype = ci
        lib.nesr_rdb_bf16_step.argtypes = [vp] * 8 + [ci] * 15 + [vp]
        lib.nesr_rdb_bf16_step.restype = ci
        lib.nesr_rdb_f32_step.argtypes = [vp] * 8 + [ci] * 8 + [vp]
        lib.nesr_rdb_f32_step.restype = ci
        lib.nesr_int8_amax.argtypes = [vp, ci, ctypes.c_longlong, ci, vp,
                                       ci, vp]
        lib.nesr_int8_amax.restype = ci
        lib.nesr_rdb_int8_occupancy.argtypes = [ci, ci,
                                                ctypes.POINTER(ci),
                                                ctypes.POINTER(ci)]
        lib.nesr_rdb_int8_occupancy.restype = ci
        lib.nesr_rdb_fused.argtypes = [vp] * 8 + [ci, ci, ci, vp]
        lib.nesr_rdb_fused.restype = ci
        cf = ctypes.c_float
        lib.nesr_nl_means.argtypes = [vp] * 2 + [ci] * 5 + [cf] * 3 + [vp]
        lib.nesr_nl_means.restype = ci
        lib.nesr_flash_attn.argtypes = [vp] * 4 + [ci] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, vp]
        lib.nesr_flash_attn.restype = ci
        lib.nesr_flash_attn_f32.argtypes = [vp] * 6 + [ci] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + [ci] * 4 + [
            vp]
        lib.nesr_flash_attn_f32.restype = ci
        _lib, _lib_path = lib, so
        return lib


def library_path() -> str:
    """The shared library ``load_library`` built and loaded."""
    load_library()
    return _lib_path


def check(name: str, err: int) -> None:
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err} at launch")


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
