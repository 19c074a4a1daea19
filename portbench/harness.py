"""One run of one cell: set-up, warm-up, the measured window, the trace's
per-layer metrics, the correctness check, the result line.

Everything a cell is made of is found by name (``BENCHMARK.json``):
the configuration's file (``configs/<config>.json``) names its kind, whose
builder and check are ``models/<kind>.py``; the traffic mix is
``traffic/<cell>.json``, read by ``traffic.Mix``; each end-to-end metric
is ``e2e/<name>.py`` (``value(window)``) and each per-layer metric
``metrics/<name>.py`` (``read(ctx)``, None when it finds nothing).

The window drives ``SuperResolutionPipeline.enhance_array`` through
``runtime/executor.BatchExecutor`` in a closed loop with one client, the
executor's loader handing out the images set-up made.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import tempfile
import time

import numpy as np

from portbench import traffic as traffic_mod
import torch

from portbench.chrome_trace import REQUEST, WINDOW, load_trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

__all__ = ["load_cell", "run", "load_part"]

_loaded: dict = {}


def load_part(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded from its file."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if path not in _loaded:
        spec = importlib.util.spec_from_file_location(
            "portbench_" + kind + "_" + name.replace(".", "_").replace(
                "-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix
    and metrics."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    return {"name": name, "chips": int(cell["chips"]), "config": config,
            "config_name": conf["name"],
            "mix": traffic_mod.load_mix(os.path.join(
                root, "portbench", "traffic", f"{cell['traffic']}.json")),
            "end_to_end": [m for m in bench["end_to_end"]
                           if _applies(m, name)],
            "per_layer": [m for m in bench["per_layer"] if _applies(m, name)]}


class _Timed:
    """The pipeline as the executor sees it: each ``enhance_array`` call
    is timed on the host clock, and the answers of the checked requests
    are kept (host arrays; the window's answers land on the host)."""

    def __init__(self, pipeline, mix, keep: set, on_start=None,
                 first: int = 0):
        self.pipeline, self.mix, self.keep = pipeline, mix, keep
        self.on_start, self.first = on_start, first
        self.records: list = []
        self.kept: dict = {}

    def enhance_array(self, image, prompt=None):
        i = self.first + len(self.records)
        rec = {"index": i, "w": int(image.shape[1]), "h": int(image.shape[0])}
        self.records.append(rec)
        if self.on_start is not None:
            self.on_start(i)
        rec["t_start"] = time.perf_counter()
        with torch.profiler.record_function(REQUEST):
            out = self.pipeline.enhance_array(image, prompt=prompt)
        rec["t_end"] = time.perf_counter()
        rec["out_h"], rec["out_w"] = int(out.shape[0]), int(out.shape[1])
        if i in self.keep:
            self.kept[i] = out
        return out


class Window:
    """The measured window (never traced): what the end-to-end metrics
    read, and the per-layer metrics that need no trace. ``done``: the
    requests completed inside it; ``ran``: every request it started, all
    of which ran to their end; ``stages``: the StageTimer's totals over
    ``ran`` ({stage: (seconds, count)})."""

    def __init__(self, t0, setup_s, records, seconds, stages=None):
        self.t0, self.setup_s = t0, setup_s
        self.ran = [r for r in records if "t_end" in r]
        self.done = [r for r in self.ran if r["t_end"] <= t0 + seconds]
        self.stages = stages or {}


class Ctx:
    """What a per-layer metric's reader reads. From the measured window,
    which the profiler does not slow: ``window`` and its ``requests`` and
    ``stages`` (spans and host-clock metrics). From the traced window that
    follows it: ``trace`` and its requests, ``traced`` (device-trace
    metrics). Besides: the cell's configuration and the weights (for
    their shapes)."""

    def __init__(self, trace, traced, window, cell, weights):
        self.trace, self.traced, self.window = trace, traced, window
        self.requests, self.stages = window.ran, window.stages
        self.weights, self.config = weights, cell["config"]

    def per_request_ms(self, seconds: float) -> float | None:
        """ms a request of the measured window (a span's total)."""
        return 1e3 * seconds / len(self.requests) if self.requests else None

    def per_traced_ms(self, seconds: float) -> float | None:
        """ms a request of the traced window (device time)."""
        return 1e3 * seconds / len(self.traced) if self.traced else None

    def count(self, name: str):
        return load_part("counts", name)


def _closed_loop(system, mix, seconds: float, keep: set, on_start=None,
                 first: int = 0):
    """Requests ``first``, ``first`` + 1, ... one after another through the
    batch executor until ``seconds`` have passed; returns (t0, records,
    kept, failures)."""
    from neural_enhanced_super_resolution_torch.runtime.executor import (
        BatchExecutor)
    timed = _Timed(system.pipeline, mix, keep, on_start, first)
    failures = []
    most = int(seconds * 200) + 64
    with BatchExecutor(timed, prefetch=2, loader=mix.image) as ex:
        t0 = time.perf_counter()
        for key, out in ex.map_paths(range(first, first + most),
                                     prompt=mix.prompt):
            if isinstance(out, Exception):
                failures.append(f"request {key}: {out!r}")
            if time.perf_counter() - t0 >= seconds:
                break
    return t0, timed.records, timed.kept, failures


def _device_info(torch, device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", control: str | None = None, fault=None,
        log=print) -> tuple[dict, list]:
    """One run; returns the result line (a dict) and the compared numbers
    as (name, value, limit) rows."""
    config, mix_spec = cell["config"], cell["mix"]
    kind = load_part("models", config["kind"])
    mix = traffic_mod.Mix(mix_spec, seed)
    system = kind.build(config, seed, device)
    if fault is not None:
        fault(system)
    keep = set(mix.check_indices())

    # Warm-up: each size of the mix once, through the window's own entry.
    for size in mix.sizes:
        system.pipeline.enhance_array(mix.pools[size][0], prompt=mix.prompt)
    if device == "cuda":
        torch.cuda.synchronize()
    from neural_enhanced_super_resolution_torch.runtime.profiler import (
        StageTimer)
    system.pipeline.timer = StageTimer()
    setup_s = time.perf_counter() - t_start

    on_start = kind.window_hook(system, keep)
    metrics, extra = {}, {}
    t0, records, kept, failures = _closed_loop(system, mix, seconds, keep,
                                               on_start)
    timer = system.pipeline.timer
    window = Window(t0, setup_s, records, seconds,
                    {k: (v, timer.counts[k]) for k, v in timer.totals.items()})
    log(f"window: {len(window.done)} requests done in {seconds} s; stage s "
        f"a request: " + json.dumps({k: round(v / max(1, len(window.ran)), 5)
                                     for k, (v, _) in window.stages.items()}))
    if not trace:
        for m in cell["end_to_end"]:
            v = load_part("e2e", m["name"]).value(window)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        info = _device_info(torch, device, cell["chips"])
    else:
        # The device's metrics come from a traced window after the
        # measured one, of at most the mix's ``trace_seconds``: the
        # profiler's host cost slows the host, so what needs no trace
        # (spans, the host clock) is read from the measured window.
        span = min(float(seconds), float(mix_spec.get("trace_seconds",
                                                      seconds)))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                _, traced, _, tfail = _closed_loop(
                    system, mix, span, set(), on_start, first=len(records))
            if device == "cuda":
                torch.cuda.synchronize()
        records, failures = records + traced, failures + tfail
        info = _device_info(torch, device, cell["chips"])
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            tr = load_trace(path)
        finally:
            os.remove(path)
        ctx = Ctx(tr, [r for r in traced if "t_end" in r], window, cell,
                  system.weights)
        for m in cell["per_layer"]:
            v = load_part("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        busy = tr.busy_s()
        info.update(busy_s=busy, window_s=(tr.t1 - tr.t0) / 1e6)
        if ctx.traced and window.done:
            # the measured window's busy share, estimated: the traced
            # requests' device time a request over the measured requests'
            # wall time a request
            wall = (window.done[-1]["t_end"] - window.t0) / len(window.done)
            log(f"busy share: traced {busy / info['window_s']:.4f}, measured"
                f" window (estimate) {busy / len(ctx.traced) / wall:.4f}")
        extra["breakdown"] = {"device_ops": tr.top_ops(10),
                              "idle_gaps": tr.idle_gaps(10)}
        del tr, ctx

    attempted, failed = len(records), len(failures)
    for f in failures:
        log(f"failed: {f}")
    # The check: the program's state freed first, then the reference.
    inputs = {i: mix.image(i) for i in kept}
    hook_state = kind.take_record(system)
    system.free()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = kind.check(system, inputs, kept, hook_state, mix, seed,
                         control) if kept else {}
    log(f"check: {time.perf_counter() - t_check:.1f} s for requests "
        f"{sorted(kept)}: {json.dumps(numbers)}")
    limits = config["limits"]
    # a number that is not finite fails; JSON carries it as 1e300
    rows = [(k, float(numbers[k]) if np.isfinite(numbers[k]) else 1e300,
             limits[k]) for k in limits if k in numbers]
    missing = sorted(set(keep) - set(kept))
    correct = (failed == 0 and not missing and len(rows) == len(limits)
               and all(v <= lim for _, v, lim in rows))
    if missing:
        log(f"checked requests never answered: {missing}")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": info}
    result.update(extra)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows
