"""Batch serving executor: decode the next images while the current one runs.

A copy of the JAX package's ``runtime/executor.py`` on the port's
``utils.io.imread_rgb``. One staging thread decodes images into a bounded
queue; the caller's thread enhances them in order, so a resident process
pays process start and model load once for a whole directory::

    with BatchExecutor(pipeline) as ex:
        for path, out in ex.map_paths(paths):
            ...

All device work stays on the caller's thread; the staging thread only
reads files.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np

from neural_enhanced_super_resolution_torch.utils.io import imread_rgb

logger = logging.getLogger("nesr.executor")

__all__ = ["BatchExecutor"]

_SENTINEL = object()


class BatchExecutor:
    """Two-stage pipeline: stage (host thread) -> enhance (caller)."""

    def __init__(self, pipeline, prefetch: int = 2,
                 loader: Callable[[str], np.ndarray] | None = None):
        self.pipeline = pipeline
        self.prefetch = max(1, prefetch)
        self.loader = loader or imread_rgb
        self._queue: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        """Stop the staging thread even if the consumer abandoned map_paths
        early: signal stop, drain the bounded queue so a blocked put()
        returns, then join."""
        if self._thread is not None:
            self._stop.set()
            while self._thread.is_alive():
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    self._thread.join(timeout=0.1)
            self._thread.join()
            self._thread = None
            self._queue = queue.Queue(maxsize=self.prefetch)
            self._stop = threading.Event()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _stage_worker(self, paths: list[str]):
        for path in paths:
            if self._stop.is_set():
                return
            try:
                item = (path, self.loader(path))
            except Exception as exc:  # noqa: BLE001 - per-item ladder
                item = (path, exc)
            if not self._put(item):
                return
        self._put(_SENTINEL)

    def map_paths(self, paths: Iterable[str],
                  prompt: str | None = None
                  ) -> Iterator[tuple[str, np.ndarray | Exception]]:
        """Yield (path, enhanced_array) in order; a failure yields the
        exception instead of an array and the stream continues."""
        paths = list(paths)
        self._thread = threading.Thread(target=self._stage_worker,
                                        args=(paths,), daemon=True)
        self._thread.start()
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                break
            path, img = item
            if isinstance(img, Exception):
                logger.warning("failed to load %s: %s", path, img)
                yield path, img
                continue
            try:
                out = self.pipeline.enhance_array(img, prompt=prompt)
            except Exception as exc:  # noqa: BLE001 - per-item ladder
                logger.error("enhancement failed for %s: %s", path, exc)
                yield path, exc
                continue
            yield path, out
        self.close()
