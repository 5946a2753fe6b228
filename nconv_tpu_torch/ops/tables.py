"""Constant tables built on the host once per key and kept on their device:
resize indices and weights (:mod:`.resize`) and the export border mask
(:func:`nconv_tpu_torch.models.guided.border_mask`).

A table copied from host memory on every call makes the host wait for the
stream (a copy from pageable memory), and inside CUDA graph capture such a
copy is an error. Built once, a table is a device tensor that later calls,
and a captured graph, only read. Callers must not write to a table.

While ``torch.export`` or the ONNX tracer runs, a table is built fresh for
the trace and neither stored nor served: under export it is a fake tensor
(the program lifts it as a constant), and a stored one would poison every
later eager call with that key.
"""
from __future__ import annotations

import threading
from typing import Callable, Hashable

import torch


class TableCache:
    """``get(key, build)``: what ``build()`` made for ``key`` (which names
    the table's device and dtype), built on the first call with that key.
    ``builds`` and ``hits`` count the two outcomes: a serving path past its
    first frame only hits."""

    def __init__(self):
        self._tables: dict[Hashable, object] = {}
        self._lock = threading.Lock()
        self.builds = 0
        self.hits = 0

    def get(self, key: Hashable, build: Callable[[], object]):
        if torch.compiler.is_exporting() or torch.jit.is_tracing():
            return build()
        with self._lock:
            table = self._tables.get(key)
            if table is None:
                table = self._tables[key] = build()
                self.builds += 1
            else:
                self.hits += 1
            return table


TABLES = TableCache()
