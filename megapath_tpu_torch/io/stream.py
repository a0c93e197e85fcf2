"""Async batched read streaming (replaces soap4's aio_thread.cpp).

The port's copy of ``megapath_tpu/io/stream.py``. Paths go through the
C++ reader (``native.NativeFastqReader``), file objects through the
Python reader, the reference's choice by input type; a C++ reader that
cannot be built raises and is never replaced by the Python one. The
reference overlaps gzip/FASTQ parsing with alignment using an IO
thread and two swap buffers (aio_thread.h:55-60 BufferStatus state
machine). Here a reader thread parses and *packs* read-pair batches
into fixed-shape arrays while the engines work on the previous batch;
the queue depth of 2 mirrors the double buffer.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from megapath_tpu_torch.index.pack import pack_reads
from megapath_tpu_torch.io.fastq import read_fastx, trim_readno


@dataclass
class ReadBatch:
    names: List[str]
    seqs1: List[str]
    quals1: List[str]
    seqs2: List[str]
    quals2: List[str]
    reads1: np.ndarray
    lens1: np.ndarray
    reads2: np.ndarray
    lens2: np.ndarray

    def __len__(self) -> int:
        return len(self.names)


def _native_batch_iter(r1_path, r2_path, batch_size: int, max_len: int):
    """Parse and pack in the C++ reader (aio_thread.cpp equivalent); the
    string fields come from the raw ASCII rows."""
    from megapath_tpu_torch.native import NativeFastqReader

    def rows_to_str(arr, lens):
        return [arr[i, : lens[i]].tobytes().decode() for i in range(len(lens))]

    with NativeFastqReader(str(r1_path), max_len) as f1, NativeFastqReader(
        str(r2_path), max_len
    ) as f2:
        while True:
            c1, l1, q1, s1, n1 = f1.next_batch(batch_size)
            c2, l2, q2, s2, n2 = f2.next_batch(batch_size)
            m = min(len(n1), len(n2))
            if m == 0:
                return
            yield ReadBatch(
                n1[:m],
                rows_to_str(s1, l1[:m]),
                rows_to_str(q1, l1[:m]),
                rows_to_str(s2, l2[:m]),
                rows_to_str(q2, l2[:m]),
                c1[:m],
                l1[:m],
                c2[:m],
                l2[:m],
            )


def _batch_iter(r1_path, r2_path, batch_size: int, max_len: int):
    if not (hasattr(r1_path, "read") or hasattr(r2_path, "read")):
        yield from _native_batch_iter(r1_path, r2_path, batch_size, max_len)
        return
    it1 = read_fastx(r1_path)
    it2 = read_fastx(r2_path)
    while True:
        names, s1, q1, s2, q2 = [], [], [], [], []
        for _ in range(batch_size):
            try:
                a = next(it1)
                b = next(it2)
            except StopIteration:
                break
            names.append(trim_readno(a.name))
            s1.append(a.seq)
            q1.append(a.qual)
            s2.append(b.seq)
            q2.append(b.qual)
        if not names:
            return
        reads1, lens1 = pack_reads(s1, max_len)
        reads2, lens2 = pack_reads(s2, max_len)
        yield ReadBatch(names, s1, q1, s2, q2, reads1, lens1, reads2, lens2)


def stream_read_pairs(
    r1_path,
    r2_path,
    batch_size: int = 100_000,
    max_len: int = 512,
    prefetch: int = 2,
) -> Iterator[ReadBatch]:
    """Yield packed pair batches, parsing ahead on a reader thread."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    SENTINEL = object()
    err: List[BaseException] = []

    def worker():
        try:
            for batch in _batch_iter(r1_path, r2_path, batch_size, max_len):
                q.put(batch)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is SENTINEL:
            if err:
                raise err[0]
            return
        yield item
