"""Page stager: host column pages → device tensors, overlapped with the
kernels of the page before.

The streamed scan-aggregate and the paged probe join cut their input
into pages of ``page_rows`` rows.  The reference gets its overlap from
JAX's async dispatch (``jnp.asarray`` of block k+1 queues while block k
computes, ``tidb_tpu/executor/device_exec.py:1111-1123``); here it is
built by hand:

* every streamed column has a ring of ``slots`` (2) PRE-ALLOCATED pinned
  host buffers, for data and NULL flags, and as many device buffers;
* a page slice (RAM, or an ``np.memmap`` of a paged table) is copied
  into the pinned buffers of a free slot on the host; the tail page pads
  as ``ops/device.pad_host`` does (data 0, NULL flag True);
* a side copy stream fills the slot's device buffers with
  ``copy_(non_blocking=True)`` and records an event; the compute stream
  waits on that event, so the page's kernels start after its copy while
  the host already slices the next page;
* a slot is reused only after the event the caller records with
  :meth:`PageStager.release` once it has queued the kernels that read
  the page: the host waits on it before it overwrites the slot's pinned
  buffers or queues a copy into its device buffers.  The device buffers
  are marked used on the copy stream (``record_stream``), so the caching
  allocator never hands their memory out while a copy into them is
  pending.

Pinned allocation failures raise: the stager never falls back to
pageable memory.  On a CPU device the same ring runs with plain host
buffers and synchronous copies (the tests exercise the card's control
flow with the kernels' plain versions).

:meth:`PageStager.close` returns what the transfers cost: pages, bytes
copied host → device, host seconds spent slicing pages into the pinned
buffers, and device seconds of the copies (CUDA events on the copy
stream; 0.0 on the CPU).
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


class PageStager:
    """Stage pages of `arrays` ({key: (data, nulls)} host arrays of equal
    length) into device tensors of `page_rows` rows on `device`."""

    def __init__(self, arrays: dict, page_rows: int, device,
                 slots: int = 2):
        self.arrays = arrays
        self.page_rows = int(page_rows)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slots = slots
        self.host = []   # per slot: {key: (data, nulls)} pinned tensors
        self.dev = []    # per slot: {key: (data, nulls)} device tensors
        self._free = [None] * slots  # event: compute done with the slot
        self._timing = []  # (start, end) copy events per page
        self.pages = 0
        self.bytes = 0
        self.host_s = 0.0
        self._k = 0
        self.copy_stream = (torch.cuda.Stream(self.device) if self.cuda
                            else None)
        for _s in range(slots):
            h, d = {}, {}
            for key, (data, nulls) in arrays.items():
                dt = _torch_dtype(np.asarray(data[:0]).dtype)
                pair_h = (torch.empty(self.page_rows, dtype=dt,
                                      pin_memory=self.cuda),
                          torch.empty(self.page_rows, dtype=torch.bool,
                                      pin_memory=self.cuda))
                pair_d = tuple(torch.empty(self.page_rows, dtype=t.dtype,
                                           device=self.device)
                               for t in pair_h)
                if self.cuda:
                    for t in pair_d:
                        t.record_stream(self.copy_stream)
                h[key], d[key] = pair_h, pair_d
            self.host.append(h)
            self.dev.append(d)

    def stage(self, lo: int, hi: int):
        """Rows [lo, hi) of every array as device tensors of `page_rows`
        rows, ready on the current stream.  Returns (env, slot): env maps
        each key to its (data, nulls) pair; hand `slot` to
        :meth:`release` once the page's kernels are queued."""
        m = hi - lo
        if not 0 < m <= self.page_rows:
            raise ValueError(f"page of {m} rows (page_rows "
                             f"{self.page_rows})")
        s = self._k % self.slots
        self._k += 1
        if self._free[s] is not None:
            # the kernels that read this slot's last page are done, and
            # so is its copy (they waited on it)
            self._free[s].synchronize()
            self._free[s] = None
        t0 = time.perf_counter()
        for key, (data, nulls) in self.arrays.items():
            hd, hn = self.host[s][key]
            vd, vn = hd.numpy(), hn.numpy()
            np.copyto(vd[:m], data[lo:hi], casting="no")
            np.copyto(vn[:m], nulls[lo:hi], casting="no")
            if m < self.page_rows:
                vd[m:] = 0
                vn[m:] = True
            self.bytes += hd.numel() * hd.element_size() + hn.numel()
        self.host_s += time.perf_counter() - t0
        if self.cuda:
            compute = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(self.copy_stream):
                start.record()
                for key, (hd, hn) in self.host[s].items():
                    dd, dn = self.dev[s][key]
                    dd.copy_(hd, non_blocking=True)
                    dn.copy_(hn, non_blocking=True)
                end.record()
            compute.wait_event(end)
            self._timing.append((start, end))
        else:
            for key, (hd, hn) in self.host[s].items():
                dd, dn = self.dev[s][key]
                dd.copy_(hd)
                dn.copy_(hn)
        self.pages += 1
        return dict(self.dev[s]), s

    def release(self, slot: int):
        """Mark `slot` reusable once the work queued so far on the current
        stream (the page's kernels) is done."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._free[slot] = ev

    def close(self) -> dict:
        """Wait for every copy, free the buffers, and return the
        transfer statistics."""
        h2d_s = 0.0
        if self.cuda:
            self.copy_stream.synchronize()
            h2d_s = sum(a.elapsed_time(b) for a, b in self._timing) / 1e3
        self.host, self.dev, self._timing = [], [], []
        self._free = [None] * self.slots
        return {"pages": self.pages, "h2d_bytes": self.bytes,
                "slice_s": self.host_s, "h2d_s": h2d_s}
