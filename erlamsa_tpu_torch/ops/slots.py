"""Slot steps for the serving engines (erlamsa_tpu/ops/slots.py; here
torch code on the engine's device).

Continuous batching applied to fuzzing: the device holds a SLOT ARRAY, a
paged arena (ops/paged.py) where slot ``s`` owns a fixed run of
``row_pages`` pages, and every device step mutates all slots at once.
Free slots ride the step and are masked back to their gathered bytes by
an int32 occupancy vector, so the step's shape never changes while
requests join and leave.

PRNG contract: a request's bytes are a pure function of
``(seed, request_id)``, derived as the flush batcher derives a sample's
stream:

    key_r    = fold_in(case_key(base, 0), rid)
    scores_r = init_scores(fold_in(fold_in(base, 999), rid), 1)[0]

so the same request id gives the same bytes whether it rides a flush
batch (make_request_step), a slot step (make_slot_step) or a batch of
one, at the same capacity and stream.

STEP_CACHE is the cache of built steps keyed by (kind, capacity class,
batch geometry, mutator-registry version, stream level, device). Torch
compiles nothing, but the first call on the card loads the kernel's
library (an nvcc build if it is missing) and uploads the constant
tables: each entry is warmed by one call when it is built, so no request
pays for that. The JAX package's buffer donation has no torch
counterpart and is not taken.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import resolve_device
from . import case_rounds, prng, round_apply
from .fused import pallas_level
from .paged import (PAGE, RESERVED_PAGES, TRASH_PAGE, gather_rows, new_arena,
                    upload_pages)
from .pipeline import fuzz_batch, make_fuzzer, resolve_priorities
from .registry import registry_version
from .scheduler import init_scores


def to_device(x, dtype, dev: torch.device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) as ``dtype`` on ``dev``. On the
    card the bytes go through pinned memory without blocking the host:
    the copy is queued on the current stream, behind every step already
    queued there, and the caller may reuse ``x`` at once (the pinned
    copy is the copy's source)."""
    t = torch.as_tensor(x, dtype=dtype)
    if dev.type != "cuda":
        return t.to(dev)
    if t.device.type == "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def request_keys(base, rids):
    """Per-request PRNG keys int64[R, 2]: ``fold_in(case_key(base, 0),
    rid)``, the flush batcher's derivation with the case counter pinned
    at 0 and the request id as the sample index."""
    ckey = prng.case_key(base, 0)
    return prng.fold_in(ckey.unsqueeze(0), rids)


def request_scores(base, rids):
    """Per-request scheduler rows int32[R, M]. Each request derives its
    OWN init_scores row from (seed, rid): slicing rows out of one
    batch-sized init would make a request's stream depend on who shared
    its batch."""
    k999 = prng.fold_in(base, 999)
    return init_scores(prng.fold_in(k999.unsqueeze(0), rids), 1)[:, 0]


def _request_fuzz(base, rids, data, lens, pri, pat_pri, flags, level):
    keys = request_keys(base, rids)
    scores = request_scores(base, rids)
    out, n_out, _scores, _meta = fuzz_batch(
        keys, data, lens, scores, pri, pat_pri, level=level, **flags)
    return out, n_out


def _priorities(dev):
    """The default mutator and pattern priorities on ``dev`` and their
    enable flags: the serving engines take no -m or -p."""
    pri, pat_pri, flags = resolve_priorities()
    return (torch.from_numpy(pri.astype(np.int64)).to(dev),
            torch.from_numpy(pat_pri.astype(np.int64)).to(dev), flags)


def make_request_step(capacity: int, batch: int, device=None, level=None):
    """Flush-mode step over a packed panel:

    step(base, rids, data, lens) -> (data' uint8[batch, capacity],
                                     lens' int32[batch]) on the device

    rids int32[batch] request ids (pad rows carry 0; their outputs are
    never read); data and lens may be numpy arrays or tensors. Scores
    derive per request inside the step, so nothing chains between
    flushes. Runs on ``cuda`` unless ``device`` says otherwise; ``level``
    picks the stream, None reads ERLAMSA_PALLAS once, here."""
    dev = resolve_device(device)
    level = pallas_level(level)
    pri, pat_pri, flags = _priorities(dev)

    def step(base, rids, data, lens):
        if tuple(data.shape) != (batch, capacity):
            raise ValueError(
                f"batch shape {tuple(data.shape)} != ({batch}, {capacity})")
        return _request_fuzz(base.to(dev), to_device(rids, torch.int64, dev),
                             to_device(data, torch.uint8, dev),
                             to_device(lens, torch.int32, dev), pri, pat_pri,
                             flags, level)

    return step


def make_slot_step(slots: int, row_pages: int, device=None, level=None):
    """Continuous-mode step over a slot arena:

    step(arena, table, base, rids, lens, occ) -> (data[S, W], lens'[S])

    Gathers every slot's row out of the paged arena, runs the mutation
    step over ALL slots at the fixed width ``W = row_pages * PAGE``, and
    masks free slots back to their gathered bytes with the int32
    occupancy vector ``occ``. The arena is read, not written: requests
    upload into it between steps, and since every op of a step and
    every upload is queued on the one current stream, an upload queued
    after a step lands after that step's gather has read."""
    dev = resolve_device(device)
    level = pallas_level(level)
    pri, pat_pri, flags = _priorities(dev)
    width = row_pages * PAGE

    def step(arena, table, base, rids, lens, occ):
        rows = gather_rows(arena, table)
        if tuple(rows.shape) != (slots, width):
            raise ValueError(f"slot panel shape {tuple(rows.shape)} != "
                             f"({slots}, {width})")
        lens = to_device(lens, torch.int32, dev)
        out, n_out = _request_fuzz(base.to(dev),
                                   to_device(rids, torch.int64, dev), rows,
                                   lens, pri, pat_pri, flags, level)
        keep = to_device(occ, torch.int32, dev) > 0
        return (torch.where(keep[:, None], out, rows),
                torch.where(keep, n_out, lens))

    return step


def slot_table(slots: int, row_pages: int) -> np.ndarray:
    """The constant int32[slots, row_pages] page table: slot ``s`` owns
    pages ``RESERVED_PAGES + s*row_pages .. + row_pages``, a fixed
    mapping uploaded once."""
    base = RESERVED_PAGES + np.arange(slots, dtype=np.int32)[:, None] * row_pages
    return base + np.arange(row_pages, dtype=np.int32)[None, :]


def arena_pages(slots: int, row_pages: int) -> int:
    return RESERVED_PAGES + slots * row_pages


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def upload_slots(arena, table_np: np.ndarray, assignments):
    """Write request payloads into their slots' page runs and return the
    arena. ``assignments`` is ``[(slot, payload bytes)]``. Every page of
    a slot is written, zero past the payload, so no byte of the slot's
    previous request survives. The index vector is pow2-padded with
    TRASH_PAGE, as in the JAX package. The write is queued on the
    current stream after the steps already there (ops/paged.py)."""
    row_pages = table_np.shape[1]
    kp = _next_pow2(len(assignments) * row_pages)
    idx = np.full(kp, TRASH_PAGE, np.int32)
    pages = np.zeros((kp, PAGE), np.uint8)
    pos = 0
    for slot, payload in assignments:
        buf = np.frombuffer(payload, np.uint8)
        pages[pos:pos + row_pages].reshape(-1)[:buf.size] = buf
        idx[pos:pos + row_pages] = table_np[slot]
        pos += row_pages
    dev = arena.device
    return upload_pages(arena, to_device(idx, torch.int64, dev),
                        to_device(pages, torch.uint8, dev))


def prepare_kernels(dev: torch.device, level: int) -> None:
    """Build (if missing) and load the stream's kernel library, and its
    constant tables, on ``dev``: a kernel that does not build fails the
    caller here. Nothing to do on the CPU or at level 0."""
    if dev.type != "cuda":
        return
    if level == 2:
        case_rounds.prepare(dev)
    elif level == 1:
        round_apply.prepare()


def _settle(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepCache:
    """Cache of built steps: one entry per (kind, capacity class, batch
    geometry, registry version, stream level, device). Entries are
    warmed when built (the kernel library and tables load, one step
    runs) and shared across engine instances, so a second tenant's
    server at the same geometry reuses them. ``compiles`` counts cache
    misses; tests hold it flat across the request path."""

    _GUARDED_BY = {"_lock": ("_steps", "compiles", "hits")}

    def __init__(self):
        self._lock = threading.Lock()
        self._steps: dict[tuple, object] = {}
        self.compiles = 0
        self.hits = 0

    def _get(self, key, build, warm):
        with self._lock:
            fn = self._steps.get(key)
            if fn is not None:
                self.hits += 1
                return fn
            fn = build()
            warm(fn)
            self._steps[key] = fn
            self.compiles += 1
            return fn

    def request_step(self, capacity: int, batch: int, device=None,
                     level=None):
        dev, level = resolve_device(device), pallas_level(level)
        key = ("request", capacity, batch, registry_version(), level,
               str(dev))

        def build():
            return make_request_step(capacity, batch, device=dev,
                                     level=level)

        def warm(step):
            prepare_kernels(dev, level)
            zero = np.zeros(batch, np.int32)
            step(prng.base_key(0), zero,
                 np.zeros((batch, capacity), np.uint8), zero)
            _settle(dev)

        return self._get(key, build, warm)

    def slot_step(self, slots: int, row_pages: int, device=None, level=None):
        dev, level = resolve_device(device), pallas_level(level)
        key = ("slot", slots, row_pages, registry_version(), level, str(dev))

        def build():
            return make_slot_step(slots, row_pages, device=dev, level=level)

        def warm(step):
            prepare_kernels(dev, level)
            arena = new_arena(arena_pages(slots, row_pages), PAGE, device=dev)
            table = to_device(slot_table(slots, row_pages), torch.int64, dev)
            arena = upload_slots(arena, slot_table(slots, row_pages), [])
            zero = np.zeros(slots, np.int32)
            step(arena, table, prng.base_key(0), zero, zero, zero)
            _settle(dev)

        return self._get(key, build, warm)

    def fuzzer_step(self, capacity: int, batch: int, device=None,
                    level=None):
        """``make_fuzzer``'s step (the bridge's FUZZ_BATCH); warming loads
        the stream's kernel library and runs no step."""
        dev, level = resolve_device(device), pallas_level(level)
        key = ("fuzzer", capacity, batch, registry_version(), level,
               str(dev))

        def build():
            return make_fuzzer(capacity, batch, device=dev, level=level)[0]

        return self._get(key, build, lambda _step: prepare_kernels(dev, level))

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._steps), "compiles": self.compiles,
                    "hits": self.hits}


#: process-wide cache: the point is sharing built steps across servers
#: and engines, so there is exactly one
STEP_CACHE = StepCache()
