"""Corpus distillation: per-seed coverage tensor + greedy set-cover.

The coverage hub (services/monitors.py) delivers per-sample edge
bitmaps; this module owns what the campaign LEARNS from them:

- ``CoverageIndex`` folds each sample's bitmap into a per-seed coverage
  tensor and the global accumulated map, answering the per-slot gating
  question "did this sample light a genuinely-new edge?" with the
  ops/coverage.py torch functions on the runner's device (the card by
  default) or their numpy oracles (host / degraded) — both bit-identical
  by the parity tests.
- ``greedy_minimize`` is the afl-cmin analogue: a greedy set-cover over
  the per-seed tensor keeps the smallest seed set whose union still
  covers every observed edge; everything else is provably subsumed and
  can be retired so store/arena stay lean at large corpus sizes.

Determinism: candidate rows are scanned in insertion (idx) order and
ties on gain break toward the earliest-inserted seed (np.argmax picks
the first maximum), so the same tensor always distills to the same
keep set. Seeds with EMPTY bitmaps are never retired — no coverage
evidence ever arrived for them, which is absence of signal, not proof
of subsumption.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from .. import resolve_device
from ..ops import coverage as covops
from ..services import chaos

#: set bits of each byte value
_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                      axis=1).sum(axis=1, dtype=np.int32)


class CoverageIndex:
    """Global + per-seed edge-coverage state for one campaign.

    Single-threaded by design: folds happen only at case boundaries on
    the runner thread (the determinism contract), never from monitor
    threads — the hub buffers raw frames, the runner folds them.
    """

    def __init__(self, map_bytes: int = covops.MAP_BYTES,
                 use_device: bool = False, device=None):
        self.map_bytes = int(map_bytes)
        self.use_device = bool(use_device)
        # where use_device folds: ``cuda`` unless the caller says
        # otherwise (resolved at the first device fold)
        self.device = device
        self.global_map = np.zeros(self.map_bytes, np.uint8)
        # sid -> uint8[map_bytes], insertion-ordered (dict preserves it)
        self.per_seed: dict[str, np.ndarray] = {}
        self.folds = 0

    def fold_case(self, pairs: list[tuple[str, bytes]]) -> list[int]:
        """OR one case's maps into the tensor, slot order; returns the
        per-map genuinely-new edge counts (sequential semantics: a map
        that only repeats a lower slot's edges gains 0).

        Raises OSError under an injected ``coverage.fold`` fault — the
        runner treats the whole case as uncovered (hash-novelty
        fallback) so the fault is observable but never diverging.
        """
        chaos.fault_point("coverage.fold")
        if not pairs:
            return []
        maps = np.stack([np.frombuffer(m, np.uint8) for _, m in pairs])
        if maps.shape[1] != self.map_bytes:
            raise ValueError(
                f"coverage map width {maps.shape[1]} != {self.map_bytes}")
        if self.use_device:
            dev = resolve_device(self.device)
            gains_dev, acc_dev = covops.batch_gains(
                torch.as_tensor(self.global_map, device=dev),
                torch.as_tensor(maps, device=dev))
            gains = gains_dev.cpu().numpy()
            self.global_map = acc_dev.cpu().numpy()
        else:
            gains, self.global_map = covops.batch_gains_np(
                self.global_map, maps)
        for (sid, _), row in zip(pairs, maps):
            cur = self.per_seed.get(sid)
            self.per_seed[sid] = row.copy() if cur is None else cur | row
        self.folds += 1
        return [int(g) for g in gains]

    def fold_map(self, sid: str, frame: bytes) -> None:
        """Attribution-only OR of one raw frame (no gain computation,
        no fault point): the fleet's per-shard ledgers accrue each
        seed's map on its HOME shard through this, and the window fence
        OR-reduces the ledger globals against the gating index
        (corpus/fleet.py). Gains and admission stay with fold_case."""
        row = np.frombuffer(frame, np.uint8)
        if row.shape[0] != self.map_bytes:
            raise ValueError(
                f"coverage map width {row.shape[0]} != {self.map_bytes}")
        cur = self.per_seed.get(sid)
        self.per_seed[sid] = row.copy() if cur is None else cur | row
        self.global_map |= row

    def edges(self) -> int:
        """Total distinct edges observed so far."""
        return int(covops.popcount_np(self.global_map[None])[0])

    # --- checkpoint round-trip (services/checkpoint.py) -----------------

    def snapshot(self) -> dict:
        ids = list(self.per_seed)
        maps = (np.stack([self.per_seed[s] for s in ids])
                if ids else np.zeros((0, self.map_bytes), np.uint8))
        return {"ids": ids, "maps": maps, "global": self.global_map.copy()}

    def restore(self, snap: dict):
        self.per_seed = {
            sid: np.asarray(row, np.uint8).copy()
            for sid, row in zip(snap["ids"], snap["maps"])
        }
        self.global_map = np.asarray(snap["global"], np.uint8).copy()


def greedy_minimize(ids: list[str],
                    maps: np.ndarray) -> tuple[list[str], list[str]]:
    """Greedy set-cover over per-seed coverage rows.

    Returns (keep, retired). Every retired seed's edge set is fully
    subsumed by the union of the kept set (checked row by row, not just
    implied by the greedy loop); empty rows are always kept.
    Deterministic at fixed input: rows scanned in given order, gain
    ties break toward the earliest row.

    The picks are the JAX function's (erlamsa_tpu/corpus/distill.py),
    which rescores every candidate at every pick. Here the greedy is
    lazy: a row's gain only shrinks as the cover grows, so a stale gain
    bounds the fresh one, and a heap ordered by (gain descending, row
    ascending) — np.argmax's first maximum over the rows in order —
    rescores only the rows that reach its top. Each pick so costs a few
    row evaluations instead of one per candidate.
    """
    if len(ids) != len(maps):
        raise ValueError("ids/maps length mismatch")
    if not ids:
        return [], []
    maps = np.asarray(maps, np.uint8)
    counts = covops.popcount_np(maps)
    target = np.bitwise_or.reduce(maps, axis=0)
    covered = np.zeros_like(target)
    chosen: list[int] = []
    heap = [(-int(counts[i]), i) for i in range(len(ids)) if counts[i] > 0]
    heapq.heapify(heap)
    while heap and np.any(covered != target):
        _stale, i = heapq.heappop(heap)
        gain = int(_POP8[maps[i] & ~covered].sum())
        if heap and (-heap[0][0], -heap[0][1]) > (gain, -i):
            heapq.heappush(heap, (-gain, i))  # another row may gain more
            continue
        if gain == 0:
            break
        chosen.append(i)
        covered |= maps[i]
    keep_idx = set(chosen) | {i for i in range(len(ids)) if counts[i] == 0}
    subsumed = ~np.any(maps & ~covered, axis=1)
    retired = [ids[i] for i in range(len(ids))
               if i not in keep_idx and subsumed[i]]
    gone = set(retired)
    keep = [sid for sid in ids if sid not in gone]
    return keep, retired
