"""Device edge-coverage tensors: uint8 bitmap OR-fold and popcount
(erlamsa_tpu/ops/coverage.py, as torch code on the caller's device).

AFL-style edge bitmaps arrive from the monitor plane as per-sample uint8
maps (1 bit per edge). Every feedback decision — "did this sample light a
genuinely-new edge?" — reduces to bitmap OR plus popcount: a per-map
popcount (the map leg) and an OR along the sample axis (the reduce leg).

torch has no OR reduction and no OR scan, so the reduce is a halving tree
and the inclusive scan a doubling (Hillis–Steele) scan: ceil(log2 N)
shifted ORs, each exact. The popcount stays in uint8 lanes (SWAR) and
sums into int32, as the JAX functions do.

The ``*_np`` twins are the numpy oracles and the byte-identity ground
truth: the torch functions must match them bit for bit, and degraded
campaigns (device lost, or coverage folded on a host-only path) run the
oracles directly.

Gain semantics are SEQUENTIAL within a batch: map i's genuinely-new edges
are counted against the accumulated map OR'd with every earlier map in
the batch, so a slot that merely repeats the edges a lower slot just lit
scores zero. That makes the per-slot adoption gate order-stable and
independent of how many maps share one batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import COVERAGE_MAP_BYTES

#: default edge-bitmap width in bytes (8 edges per byte)
MAP_BYTES = COVERAGE_MAP_BYTES


# ---------------------------------------------------------------- numpy

def popcount_np(maps: np.ndarray) -> np.ndarray:
    """int32[...]: set-bit count over the trailing byte axis."""
    m = np.ascontiguousarray(maps, dtype=np.uint8)
    return np.unpackbits(m, axis=-1).sum(axis=-1, dtype=np.int32)


def fold_maps_np(acc: np.ndarray, maps: np.ndarray) -> np.ndarray:
    """uint8[B]: acc OR'd with every row of maps[N, B]."""
    out = np.asarray(acc, np.uint8).copy()
    for row in np.asarray(maps, np.uint8):
        out |= row
    return out


def batch_gains_np(acc: np.ndarray,
                   maps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(gains int32[N], new_acc uint8[B]) — sequential new-edge counts.

    gains[i] = popcount(maps[i] & ~(acc | maps[0] | .. | maps[i-1])).
    """
    cur = np.asarray(acc, np.uint8).copy()
    gains = np.empty(len(maps), np.int32)
    for i, row in enumerate(np.asarray(maps, np.uint8)):
        gains[i] = popcount_np((row & ~cur)[None])[0]
        cur |= row
    return gains, cur


# ---------------------------------------------------------------- torch

def _u8(x, device=None) -> torch.Tensor:
    """A uint8 tensor of ``x`` (a tensor keeps its device unless one is
    given; numpy lands on ``device`` or the CPU)."""
    return torch.as_tensor(x, dtype=torch.uint8, device=device)


def popcount(maps) -> torch.Tensor:
    """int32[...]: per-map popcount — SWAR bit-twiddling in uint8 lanes
    (every step keeps uint8), summed into int32."""
    x = _u8(maps)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(dim=-1, dtype=torch.int32)


def _or_reduce(maps: torch.Tensor) -> torch.Tensor:
    """uint8[B]: OR of every row of maps[N, B] (N >= 1), a halving tree."""
    x = maps
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        top = x[:half] | x[half:2 * half]
        x = torch.cat([top, x[2 * half:]]) if x.shape[0] % 2 else top
    return x[0]


def fold_maps(acc, maps) -> torch.Tensor:
    """uint8[B]: acc OR every row of maps[N, B] (the reduce leg), on
    ``acc``'s device."""
    acc = _u8(acc)
    maps = _u8(maps, acc.device)
    if maps.shape[0] == 0:
        return acc.clone()
    return acc | _or_reduce(maps)


def _or_scan(maps: torch.Tensor) -> torch.Tensor:
    """uint8[N, B]: inclusive OR scan along the rows, ceil(log2 N)
    doubling steps (Hillis–Steele), each out of place."""
    x = maps
    shift = 1
    while shift < x.shape[0]:
        x = torch.cat([x[:shift], x[shift:] | x[:-shift]])
        shift *= 2
    return x


def batch_gains(acc, maps) -> tuple[torch.Tensor, torch.Tensor]:
    """(gains int32[N], new_acc uint8[B]) — the torch twin of
    ``batch_gains_np`` on ``acc``'s device: an inclusive OR scan gives
    each map the union of its predecessors, the popcount scores what is
    left."""
    acc = _u8(acc)
    maps = _u8(maps, acc.device)
    if maps.shape[0] == 0:
        return (torch.zeros(0, dtype=torch.int32, device=acc.device),
                acc.clone())
    pref = _or_scan(maps)
    before = torch.cat([torch.zeros_like(acc)[None], pref[:-1]]) | acc
    return popcount(maps & ~before), pref[-1] | acc
