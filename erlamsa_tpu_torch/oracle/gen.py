"""Oracle input generators: priority-muxed block-stream sources.

Reference: src/erlamsa_gen.erl. A generator call returns (blocks, meta)
where blocks is a list of byte blocks with generator-chosen random sizes
(256*bs .. 4096*bs) and an occasional random padding tail.
"""

from __future__ import annotations

import os
import sys

from ..constants import MAX_BLOCK_SIZE, MIN_BLOCK_SIZE
from ..utils.erlrand import ErlRand
from .mutations import Ctx


def _finish(r: ErlRand, total_len: int) -> list[bytes]:
    """1/(len+1) chance of a random padding tail (erlamsa_gen.erl:42-51)."""
    n = r.rand(total_len + 1)
    if n == total_len:
        bits = r.rand_range(1, 16)
        nlen = r.rand(1 << bits)
        block = bytes(r.random_numbers(256, nlen))
        return [] if block == b"" else [block]
    return []


def rand_block_size(r: ErlRand, block_scale: float) -> int:
    """(erlamsa_gen.erl:54-56)."""
    return max(r.rand(round(MAX_BLOCK_SIZE * block_scale)),
               round(MIN_BLOCK_SIZE * block_scale))


def _lazy_stream(ctx: Ctx, data: bytes, block_scale: float):
    """One-shot lazy stream mirroring port_stream (erlamsa_gen.erl:59-88):
    the returned thunk, when FORCED (by the pattern's uncons, i.e. after
    the pattern-choice and Ip draws), materializes the whole block list —
    the reference's stream_port recursion is eager after the first force.
    The next block size is drawn before each read, so exact-boundary data
    consumes one trailing size draw before EOF; draws land on whatever
    stream ctx.r is bound to at forcing time (the per-case worker stream)."""

    def force() -> list[bytes]:
        r = ctx.r
        blocks: list[bytes] = []
        i = 0
        while True:
            want = rand_block_size(r, block_scale)
            chunk = data[i : i + want]
            i += len(chunk)
            if len(chunk) == want:
                blocks.append(chunk)
                continue
            if chunk:
                blocks.append(chunk)
            return blocks + _finish(r, len(data))

    return force


def _force_all(ll) -> list[bytes]:
    """forcell (erlamsa_utils.erl:108-111): materialize a lazy chain."""
    out = []
    while callable(ll):
        ll = ll()
    for x in ll:
        while callable(x):
            x = x()
        if isinstance(x, (bytes, bytearray)):
            out.append(bytes(x))
        else:
            out.extend(_force_all(x))
    return out


def stdin_generator(ctx: Ctx, online: bool, block_scale: float):
    """stdin source (erlamsa_gen.erl:91-102): single-case runs keep the
    stream lazy (block draws land on the worker stream); multi-case runs
    force it ONCE at construction on the parent stream and reuse it."""
    data = sys.stdin.buffer.read()
    if online:
        def gen():
            return _lazy_stream(ctx, data, block_scale), ("generator", "stdin")
        return gen
    blocks = _force_all(_lazy_stream(ctx, data, block_scale))

    def gen():
        return list(blocks), ("generator", "stdin")

    return gen


def file_generator(ctx: Ctx, paths: list[str], block_scale: float):
    """Pick a random path per case; blocks stay lazy
    (erlamsa_gen.erl:105-121)."""

    def gen():
        p = ctx.r.erand(len(paths))
        with open(paths[p - 1], "rb") as f:
            data = f.read()
        return _lazy_stream(ctx, data, block_scale), [
            ("generator", "file"), ("source", "path")
        ]

    return gen


def jump_generator(ctx: Ctx, paths: list[str], block_scale: float):
    """Splice random spans of two random files; the splice itself is a
    thunk forced under the pattern walk (erlamsa_gen.erl:123-150)."""

    def gen():
        r = ctx.r
        p1 = r.rand_elem(paths)
        p2 = r.rand_elem(paths)
        with open(p1, "rb") as f:
            d1r = f.read()
        with open(p2, "rb") as f:
            d2r = f.read()
        ll1 = _lazy_stream(ctx, d1r, block_scale)
        ll2 = _lazy_stream(ctx, d2r, block_scale)

        def thunk():
            # interleaved like jump_somewhere (erlamsa_gen.erl:123-132):
            # force stream 1, pick from it, THEN force stream 2
            b1 = _force_all(ll1)
            data1 = r.rand_elem(b1) if b1 else b""
            b2 = _force_all(ll2)
            data2 = r.rand_elem(b2) if b2 else b""
            s1 = r.rand(len(data1))
            s2 = r.rand(len(data2))
            l1 = r.erand(len(data1) - s1)
            l2 = r.erand(len(data2) - s2)
            return [data1[s1 : s1 + l1] + data2[s2 : s2 + l2]]

        return thunk, [("generator", "jump"), ("source", "path")]

    return gen


def direct_generator(ctx: Ctx, data: bytes, block_scale: float):
    """Library-call input. The reference's split_binary guard compares
    byte_size(Bin) against byte_size(Wanted-integer), which always fails, so
    direct input is never block-split — kept for parity
    (erlamsa_gen.erl:152-164)."""

    def gen():
        _ = rand_block_size(ctx.r, block_scale)  # drawn then unused, as in ref
        return [data] + _finish(ctx.r, len(data)), ("generator", "direct")

    return gen


def random_generator(ctx: Ctx, block_scale: float):
    """Endless-ish random blocks (erlamsa_gen.erl:167-183)."""

    def gen():
        r = ctx.r
        blocks = []
        while True:
            n = r.rand_range(32, round(MAX_BLOCK_SIZE * block_scale))
            blocks.append(r.random_block(n))
            ip = r.rand_range(1, 100)
            if r.rand(ip) == 0:
                return blocks, ("generator", "random")

    return gen


GENERATOR_INFO = [
    ("random", 1, "generate random data"),
    ("jump", 100, "jump between multiple files"),
    ("direct", 500, "read data directly from function call arguments"),
    ("file", 1000, "read data from given files"),
    ("genfuz", 10000, "generational-based fuzzer using supplied grammar"),
    ("stdin", 100000, "read data from standard input"),
]


def default_generators() -> list[tuple[str, int]]:
    return [(name, pri) for name, pri, _d in GENERATOR_INFO]


def make_generator(ctx: Ctx, pris: list[tuple[str, int]], paths, opts, n_cases: int):
    """Filter applicable sources, then one priority draw selects the
    generator for the whole run (erlamsa_gen.erl:193-247)."""
    inp = opts.get("input")
    block_scale = opts.get("blockscale", 1.0)
    external = opts.get("external_generator")
    candidates = []
    for name, pri in pris:
        if name == "stdin" and paths and paths[0] == "-" and external is None:
            candidates.append(
                (pri, name, stdin_generator(ctx, n_cases == 1, block_scale))
            )
        elif name == "file" and paths and paths != ["-"] and paths != ["direct"]:
            fpaths = _expand_paths(paths) if opts.get("recursive") else list(paths)
            candidates.append((pri, name, file_generator(ctx, fpaths, block_scale)))
        elif name == "jump" and len(paths) > 1:
            fpaths = _expand_paths(paths) if opts.get("recursive") else list(paths)
            candidates.append((pri, name, jump_generator(ctx, fpaths, block_scale)))
        elif name == "direct" and inp is not None:
            candidates.append((pri, name, direct_generator(ctx, inp, block_scale)))
        elif name == "random":
            candidates.append((pri, name, random_generator(ctx, block_scale)))
        elif name == "genfuz" and external is not None:
            candidates.append((pri, name, external))
        elif name == "genfuz" and opts.get("gen_grammar") is not None:
            # --gen without an external module: the parsed grammar fills
            # the reference's genfuz slot through the sequential ErlRand
            # path (models/genfuzz.make_external_generator); the batched
            # counter-keyed path lives in gen/ + ops/grammar.py
            from ..models.genfuzz import make_external_generator

            candidates.append((pri, name, make_external_generator(
                opts["gen_grammar"], seed=opts.get("seed"))))
    if not candidates:
        raise ValueError("No generators!")
    if len(candidates) == 1:
        return candidates[0][1], candidates[0][2]
    srt = sorted(candidates, key=lambda c: -c[0])
    total = sum(c[0] for c in srt)
    n = ctx.r.rand(total)
    for pri, name, gen in srt:
        if n < pri or (pri == 0 and n == 0):
            return name, gen
        n -= pri
    return srt[-1][1], srt[-1][2]


def _expand_paths(paths: list[str]) -> list[str]:
    """Recursive directory walk (erlamsa_utils:build_recursive_paths)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in files)
        else:
            out.append(p)
    return out
