#!/usr/bin/env python3
"""Smoke test of erlamsa_tpu_torch on one NVIDIA GPU (the port's quickest
proof that it still starts and computes the right bytes on the card).

Phases, each fatal on failure:
  1. build   compile the three CUDA kernels (erlamsa_tpu_torch/csrc/
             round_apply.cu, case_rounds.cu, randmask.cu) for sm_90a from
             the checkout's sources, one nvcc each, all at once; print
             ptxas's registers, spills and shared memory per kernel and
             the CTAs per SM at the main path's row width; count the
             instructions of one threefry word in the SASS of a probe
             kernel built from the mask kernel's threefry code, by pipe
             (integer ALU, FMA pipe, all issued), for the operation
             bounds, and time the probe on the card: it must not run
             faster than that bound allows;
  2. kernel  hold each kernel against its plain PyTorch version on the
             card, byte for byte (tolerance 0: every function is integer):
             the round kernel over every kind and the edge programs, the
             case kernel over rows of the three corpus shapes (a quarter
             of them filled to the row end, for the wraparound) with the
             default priorities and, at L=256, each mutator forced alone,
             and the mask kernel; at L = 256, 8192, 65536 (the kernels'
             shared-memory path) and 1,000,000 (their device-memory path);
             the case kernel also with one priority at 3e8 (L = 256 and
             8192), where score x priority wraps in int32 as in the
             reference; the mask kernel also on edge rows (span ends that
             wrap in int32, inactive rows, empty spans, prob 0, 1, 100 and
             101, every op), on rows starting one byte past a 16-byte
             boundary, and at L = 17 and 4099;
  3. main    the batch fuzzer's device path (services/batchrunner.fuzz_cases,
             the device side of ``python -m erlamsa_tpu_torch``) at full
             width, once per stream: ERLAMSA_PALLAS=2 (the case kernel),
             =1 (the round kernel) and unset (the composite apply, no
             kernel). 4096 seeds of 2-4 KB (capacity class 8192) mixing
             text, length-prefixed and binary, 4 cases with scores
             carried. Each path's kernel must have launched (the case
             kernel once per case), lengths fit, padding is zero, a second
             run gives the same bytes, and 64 rows equal the CPU plain
             path through make_class_fuzzer;
  4. full    the same corpus through services/batchrunner.hybrid_cases
             (``python -m erlamsa_tpu_torch`` with no -m: the 41-code
             default set, rows the hybrid dispatcher routes to the host
             oracle on its process pool), 4 cases, under ERLAMSA_PALLAS=2
             and unset: samples/s, the host-routed share, overflow and
             abandoned counts, host-wait against device seconds; the case
             kernel must launch once per case at level 2;
  5. mixed   a 256-row corpus (one row each of XML, JSON, zip, gzip,
             base64 and a URI, the rest small seeds of the three shapes)
             through the full set for 3 cases on the card and on the CPU,
             in both streams: every row's bytes equal, at least one row
             host-routed, none abandoned.

Then it times each kernel at the main path's shape beside its plain
version and its bound: ``ms`` is device time, CUDA events around replays
of a CUDA graph that holds 20 launches (the host's per-call work left
out), and the wrapper's per-call time (events around back-to-back calls)
is printed beside it. It prints samples/s for each stream, the card's
name and power limit, one JSON line describing the kernels, and as the
last line {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py [--seed N] [--profile] [--compare DIR ...]

--profile   trace one level-2 case at the main path's shape under
            torch.profiler (CPU and CUDA): the ten largest device ops,
            the device's idle share, the case kernel's share of the case.
--compare   each DIR holds another checkout of the repository (for
            example the parent commit, from git archive): build its three
            kernels, check their bytes equal these, and time them against
            this checkout's in turns (theirs, ours, ours, theirs) on the
            inputs they are timed on here, each beside its bound;
            with --profile, trace a level-2 case with the first DIR's case
            kernel too; then time the default (composite) stream's device
            path of DIR and of this checkout, in the same turns.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SMS, CLOCK_HZ = 132, 1.98e9  # H100 SXM: SMs, boost clock
# lane-instructions per clock per SM (CUDA C++ Programming Guide's
# arithmetic throughput table, compute capability 9.0): the integer ALU
# (3-input add, bitwise, shift, compare) 64, the FMA pipe's integer
# multiply-add (IMAD, which nvcc also emits for adds and moves) 64, and the
# issue of any instruction, one warp per clock on each of the 4
# sub-partitions, 128
ALU_RATE, FMA_RATE, ISSUE_RATE = 64, 64, 128
# opcodes that issue to the integer ALU alone. VIADD (sm_90's add with an
# immediate) is left out: its pipe is not documented, and the probe below,
# whose words carry VIADDs, runs faster than counting it as ALU would
# allow; it counts among all instructions
INT_PIPE = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA",
            "PRMT", "SEL", "ISETP", "IMNMX", "IABS"}
# the threefry word the mask kernel draws (erl::Threefry::word, high
# counter word 0) under a key held in registers, N words a loop step; the
# round and case kernels compute the same words through erl::threefry_word
THREEFRY_PROBE = r"""
#include <cuda_runtime.h>
#include "threefry.cuh"
template <int N>
__device__ void words(uint32_t k0, uint32_t k1, uint32_t* out, int steps) {
  const erl::Threefry tf(k0, k1);
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc ^= tf.word(0u, (i * steps + t) * N + j);
  }
  out[i] = acc;
}
extern "C" __global__ void words4(uint32_t k0, uint32_t k1, uint32_t* o,
                                  int steps) {
  words<4>(k0, k1, o, steps);
}
extern "C" __global__ void words8(uint32_t k0, uint32_t k1, uint32_t* o,
                                  int steps) {
  words<8>(k0, k1, o, steps);
}
extern "C" int words8_launch(int blocks, int threads, void* out, int steps,
                             void* stream) {
  words8<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      0x2Au, 0x1234567u, (uint32_t*)out, steps);
  return (int)cudaGetLastError();
}
"""
PROBE_CTAS_PER_SM, PROBE_THREADS, PROBE_STEPS = 16, 256, 64
BATCH = 4096  # seeds, one capacity class (BASELINE.json configs[2])
CASES = 4
CHECK_ROWS = 64  # rows held against the CPU plain path
# (L, B): the kernels' shared-memory path up to 65536, device memory above
KERNEL_SIZES = ((256, 256), (8192, 256), (65536, 32), (1000000, 4))
MASK_EDGE_SIZES = ((17, 64), (4099, 32))  # (L, B), the mask kernel alone
GRAPH_LAUNCHES = 20  # launches per CUDA graph when timing a kernel
M = 31  # device mutators
BIG_PRI = 300_000_000  # x a score of 8-10 passes 2^31: the int32 bound wraps
MIXED_ROWS, MIXED_CASES = 256, 3  # the CUDA == CPU run of the full set
COMPARE_CASES = 2  # cases of each composite run --compare times
STREAMS = ((2, "case kernel"), (1, "round kernel"), (0, "composite"))


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + what)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + res.stderr)
    return res.stdout.strip().splitlines()[0]


def programs(rng, B, L):
    """Seeded round programs: every kind (K_NONE included), repeated spans
    and literals, span sources that wrap modulo L, literal offsets past
    the 48-byte scratch row, windows ending at the row end."""
    P = np.zeros((B, 16), np.int32)
    P[:, 0] = np.arange(B) % 6  # kind
    P[:, 15] = rng.integers(0, L + 1, B)  # n
    P[:, 1] = rng.integers(0, L + 1, B)  # pos
    P[:, 2] = rng.integers(0, L // 4 + 1, B)  # drop
    P[:, 3] = rng.integers(0, 3, B)  # src
    P[:, 4] = rng.integers(-L, 2 * L, B)  # src_start (wraps)
    P[:, 5] = rng.integers(0, 64, B)  # src_len
    P[:, 6] = rng.integers(0, 600, B)  # reps
    P[:, 7] = rng.integers(0, 80, B)  # lit_len (>= 48 reads 0)
    P[:, 8] = rng.integers(0, L, B)  # a1
    P[:, 9] = rng.integers(0, L // 2, B)  # l1
    P[:, 10] = rng.integers(0, L // 2, B)  # l2
    P[:, 11] = rng.integers(0, L, B)  # ps
    P[:, 12] = rng.integers(1, 300, B)  # pl
    P[:, 13] = rng.integers(0, 4, B)  # mask_op
    P[:, 14] = rng.integers(1, 101, B)  # mask_prob
    end = rng.random(B) < 0.25  # ps + span at the row end
    P[end, 11] = L - np.minimum(P[end, 12], 256)
    return P


def seed_bytes(rng, i, n):
    """One seed of n bytes in shape i % 3 (bin/gen_device_goldens.py):
    numbered text lines, a length-prefixed blob, raw binary."""
    kind = i % 3
    if kind == 0:
        line = b"golden text sample %04d value=%d (tree) [x]\n" % (
            i, int(rng.integers(1 << 40)))
        return (line * (n // len(line) + 1))[:n]
    if kind == 1:
        blob = bytes(rng.integers(33, 127, max(n - 4, 0), dtype=np.uint8))
        return (b"HD" + min(len(blob), 0xFFFF).to_bytes(2, "big") + blob)[:n]
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


def make_corpus(rng, count):
    """Seeds of 2049-4096 bytes (class 8192) in the three shapes."""
    return [seed_bytes(rng, i, int(rng.integers(2049, 4097)))
            for i in range(count)]


def case_inputs(rng, B, L, dev):
    """Seeded case_rounds operands: rows of the three shapes, a quarter
    filled to the row end; random keys and scores; rounds up to 16."""
    import torch

    data = np.zeros((B, L), np.uint8)
    n = np.empty(B, np.int32)
    for b in range(B):
        ln = L if b % 4 == 0 else int(rng.integers(0, L + 1))
        row = seed_bytes(rng, b, ln)
        data[b, :len(row)] = np.frombuffer(row, np.uint8)
        n[b] = len(row)
    rounds = rng.integers(0, 17, B).astype(np.int32)
    rounds[: B // 2] = 16
    host = (rng.integers(0, 2**32, (B, 2), dtype=np.int64), data, n,
            rng.integers(2, 11, (B, M)).astype(np.int32), rounds)
    return [torch.from_numpy(x).to(dev) for x in host]


def cuda_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, launches=GRAPH_LAUNCHES, replays=5):
    """Device time per call of fn: CUDA events around replays of a CUDA
    graph that holds ``launches`` calls, so the host's per-call work
    (operand checks, the ctypes call) stays out. Warmed up outside the
    capture (builds, constant tables copied to the card on first use)."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (replays * launches)
    del g
    return ms


def max_err(got, want) -> int:
    """Largest absolute difference over tensors or tuples of tensors."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def threefry_ops(build_dir, csrc):
    """Instructions per threefry word in the SASS nvcc emits for sm_90a
    (csrc/threefry.cuh), by pipe: the opcode counts of the probe's 8-word
    loop less those of its 4-word one, over 4, so that set-up, the key
    schedule, the loop and the store cancel. Returns ({"alu", "fma",
    "all"}: per word, {opcode: per word}, the probe's library)."""
    from erlamsa_tpu_torch.ops import cuda_build

    src = os.path.join(build_dir, "threefry_probe.cu")
    lib = os.path.join(build_dir, "threefry_probe.so")
    with open(src, "w") as f:
        f.write(THREEFRY_PROBE)
    subprocess.run([cuda_build.toolkit(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", lib,
                    src], check=True, capture_output=True, timeout=300)
    sass = subprocess.run([cuda_build.toolkit("cuobjdump"), "-sass", lib],
                          check=True, capture_output=True, text=True,
                          timeout=120).stdout
    hist, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = hist.setdefault(m.group(1), {})
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and fn is not None:
            fn[m.group(1)] = fn.get(m.group(1), 0) + 1
    check({"words4", "words8"} <= set(hist), "no probe kernels in the SASS")
    per = {op: (hist["words8"].get(op, 0) - hist["words4"].get(op, 0)) / 4
           for op in set(hist["words8"]) | set(hist["words4"])}
    per = {op: v for op, v in sorted(per.items()) if v}
    pipes = {"alu": sum(v for op, v in per.items() if op in INT_PIPE),
             "fma": sum(v for op, v in per.items() if op.startswith("IMAD")),
             "all": sum(per.values())}
    return pipes, per, lib


def probe_clocks(lib) -> float:
    """SM clocks per threefry word that the probe takes on the card, every
    SM full (CUDA events around 20 launches of its 8-word loop)."""
    import ctypes

    import torch

    fn = ctypes.CDLL(lib).words8_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = SMS * PROBE_CTAS_PER_SM
    out = torch.empty(blocks * PROBE_THREADS, dtype=torch.int32,
                      device="cuda")

    def launch():
        rc = fn(blocks, PROBE_THREADS, out.data_ptr(), PROBE_STEPS,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"threefry probe launch failed (cuda error {rc})")

    ms = cuda_ms(launch, 20)
    return ms * 1e-3 * SMS * CLOCK_HZ / (out.numel() * PROBE_STEPS * 8)


def word_clocks(pipes):
    """SM clocks per threefry word per lane: the busiest of the integer
    ALU, the FMA pipe and the issue slots."""
    return max(pipes["alu"] / ALU_RATE, pipes["fma"] / FMA_RATE,
               pipes["all"] / ISSUE_RATE)


def bound(moved_bytes, words, pipes):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth
    and the threefry words' instructions over the busiest pipe's rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = words * word_clocks(pipes) / (SMS * CLOCK_HZ)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernels_vs_plain(rng, dev):
    """Phase 2: every kernel against its plain version. Returns the
    largest error per kernel."""
    import torch

    from erlamsa_tpu_torch.ops import case_rounds as cr
    from erlamsa_tpu_torch.ops import randmask as rm
    from erlamsa_tpu_torch.ops import round_apply as ra
    from erlamsa_tpu_torch.ops.registry import DEFAULT_DEVICE_PRI

    errs = {"round_apply": 0, "case_rounds": 0, "randmask": 0}
    default_pri = torch.tensor(DEFAULT_DEVICE_PRI, dtype=torch.int32,
                               device=dev)
    for L, B in KERNEL_SIZES:
        host = [
            torch.from_numpy(rng.integers(0, 2**32, (B, 2), dtype=np.int64)),
            torch.from_numpy(programs(rng, B, L)),
            torch.from_numpy(rng.integers(0, 256, (B, ra.SCRATCH),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, (B, L), dtype=np.uint8)),
        ]
        ops = [x.to(dev) for x in host]
        got = ra.round_apply(*ops)
        torch.cuda.synchronize()
        err = max_err(got, ra.round_apply_plain(*ops))
        errs["round_apply"] = max(errs["round_apply"], err)
        print(f"kernel-vs-plain round_apply: L={L} B={B} "
              f"path={ra.path(L)} max_abs_err={err}")
        check(err == 0, f"round kernel != plain at L={L}")

        keys, data, n, scores, rounds = case_inputs(rng, B, L, dev)
        pris = [default_pri]
        if L == 256:  # each mutator forced alone, on a quarter of the rows
            for m in range(M):
                v = torch.zeros(M, dtype=torch.int32, device=dev)
                v[m] = 1
                pris.append(v)
        if L in (256, 8192):  # one priority at 3e8: score x pri wraps
            big = default_pri.clone()
            big[int(rng.integers(M))] = BIG_PRI
            pris.append(big)
        applied = set()
        for j, pri in enumerate(pris):
            rows = slice(None) if j == 0 else slice(0, B // 4)
            args = (keys[rows], data[rows], n[rows], scores[rows], pri,
                    rounds[rows])
            got = cr.case_rounds(*args)
            torch.cuda.synchronize()
            err = max_err(got, cr.case_rounds_plain(*args))
            errs["case_rounds"] = max(errs["case_rounds"], err)
            check(err == 0, f"case kernel != plain at L={L}, pri {j}")
            applied |= set(got[3].flatten().tolist())
        print(f"kernel-vs-plain case_rounds: L={L} B={B} path={ra.path(L)} "
              f"priority vectors={len(pris)} mutators applied="
              f"{len(applied - {-1})} max_abs_err={errs['case_rounds']}")

        err = mask_vs_plain(rng, B, L, dev)
        errs["randmask"] = max(errs["randmask"], err)
        check(err == 0, f"mask kernel != plain at L={L}")
    for L, B in MASK_EDGE_SIZES:  # widths that are not a multiple of 16
        err = mask_vs_plain(np.random.default_rng(L), B, L, dev)
        errs["randmask"] = max(errs["randmask"], err)
        check(err == 0, f"mask kernel != plain at L={L}")
    return errs


def mask_edges(L):
    """(s, l, op, prob, active) rows at the mask kernel's edges: span ends
    that wrap in int32 (negative, to a large positive) or sit at 2^31 - 1,
    an inactive row, empty spans (l = 0, l < 0), prob 0, 1, 100 and 101,
    ops 3, 4 and -1 (replace)."""
    return [(5, 2**31 - 2, 2, 100, 1), (-2**31 + 5, -10, 2, 100, 1),
            (3, 2**31 - 4, 3, 100, 1), (4, 2**31 - 4, 3, 100, 1),
            (0, L, 2, 100, 0), (L // 3, 0, 2, 100, 1), (L // 2, -5, 4, 100, 1),
            (0, L, 0, 0, 1), (0, L, 1, 1, 1), (0, L, 2, 100, 1),
            (0, L, 3, 101, 1), (1, L, 4, 50, 1), (1, L - 2, -1, 50, 1)]


def mask_vs_plain(rng, B, L, dev) -> int:
    """The mask kernel against its plain version on B seeded rows and the
    edge rows, with the rows 16-byte aligned and starting one byte past a
    boundary, and randmask_single on one row. The edge rows draw from a
    generator of their own, so that ``rng`` (and the corpus drawn from it
    later) runs as before they were added. Returns the largest error."""
    import torch

    from erlamsa_tpu_torch.ops import randmask as rm

    seeds = rng.integers(-2**31, 2**31, B)
    params = np.stack([rng.integers(-8, L, B), rng.integers(0, L + 8, B),
                       rng.integers(0, 5, B), rng.integers(0, 102, B),
                       rng.integers(0, 4, B) > 0], 1)
    data = rng.integers(0, 256, (B, L), dtype=np.uint8)
    key = torch.from_numpy(rng.integers(0, 2**32, 2, dtype=np.int64)).to(dev)
    erng = np.random.default_rng(L)
    edges = np.asarray(mask_edges(L))
    R = B + len(edges)
    seeds = torch.from_numpy(np.concatenate([
        seeds, erng.integers(-2**31, 2**31, len(edges))])
        .astype(np.int32)).to(dev)
    params = torch.from_numpy(np.concatenate([params, edges])
                              .astype(np.int32)).to(dev)
    buf = np.empty(R * L + 1, np.uint8)
    buf[:B * L] = data.reshape(-1)
    buf[B * L:] = erng.integers(0, 256, len(edges) * L + 1, dtype=np.uint8)
    buf = torch.from_numpy(buf).to(dev)
    data, unaligned = buf[:-1].view(R, L), buf[1:].view(R, L)
    keys = rm.seed_keys(seeds)
    got = rm.randmask(seeds, params, data)
    got_u = rm.randmask_keys(keys, params, unaligned)
    one = rm.randmask_single(key, params[0], data[0])
    torch.cuda.synchronize()
    err = max(max_err(got, rm.randmask_plain(keys, params, data)),
              max_err(got_u, rm.randmask_plain(keys, params, unaligned)),
              max_err(one, rm.randmask_plain(key[None], params[:1],
                                             data[:1])[0]))
    print(f"kernel-vs-plain randmask: L={L} B={B} + {len(edges)} edge rows, "
          f"aligned and at a 1-byte offset, max_abs_err={err}")
    return err


def counts():
    from erlamsa_tpu_torch.ops import case_rounds as cr
    from erlamsa_tpu_torch.ops import randmask as rm
    from erlamsa_tpu_torch.ops import round_apply as ra

    return {"round_apply": ra.launches, "case_rounds": cr.launches,
            "randmask": rm.launches}


def reset_counts():
    from erlamsa_tpu_torch.ops import case_rounds as cr
    from erlamsa_tpu_torch.ops import randmask as rm
    from erlamsa_tpu_torch.ops import round_apply as ra

    for mod in (ra, cr, rm):
        mod.reset_launches()


def main_path(level, corpus, seed3, dev):
    """Phase 3 for one stream: two full runs through fuzz_cases, the
    launch counts of the first, its checks and the CPU comparison.
    Returns (launches, samples/s first run, samples/s second run)."""
    import torch

    from erlamsa_tpu_torch.ops import prng
    from erlamsa_tpu_torch.ops.buffers import pack, scan_bound
    from erlamsa_tpu_torch.ops.pipeline import make_class_fuzzer
    from erlamsa_tpu_torch.ops.scheduler import init_scores
    from erlamsa_tpu_torch.services.batchrunner import fuzz_cases

    def drive():
        outs = [per_class for _case, per_class in
                fuzz_cases(corpus, seed3, None, CASES, dev, level=level)]
        torch.cuda.synchronize()
        return outs

    reset_counts()
    t = time.perf_counter()
    run1 = drive()
    cold_s = time.perf_counter() - t
    launches = counts()
    t = time.perf_counter()
    run2 = drive()
    warm_s = time.perf_counter() - t

    check(len(run1[0]) == 1, "expected one capacity class")
    (idx_t, first_data, *_), = run1[0]
    cap = first_data.shape[1]
    check(cap == 8192, f"expected class 8192, got {cap}")
    for case in range(CASES):
        (idx, data, lens, scores, meta), = run1[case]
        (_i2, data2, lens2, scores2, meta2), = run2[case]
        check(int(lens.min()) >= 0 and int(lens.max()) <= cap,
              "a length exceeds the capacity")
        col = torch.arange(cap, device=dev)[None, :]
        check(not bool((data[col >= lens[:, None].long()] != 0).any()),
              "padding past a length is not zero")
        check(int(scores.min()) >= 2 and int(scores.max()) <= 10,
              "scores left [MIN_SCORE, MAX_SCORE]")
        for a, b in ((data, data2), (lens, lens2), (scores, scores2),
                     (meta.applied, meta2.applied)):
            check(torch.equal(a, b), "two runs differ")
        changed = sum(1 for j in range(0, len(corpus), 97)
                      if bytes(data[j, :int(lens[j])].cpu().numpy())
                      != corpus[int(idx[j])])
        check(changed > 0, "nothing was mutated")

    # CPU plain path on a subset of rows, keyed by their original indices
    rows = np.linspace(0, BATCH - 1, CHECK_ROWS).astype(np.int64)
    cpu_step = make_class_fuzzer(device="cpu", level=level)
    base = prng.base_key(seed3)
    scores = init_scores(prng.fold_in(base, 999), BATCH)[rows]
    packed = pack([corpus[i] for i in rows], capacity=cap, device="cpu")
    scan_len = scan_bound(max(len(s) for s in corpus), cap)
    pos_of = {int(i): j for j, i in enumerate(idx_t.tolist())}
    sel = torch.as_tensor([pos_of[int(i)] for i in rows], device=dev)
    t = time.perf_counter()
    for case in range(CASES):
        data, lens, scores, meta = cpu_step(
            base, case, torch.from_numpy(rows), packed.data, packed.lens,
            scores, scan_len=scan_len)
        (_idx, g_data, g_lens, g_scores, g_meta), = run1[case]
        for name, a, b in (("data", data, g_data), ("lens", lens, g_lens),
                           ("scores", scores, g_scores),
                           ("applied", meta.applied, g_meta.applied),
                           ("pattern", meta.pattern, g_meta.pattern)):
            check(torch.equal(a, b[sel].cpu()),
                  f"level {level}: cuda != cpu for {name} at case {case}")
    samples = BATCH * CASES
    print(f"main path ERLAMSA_PALLAS={level or 'unset'}: {BATCH} seeds x "
          f"{CASES} cases, {samples / cold_s:.1f} samples/s first run, "
          f"{samples / warm_s:.1f} samples/s second run, launches {launches}; "
          f"lengths fit, padding zero, runs identical, {len(rows)} rows x "
          f"{CASES} cases == CPU ({time.perf_counter() - t:.1f}s on the CPU)")
    return launches, samples / cold_s, samples / warm_s


def mixed_corpus(rng, count):
    """One row each of XML, JSON, zip, gzip, base64 and a URI, then seeds
    of 16-600 bytes in the three shapes of seed_bytes."""
    import base64
    import gzip
    import io
    import zipfile

    z = io.BytesIO()
    with zipfile.ZipFile(z, "w") as f:
        f.writestr("dir/a.txt", seed_bytes(rng, 0, 200))
    head = [
        b'<?xml version="1.0"?><r a="1"><i>%d</i><i/></r>\n'
        % rng.integers(1 << 30),
        b'{"k": [%d, "v", null], "o": {"x": true}}' % rng.integers(1 << 30),
        z.getvalue(),
        gzip.compress(seed_bytes(rng, 0, 300), mtime=0),
        base64.b64encode(seed_bytes(rng, 1, 120)),
        b"GET http://example.com/p?q=%d HTTP/1.1\nHost: h\n\n"
        % rng.integers(1 << 30),
    ]
    return head + [seed_bytes(rng, i, int(rng.integers(16, 601)))
                   for i in range(count - len(head))]


def full_set(level, corpus, seed3, dev):
    """Phase 4 for one stream: the whole default set (41 codes) through
    services/batchrunner.hybrid_cases, the loop behind ``python -m
    erlamsa_tpu_torch`` with no -m: device classes on the card, rows the
    dispatcher routes to the host oracle on its process pool. Returns
    (launches, samples/s, stats)."""
    import torch

    from erlamsa_tpu_torch.services.batchrunner import hybrid_cases

    stats = {}
    reset_counts()
    t = time.perf_counter()
    runs = [res for _case, res in hybrid_cases(corpus, seed3, None, CASES,
                                                dev, level=level,
                                                stats=stats)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = counts()
    check(len(runs) == CASES and all(len(r) == len(corpus) for r in runs),
          "the full set did not emit one output per row and case")
    changed = sum(out != corpus[i] for r in runs for i, out in enumerate(r))
    check(changed > 0, "the full set mutated nothing")
    check(stats["host_routed"] > 0, "the full set routed no row to the host")
    check(stats["overflow"] == 0, "a 4 KB seed overflowed the device")
    samples = len(corpus) * CASES
    share = stats["host_routed"] / samples
    print(f"full set ERLAMSA_PALLAS={level or 'unset'}: {len(corpus)} seeds "
          f"x {CASES} cases, 41 codes, {samples / dt:.1f} samples/s, "
          f"host-routed {stats['host_routed']} ({share:.4f}), overflow "
          f"{stats['overflow']}, abandoned {stats['abandoned']}, host wait "
          f"{stats['host_wait_s']:.2f}s against device {stats['device_s']:.2f}s"
          f" of {dt:.2f}s, launches {launches}, {changed} rows changed")
    return launches, samples / dt, stats


def full_set_cuda_vs_cpu(level, corpus, seed3, dev):
    """Phase 5 for one stream: the whole 256-row run of the full set on
    the card and on the CPU; every row's bytes equal, the host-routed
    ones included (routing depends on every row's scores, so whole runs
    are compared, not subsets)."""
    from erlamsa_tpu_torch.services.batchrunner import hybrid_cases

    runs, stats = {}, {}
    for d in (dev, "cpu"):
        stats[str(d)] = {}
        t = time.perf_counter()
        runs[str(d)] = [res for _case, res in hybrid_cases(
            corpus, seed3, None, MIXED_CASES, d, level=level,
            stats=stats[str(d)])]
        stats[str(d)]["s"] = time.perf_counter() - t
    g, c = stats[str(dev)], stats["cpu"]
    diff = sum(a != b for ra_, rb in zip(runs[str(dev)], runs["cpu"])
               for a, b in zip(ra_, rb))
    check(diff == 0, f"level {level}: {diff} full-set rows differ between "
          "cuda and cpu")
    check(g["host_routed"] == c["host_routed"] >= 1,
          f"level {level}: host-routed rows {g['host_routed']} / "
          f"{c['host_routed']}")
    check(g["abandoned"] == c["abandoned"] == 0,
          f"level {level}: abandoned {g['abandoned']} / {c['abandoned']}")
    print(f"full set cuda == cpu, ERLAMSA_PALLAS={level or 'unset'}: "
          f"{len(corpus)} rows x {MIXED_CASES} cases equal, "
          f"{g['host_routed']} host-routed, 0 abandoned "
          f"({g['s']:.1f}s on the card, {c['s']:.1f}s on the CPU)")


def load_port(root):
    """The erlamsa_tpu_torch package of another checkout, imported under
    another name (its modules import each other relatively); its kernels
    build into that checkout's own _build directory."""
    import importlib
    import importlib.util

    name = "erlamsa_tpu_torch_" + re.sub(r"\W", "_", os.path.abspath(root))
    if name not in sys.modules:
        pkg = os.path.join(os.path.abspath(root), "erlamsa_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        for sub in ("ops", "ops.cuda_build", "ops.round_apply",
                    "ops.case_rounds", "ops.randmask"):
            importlib.import_module(f"{name}.{sub}")
    return sys.modules[name]


def compare(root, timed, bounds, card, corpus, seed3, dev):
    """Time the three kernels of the checkout at ``root`` against this
    checkout's, in turns (theirs, ours, ours, theirs), on the inputs they
    are timed on here (``timed``: name -> args): device time (CUDA graph)
    and wrapper time, beside this run's bound; then the default stream's
    device path (fuzz_cases, composite) over the main path's corpus, in
    turns, in samples/s."""
    import importlib

    import torch

    from erlamsa_tpu_torch.ops import case_rounds as cr
    from erlamsa_tpu_torch.ops import randmask as rm
    from erlamsa_tpu_torch.ops import round_apply as ra
    from erlamsa_tpu_torch.services import batchrunner as br

    names = ("round_apply", "case_rounds", "randmask")
    other = load_port(root)
    t = time.perf_counter()
    other.ops.cuda_build.build_all(list(names))
    print(f"compare: built {root}'s kernels in {time.perf_counter() - t:.1f}s")
    if hasattr(other.ops.cuda_build, "ptxas_report"):
        for name in names:
            for entry, info in other.ops.cuda_build.ptxas_report(name):
                print(f"compare: ptxas {name} {entry}: {info}")
        for name in ("round_apply", "case_rounds"):
            mod = getattr(other.ops, name)
            print(f"compare: {name} CTAs per SM at L=8192 / 1000000: "
                  f"{mod.ctas_per_sm(8192)} / {mod.ctas_per_sm(1000000)}")
    for name, ours, theirs in (
            ("round_apply", ra.round_apply, other.ops.round_apply.round_apply),
            ("case_rounds", cr.case_rounds, other.ops.case_rounds.case_rounds),
            ("randmask", rm.randmask_keys,
             other.ops.randmask.randmask_keys)):
        args = timed[name]
        check(max_err(ours(*args), theirs(*args)) == 0,
              f"{name}: {root}'s kernel and this one differ")
        dev_ms, wrap_ms = [], []
        for fn in (theirs, ours, ours, theirs):
            dev_ms.append(graph_ms(lambda fn=fn: fn(*args)))
            wrap_ms.append(cuda_ms(lambda fn=fn: fn(*args), 20))
        fmt = lambda v: " / ".join(f"{x:.4f}" for x in v)  # noqa: E731
        share = " / ".join(f"{bounds[name] / x * 100:.1f}%" for x in dev_ms)
        shape = list(args[1 if name == "case_rounds" else -1].shape)
        print(f"compare {name} at {shape} (theirs, ours, ours, theirs): "
              f"device ms {fmt(dev_ms)}; wrapper ms {fmt(wrap_ms)}; bound "
              f"{bounds[name]:.4f} ms, device share of bound {share}; "
              f"outputs equal; theirs = {root}; card {card}")
    other_br = importlib.import_module(f"{other.__name__}.services.batchrunner")
    rates, last = [], []
    for mod in (other_br, br, br, other_br):
        t = time.perf_counter()
        outs = [o for _case, o in mod.fuzz_cases(corpus, seed3, None,
                                                 COMPARE_CASES, dev, level=0)]
        torch.cuda.synchronize()
        rates.append(len(corpus) * COMPARE_CASES / (time.perf_counter() - t))
        last.append(outs[-1][0][1])
    check(all(torch.equal(last[0], x) for x in last),
          f"the composite stream of {root} and this one differ")
    print(f"compare composite device path, {len(corpus)} seeds x "
          f"{COMPARE_CASES} cases (theirs, ours, ours, theirs): samples/s "
          + " / ".join(f"{r:.1f}" for r in rates)
          + f"; outputs equal; theirs = {root}; card {card}")


def profile_case(corpus, seed3, dev, card, label):
    """One level-2 case at the main path's shape under torch.profiler:
    the ten largest device ops, the device's idle share over the case and
    the case kernel's share of the case."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from erlamsa_tpu_torch.ops import prng
    from erlamsa_tpu_torch.ops.pipeline import make_class_fuzzer
    from erlamsa_tpu_torch.ops.scheduler import init_scores
    from erlamsa_tpu_torch.services.batchrunner import class_panels

    (idx, packed, scan_len), = class_panels(corpus, dev).values()
    step = make_class_fuzzer(device=dev, level=2)
    base = prng.base_key(tuple(seed3), device=dev)
    scores = init_scores(prng.fold_in(base, 999), len(corpus))

    def case(c):
        out = step(base, c, idx, packed.data, packed.lens, scores[idx],
                   scan_len=scan_len)
        torch.cuda.synchronize()
        return out

    case(0)  # warm: builds, tables on the card, allocator
    t = time.perf_counter()
    case(1)
    plain_wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        case(1)
        wall = (time.perf_counter() - t) * 1e3
    dev_type = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == dev_type)
    busy, end = 0.0, None
    for a, b in spans:  # union of the device intervals, in us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    ops = [e for e in prof.key_averages() if e.device_type == dev_type]
    ops.sort(key=dev_us, reverse=True)
    kern = sum(dev_us(e) for e in ops if "case_rounds_kernel" in e.key) / 1e3
    print(f"profile level-2 case ({label}) at [{len(corpus)}, "
          f"{packed.data.shape[1]}]: {plain_wall:.3f} ms unprofiled, "
          f"{wall:.3f} ms profiled, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}; case kernel {kern:.4f} ms = "
          f"{kern / busy:.3f} of device time, {kern / plain_wall:.3f} of the "
          f"unprofiled case; card {card}")
    for e in ops[:10]:
        print(f"  {dev_us(e) / 1e3:9.4f} ms x{e.count:<5d} {e.key[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one level-2 case under torch.profiler")
    ap.add_argument("--compare", metavar="DIR", nargs="+", default=[],
                    help="other checkouts whose kernels to time against")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "erlamsa_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 3
    sys.path.insert(0, here)
    t_start = time.perf_counter()

    from erlamsa_tpu_torch.ops import case_rounds as cr
    from erlamsa_tpu_torch.ops import cuda_build, fused, pipeline, prng
    from erlamsa_tpu_torch.ops import randmask as rm
    from erlamsa_tpu_torch.ops import round_apply as ra

    for mod in ("jax", "erlamsa_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")

    # 1. build, one nvcc per kernel, all at once
    t = time.perf_counter()
    built = cuda_build.build_all(["round_apply", "case_rounds", "randmask"])
    print(f"build: {', '.join(os.path.relpath(p, here) for p in built.values())}"
          f" in {time.perf_counter() - t:.1f}s")
    pipes, per_op, probe = threefry_ops(cuda_build.BUILD_DIR,
                                        cuda_build.CSRC)
    ops = ", ".join(f"{op} {v:g}" for op, v in per_op.items())
    floor, ran = word_clocks(pipes), probe_clocks(probe)
    print(f"threefry word in sm_90a SASS: integer ALU {pipes['alu']:g}, "
          f"FMA pipe (IMAD) {pipes['fma']:g}, all {pipes['all']:g} "
          f"instructions ({ops}); bound {floor:.4f} SM clocks per word = "
          f"max(ALU / {ALU_RATE}, FMA / {FMA_RATE}, all / {ISSUE_RATE}) at "
          f"{SMS} SMs x {CLOCK_HZ:.4g} Hz; the probe ran {ran:.4f} clocks "
          f"per word on the card ({floor / ran * 100:.1f}% of the bound)")
    check(ran >= floor, "the threefry probe ran faster than its operation "
          "bound allows: an opcode is counted on the wrong pipe")
    for name in ("round_apply", "case_rounds", "randmask"):
        for entry, info in cuda_build.ptxas_report(name):
            print(f"ptxas {name} {entry}: {info}")
    print("CTAs per SM at L=8192 / 1000000: " + "; ".join(
        f"{mod.__name__.rsplit('.', 1)[1]} {mod.ctas_per_sm(8192)} / "
        f"{mod.ctas_per_sm(1000000)}" for mod in (ra, cr))
        + f"; randmask {rm.ctas_per_sm()} at any L")

    # 2. kernels against their plain versions
    rng = np.random.default_rng(args.seed)
    errs = kernels_vs_plain(rng, dev)

    # 3. the main path, once per stream; capture each kernel's first inputs
    corpus = make_corpus(rng, BATCH)
    seed3 = (args.seed, 22, 33)
    captured = {}

    def capturing(name, real):
        def call(*a):
            if name not in captured:
                captured[name] = [x.clone() if torch.is_tensor(x) else x
                                  for x in a]
            return real(*a)
        return call

    real_ra, real_cr = fused.round_apply, pipeline.case_rounds
    fused.round_apply = capturing("round_apply", real_ra)
    pipeline.case_rounds = capturing("case_rounds", real_cr)
    rates, launches = {}, {}
    try:
        for level, _what in STREAMS:
            got, cold, warm = main_path(level, corpus, seed3, dev)
            rates[level] = (cold, warm)
            launches[level] = got
    finally:
        fused.round_apply, pipeline.case_rounds = real_ra, real_cr
    check(launches[2]["case_rounds"] == CASES and
          launches[2]["round_apply"] == 0,
          f"the ERLAMSA_PALLAS=2 path launched {launches[2]}, want the case "
          f"kernel once per case")
    check(launches[1]["round_apply"] > 0 and launches[1]["case_rounds"] == 0,
          f"the ERLAMSA_PALLAS=1 path launched {launches[1]}")
    check(not any(launches[0].values()),
          f"the composite path launched {launches[0]}")
    mask_launches = sum(launches[lv]["randmask"] for lv, _what in STREAMS)
    check(mask_launches == 0,
          f"a main path launched the mask kernel: {launches}")
    print("samples/s by stream (first run / second run, one call): " +
          "; ".join(f"{what} {rates[lv][0]:.1f} / {rates[lv][1]:.1f}"
                    for lv, what in STREAMS))

    # 4. the full default set at full width, in the case-kernel stream and
    # the default composite one, the counts read per run
    full = {level: full_set(level, corpus, seed3, dev) for level in (2, 0)}
    check(full[2][0]["case_rounds"] == CASES and
          full[2][0]["round_apply"] == 0,
          f"the full set at ERLAMSA_PALLAS=2 launched {full[2][0]}, want the "
          "case kernel once per case")
    check(not any(full[0][0].values()),
          f"the full set's composite path launched {full[0][0]}")
    # 5. the full set on the card == on the CPU, whole 256-row runs
    mixed = mixed_corpus(np.random.default_rng(args.seed + 1), MIXED_ROWS)
    for level in (2, 0):
        full_set_cuda_vs_cpu(level, mixed, seed3, dev)

    rows = []
    # round kernel on the ERLAMSA_PALLAS=1 path's first-round inputs
    keys, params, lit, data = captured["round_apply"]
    B, L = data.shape
    ms = graph_ms(lambda: ra.round_apply(keys, params, lit, data))
    wrap_ms = cuda_ms(lambda: ra.round_apply(keys, params, lit, data), 50)
    plain_ms = cuda_ms(lambda: ra.round_apply_plain(keys, params, lit, data),
                       5)
    err = max_err(ra.round_apply(keys, params, lit, data),
                  ra.round_apply_plain(keys, params, lit, data))
    check(err == 0, "round kernel != plain on the main path's inputs")
    moved = 2 * B * L + B * (16 * 4 + ra.SCRATCH + 16)
    P = params.long()
    kind, ps, pl = P[:, 0], P[:, 11], P[:, 12]
    m = kind == ra.K_MASK
    lo, hi = ps.clamp(0, L), (ps + pl).clamp(0, L)
    span = torch.where(m, (hi - lo).clamp(min=0), 0)
    # words: row 0 over each mask span, row 1 or 2 where it fires, and the
    # Fisher-Yates window's row 3
    i = torch.arange(L, device=dev)[None, :]
    mrows = torch.nonzero(m).flatten()
    inspan = (i >= lo[mrows, None]) & (i < hi[mrows, None])
    occ_n = torch.remainder(prng.bits(keys[mrows], (L,)), 100)
    mp = P[mrows, 14][:, None]
    occurs = torch.where(mp == 1, occ_n != 0, occ_n < mp) & inspan
    fy = int(torch.where(kind == ra.K_PERM_BYTES,
                         pl.clamp(0, min(256, L)), 0).sum())
    words = int(span.sum()) + int(occurs.sum()) + fy
    bound_ms, bound_by = bound(moved, words, pipes)
    rows.append(("round_apply", "erlamsa_tpu/ops/pallas_kernels.py:319",
                 launches[1]["round_apply"], max(errs["round_apply"], err),
                 ms, plain_ms, bound_ms, bound_by, B, L, moved, words,
                 wrap_ms))

    # case kernel on the ERLAMSA_PALLAS=2 path's first inputs, the int
    # operands cast to the kernel's int32 once so that the graph holds
    # the kernel alone
    c_args = [x.to(torch.int32) if x.dtype == torch.int64 and j > 1 else x
              for j, x in enumerate(captured["case_rounds"])]
    keys, data = c_args[0], c_args[1]
    B, L = data.shape
    ms = graph_ms(lambda: cr.case_rounds(*c_args))
    wrap_ms = cuda_ms(lambda: cr.case_rounds(*c_args), 20)
    plain_ms = cuda_ms(lambda: cr.case_rounds_plain(*c_args), 1)
    err = max_err(cr.case_rounds(*c_args), cr.case_rounds_plain(*c_args))
    check(err == 0, "case kernel != plain on the main path's inputs")
    words = cr.kernel_words(*c_args)
    # row in and out once, plus keys, n, scores in and out, rounds, log,
    # priorities
    moved = 2 * B * L + B * (16 + 4 + 4 + 2 * M * 4 + 4 + 16 * 4) + M * 8
    bound_ms, bound_by = bound(moved, words, pipes)
    rows.append(("case_rounds", "erlamsa_tpu/ops/pallas_rounds.py:1180",
                 launches[2]["case_rounds"], max(errs["case_rounds"], err),
                 ms, plain_ms, bound_ms, bound_by, B, L, moved, words,
                 wrap_ms))

    # mask kernel: no main path runs it; timed at the main path's shape
    seeds = torch.from_numpy(rng.integers(-2**31, 2**31, B)
                             .astype(np.int32)).to(dev)
    span_len = torch.from_numpy(rng.integers(1, L + 1, B)).to(dev)
    start = torch.remainder(torch.from_numpy(rng.integers(0, L, B))
                            .to(dev), L - span_len + 1)
    params = torch.stack([start, span_len,
                          torch.remainder(torch.arange(B, device=dev), 4),
                          torch.full_like(start, 50),
                          torch.ones_like(start)], 1).to(torch.int32)
    mdata = data.clone()
    mkeys = rm.seed_keys(seeds)
    ms = graph_ms(lambda: rm.randmask_keys(mkeys, params, mdata))
    wrap_ms = cuda_ms(lambda: rm.randmask(seeds, params, mdata), 50)
    plain_ms = cuda_ms(lambda: rm.randmask_plain(mkeys, params, mdata), 5)
    err = max_err(rm.randmask(seeds, params, mdata),
                  rm.randmask_plain(mkeys, params, mdata))
    check(err == 0, "mask kernel != plain at the main path's shape")
    inspan = (i >= start[:, None]) & (i < (start + span_len)[:, None])
    occ_n = torch.remainder(prng.bits(mkeys, (L,)), 100)
    words = int(inspan.sum()) + int((inspan & (occ_n < 50)).sum())
    moved = 2 * B * L + B * (4 + 5 * 4)
    bound_ms, bound_by = bound(moved, words, pipes)
    rows.append(("randmask", "erlamsa_tpu/ops/pallas_kernels.py:97",
                 mask_launches, max(errs["randmask"], err), ms, plain_ms,
                 bound_ms, bound_by, B, L, moved, words, wrap_ms))
    timed = {"round_apply": captured["round_apply"], "case_rounds": c_args,
             "randmask": (mkeys, params, mdata)}

    for (name, _rep, n_launch, e, ms, plain_ms, bound_ms, bound_by, B, L,
         moved, words, wrap_ms) in rows:
        print(f"{name} at [{B}, {L}]: {ms:.4f} ms device (CUDA graph), "
              f"{wrap_ms:.4f} ms per wrapper call, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {moved} B, {words} "
              f"threefry words), {bound_ms / ms * 100:.1f}% of bound, "
              f"{n_launch} launches on its main path; card {card}")
    for root in args.compare:
        compare(root, timed, {r[0]: r[6] for r in rows}, card, corpus,
                seed3, dev)
    if args.profile:
        profile_case(corpus, seed3, dev, card, "this checkout")
        if args.compare:
            other = load_port(args.compare[0])
            real = pipeline.case_rounds
            pipeline.case_rounds = other.ops.case_rounds.case_rounds
            try:
                profile_case(corpus, seed3, dev, card, args.compare[0])
            finally:
                pipeline.case_rounds = real
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"erlamsa_tpu_torch/csrc/{name}.cu", "replaces": rep,
        "launches": n_launch, "max_abs_err": e, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    } for (name, rep, n_launch, e, ms, plain_ms, bound_ms, bound_by,
           *_rest) in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
