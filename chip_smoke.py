#!/usr/bin/env python3
"""Smoke test of erlamsa_tpu_torch on one NVIDIA GPU (the port's quickest
proof that it still starts and computes the right bytes on the card).

Phases, each fatal on failure:
  1. build   compile the three CUDA kernels (erlamsa_tpu_torch/csrc/
             round_apply.cu, case_rounds.cu, randmask.cu) for sm_90a from
             the checkout's sources, one nvcc each, all at once; print
             ptxas's registers, spills and shared memory per kernel and
             the CTAs per SM at the main path's row width; count the
             integer instructions of one threefry word in the SASS of a
             probe kernel (for the kernels' operation bounds);
  2. kernel  hold each kernel against its plain PyTorch version on the
             card, byte for byte (tolerance 0: every function is integer):
             the round kernel over every kind and the edge programs, the
             case kernel over rows of the three corpus shapes (a quarter
             of them filled to the row end, for the wraparound) with the
             default priorities and, at L=256, each mutator forced alone,
             and the mask kernel; at L = 256, 8192, 65536 (the kernels'
             shared-memory path) and 1,000,000 (their device-memory path);
  3. main    the batch fuzzer's main path (services/batchrunner.fuzz_cases,
             the loop behind ``python -m erlamsa_tpu_torch``) at full
             width, once per stream: ERLAMSA_PALLAS=2 (the case kernel),
             =1 (the round kernel) and unset (the composite apply, no
             kernel). 4096 seeds of 2-4 KB (capacity class 8192) mixing
             text, length-prefixed and binary, 4 cases with scores
             carried. Each path's kernel must have launched (the case
             kernel once per case), lengths fit, padding is zero, a second
             run gives the same bytes, and 64 rows equal the CPU plain
             path through make_class_fuzzer.

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
            example the parent commit, from git archive): build its round
            and case kernels and time them against this checkout's in
            turns (theirs, ours, ours, theirs) on the main path's inputs;
            with --profile, trace a level-2 case with the first DIR's case
            kernel too.
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
# H100 SXM 32-bit integer issue rate: 132 SMs x 64 results per clock per
# SM (integer add, bitwise and shift at compute capability 9.0, CUDA C++
# Programming Guide's arithmetic throughput table) x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer-pipe opcodes counted per threefry word; IMADs, which nvcc issues
# to the FMA pipe alongside them, are printed but not counted
INT_PIPE = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA",
            "PRMT", "SEL", "ISETP", "IMNMX", "IABS", "VIADD"}
THREEFRY_PROBE = r"""
#include "threefry.cuh"
template <int N>
__device__ void words(uint32_t k0, uint32_t k1, uint32_t* out) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x, acc = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) acc ^= erl::threefry_word(k0, k1, i * N + j);
  out[i] = acc;
}
extern "C" __global__ void words4(uint32_t k0, uint32_t k1, uint32_t* o) {
  words<4>(k0, k1, o);
}
extern "C" __global__ void words8(uint32_t k0, uint32_t k1, uint32_t* o) {
  words<8>(k0, k1, o);
}
"""
BATCH = 4096  # seeds, one capacity class (BASELINE.json configs[2])
CASES = 4
CHECK_ROWS = 64  # rows held against the CPU plain path
# (L, B): the kernels' shared-memory path up to 65536, device memory above
KERNEL_SIZES = ((256, 256), (8192, 256), (65536, 32), (1000000, 4))
GRAPH_LAUNCHES = 20  # launches per CUDA graph when timing a kernel
M = 31  # device mutators
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
    """Integer-pipe instructions per threefry word in the SASS nvcc emits
    for sm_90a (csrc/threefry.cuh): the opcode counts of an 8-word probe
    kernel less those of a 4-word one, over 4, so that set-up, the key
    schedule and the store cancel. Returns (ops per word, {opcode: per
    word})."""
    from erlamsa_tpu_torch.ops import cuda_build

    src = os.path.join(build_dir, "threefry_probe.cu")
    cubin = os.path.join(build_dir, "threefry_probe.cubin")
    with open(src, "w") as f:
        f.write(THREEFRY_PROBE)
    subprocess.run([cuda_build.toolkit(), "-cubin", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", csrc, "-o", cubin, src],
                   check=True, capture_output=True, timeout=300)
    sass = subprocess.run([cuda_build.toolkit("cuobjdump"), "-sass", cubin],
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
    return sum(v for op, v in per.items() if op in INT_PIPE), per


def bound(moved_bytes, words, ops_per_word):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth
    and the threefry words' integer operations over the integer rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = words * ops_per_word / INT32_OPS_PER_S
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

        seeds = torch.from_numpy(rng.integers(-2**31, 2**31, B)
                                 .astype(np.int32)).to(dev)
        params = torch.from_numpy(np.stack([
            rng.integers(-8, L, B), rng.integers(0, L + 8, B),
            rng.integers(0, 5, B), rng.integers(0, 102, B),
            rng.integers(0, 4, B) > 0], 1).astype(np.int32)).to(dev)
        mdata = torch.from_numpy(rng.integers(0, 256, (B, L),
                                              dtype=np.uint8)).to(dev)
        got = rm.randmask(seeds, params, mdata)
        torch.cuda.synchronize()
        err = max_err(got, rm.randmask_plain(rm.seed_keys(seeds), params,
                                             mdata))
        key = torch.from_numpy(rng.integers(0, 2**32, 2,
                                            dtype=np.int64)).to(dev)
        one = rm.randmask_single(key, params[0], mdata[0])
        torch.cuda.synchronize()
        err = max(err, max_err(one, rm.randmask_plain(
            key[None], params[:1], mdata[:1])[0]))
        errs["randmask"] = max(errs["randmask"], err)
        print(f"kernel-vs-plain randmask: L={L} B={B} max_abs_err={err}")
        check(err == 0, f"mask kernel != plain at L={L}")
    return errs


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
                    "ops.case_rounds"):
            importlib.import_module(f"{name}.{sub}")
    return sys.modules[name]


def compare(root, captured, c_args, card):
    """Time the round and case kernels of the checkout at ``root`` against
    this checkout's, in turns (theirs, ours, ours, theirs), on the main
    path's captured inputs: device time (CUDA graph) and wrapper time."""
    from erlamsa_tpu_torch.ops import case_rounds as cr
    from erlamsa_tpu_torch.ops import round_apply as ra

    other = load_port(root)
    t = time.perf_counter()
    other.ops.cuda_build.build_all(["round_apply", "case_rounds"])
    print(f"compare: built {root}'s kernels in {time.perf_counter() - t:.1f}s")
    if hasattr(other.ops.cuda_build, "ptxas_report"):
        for name in ("round_apply", "case_rounds"):
            for entry, info in other.ops.cuda_build.ptxas_report(name):
                print(f"compare: ptxas {name} {entry}: {info}")
            mod = getattr(other.ops, name)
            print(f"compare: {name} CTAs per SM at L=8192 / 1000000: "
                  f"{mod.ctas_per_sm(8192)} / {mod.ctas_per_sm(1000000)}")
    ra_args = captured["round_apply"]
    for name, ours, theirs, args in (
            ("round_apply", ra.round_apply, other.ops.round_apply.round_apply,
             ra_args),
            ("case_rounds", cr.case_rounds, other.ops.case_rounds.case_rounds,
             c_args)):
        check(max_err(ours(*args), theirs(*args)) == 0,
              f"{name}: {root}'s kernel and this one differ")
        dev_ms, wrap_ms = [], []
        for fn in (theirs, ours, ours, theirs):
            dev_ms.append(graph_ms(lambda fn=fn: fn(*args)))
            wrap_ms.append(cuda_ms(lambda fn=fn: fn(*args), 20))
        fmt = lambda v: " / ".join(f"{x:.4f}" for x in v)  # noqa: E731
        shape = list(args[1 if name == "case_rounds" else 3].shape)
        print(f"compare {name} at {shape} (theirs, ours, ours, theirs): "
              f"device ms {fmt(dev_ms)}; "
              f"wrapper ms {fmt(wrap_ms)}; outputs equal; theirs = {root}; "
              f"card {card}")


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
    ops_per_word, per_op = threefry_ops(cuda_build.BUILD_DIR,
                                        cuda_build.CSRC)
    ops = ", ".join(f"{op} {v:g}" for op, v in per_op.items())
    print(f"threefry word in sm_90a SASS: {ops_per_word:g} integer-pipe "
          f"instructions ({ops}); bound rate {INT32_OPS_PER_S:.4g} int32 "
          f"ops/s")
    for name in ("round_apply", "case_rounds"):
        for entry, info in cuda_build.ptxas_report(name):
            print(f"ptxas {name} {entry}: {info}")
    print("CTAs per SM at L=8192 / 1000000: " + "; ".join(
        f"{mod.__name__.rsplit('.', 1)[1]} {mod.ctas_per_sm(8192)} / "
        f"{mod.ctas_per_sm(1000000)}" for mod in (ra, cr)))

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
    bound_ms, bound_by = bound(moved, words, ops_per_word)
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
    bound_ms, bound_by = bound(moved, words, ops_per_word)
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
    bound_ms, bound_by = bound(moved, words, ops_per_word)
    rows.append(("randmask", "erlamsa_tpu/ops/pallas_kernels.py:97",
                 mask_launches, max(errs["randmask"], err), ms, plain_ms,
                 bound_ms, bound_by, B, L, moved, words, wrap_ms))

    for (name, _rep, n_launch, e, ms, plain_ms, bound_ms, bound_by, B, L,
         moved, words, wrap_ms) in rows:
        print(f"{name} at [{B}, {L}]: {ms:.4f} ms device (CUDA graph), "
              f"{wrap_ms:.4f} ms per wrapper call, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {moved} B, {words} "
              f"threefry words), {bound_ms / ms * 100:.1f}% of bound, "
              f"{n_launch} launches on its main path; card {card}")
    for root in args.compare:
        compare(root, captured, c_args, card)
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
