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
             the round kernel over every kind and the edge programs (also
             params whose int32 sums and products wrap, at each width and
             at L = 240, which does not divide 2^32), the
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
             text, length-prefixed and binary, 4 cases at level 2 and 1 at
             levels 1 and 0 (4 before phase 9 came), scores carried. Each
             path's kernel must have launched (the case
             kernel once per case), lengths fit, padding is zero, a second
             run gives the same bytes, and 64 rows equal the CPU plain
             path through make_class_fuzzer;
  4. full    the same corpus through services/batchrunner.hybrid_cases
             (``python -m erlamsa_tpu_torch`` with no -m: the 41-code
             default set, rows the hybrid dispatcher routes to the host
             oracle on its process pool), 2 cases under ERLAMSA_PALLAS=2
             and 1 unset (4 and 4 before phase 8, 2 and 2 before phase 9
             came): samples/s, the host-routed share, overflow and
             abandoned counts, host-wait against device seconds; the case
             kernel must launch once per case at level 2;
  5. mixed   (run before phase 4, beside phase 8's store build) a
             64-row corpus (one row each of XML, JSON, zip, gzip,
             base64 and a URI, the rest small seeds of the three shapes)
             through the full set for 2 cases at level 2 and 1 at level
             0 (3 rows x 256 before phase 8 came, 2 x 256 before phase 9,
             2 cases at level 0 before phase 11, 128 rows before phase
             12) on the card and on the
             CPU: every row's bytes equal, at least one row host-routed,
             none abandoned;
  6. state   resumable runs and output sinks through services/batchrunner.
             run_batch (``python -m erlamsa_tpu_torch`` with --state and -o,
             files through services/out.py): (a) phase 3's corpus with the
             30 device codes at ERLAMSA_PALLAS=2, 2 cases straight and 1 +
             1 resumed with a checkpoint after every case (4 and 2 + 2
             before phase 9): every file equal, the case kernel launched
             twice in each, save_state's seconds per case; (b) phase 5's
             64-row corpus, the full set,
             level 2 (2 and 0 before phase 10 came), interrupted after
             case 1 and resumed on the
             card: the files equal phase 5's CPU run, rows host-routed in
             the resumed part; (c) the card's checkpoint after case 1
             resumed on the CPU: the same files; (d) one case of (a)'s
             corpus to a tcp:// listener on the loopback: (a)'s files,
             each once, unaltered, in the order sent up to handshakes the
             network stack completes out of order (ACCEPT_REORDER); (e)
             after (b), the metrics snapshot counts the runs' host-routed
             rows and per-mutator outcomes;
  7. struct  the structured-format engine (--struct host|device, ops/
             structure.py, ops/tree_mutators.py): (a) the struct step on
             the card == the same function on the CPU, byte for byte, for
             each of the nine codes on JSON, HTML, base64 and HTTP rows at
             W = 256, 8192 and 1,000,000; (b) 4096 structured 2-4 KB
             seeds (class 8192; quarters of the four kinds, a zip every
             64th row) through run_batch, ERLAMSA_PALLAS=2, the full set,
             1 case (4 before phase 9) with --struct host and --struct
             device: the files equal, the case kernel launched once per
             case in each, the struct step ran on cuda, 64 rows == the
             CPU port;
             samples/s, host-routed share, host wait against device
             seconds, struct rows and struct step time (CUDA events) per
             case, tokenizer seconds; (c) phase 5's 64-row corpus with
             --struct device at levels 2 (2 cases) and 0 (1 case, 2 before
             phase 11 came), card == CPU, and at level 2 stopped after
             case 1 and resumed from --state == straight.

  8. feedback the feedback corpus engine (``--feedback --corpus DIR``,
             corpus/runner.py): (a) each paged op (ops/paged.py) on a
             [4096, 256] arena and a DeviceArena sequence (admission,
             tables, gathers, eviction, spills full and injected,
             device-side adoption, defrag) on the card == on the CPU,
             tolerance 0; (b) a campaign store of 8192 seeds of 64 B to
             16 KB (log-uniform, the three shapes of seed_bytes; bucket
             capacities 256-32768), built one add per seed by a process
             of its own started with the script (phase 4 waits for it:
             it runs beside phases 1-3 and 5 only), run at batch 4096,
             ERLAMSA_PALLAS=2, the 30 device codes, each run from a copy
             of the store: every run 2 cases (buckets async
             and arena async 4 before phase 9 came);
             sync == async, arena == buckets and
             adopt arena == adopt buckets file for file;
             samples/s, bytes uploaded and padded bytes wasted per
             sample, step shapes, the stage seconds, the arena's stats
             and resident bytes, peak device memory; every run with the
             case kernel launched once per class a case, not degraded and
             no device_lost event; (c) arena async stopped after case 1
             with --state and resumed for case 2 == (b)'s arena async; (d) 64 rows x 2 cases
             in both layouts, cuda == cpu; (e) the CLI in a process of
             its own (--layout arena) == (b)'s arena async run.
  9. serving the FaaS tier (``-H``, services/faas.py): (a) 256 payloads
             of 64 B to 16 KB (log-uniform, the three shapes of
             seed_bytes) admitted in order through ContinuousEngine on
             the card at level 2 (64 slots x 16384 B) == the single-shot
             request step on the card (one case-kernel launch a step), 64
             == the CPU plain path; the multi-class engine (256, 4096,
             16384) and TpuBatcher give the same bytes; levels 1 and 0,
             64 requests each, card == CPU; (b) the BASELINE.json
             configs[3] load through serve() at the CLI's defaults: 10,000
             requests from 512 keep-alive loopback connections (two
             asyncio load processes), 8 of them over 16384 B (the oracle
             escape), continuous, then 2,500 of them flush at --batch
             1024: every
             answer a 200 within its width, none shed, no give-up, fault
             or supervisor restart, the case kernel once per step, no
             step built on the request path, every slot home; requests/s,
             p50/p99 latency, steps, fill, steps per request, escapes,
             peak device memory; (c) before (b)'s continuous load, on its
             server, a burst of 2048 concurrent requests of one 4 KB
             payload: the answers == the single-shot bytes of request ids
             0..2047; (d) ``python -m erlamsa_tpu_torch -H``
             in a process of its own answers request id 0 with (a)'s
             bytes.
 10. proxy   the fuzzing proxy (``-i``, services/proxy.py) and the ``-m
             xla`` bridge server (services/xla_bridge.py), level 2, the
             flush batcher at the CLI's defaults (256 rows x 16384 B, 20
             ms): (a) tcp:// at -P 1.0,1.0 to an echo upstream, 32 strict
             request/response exchanges of 64-1460 B packets in phase 3's
             shapes, and 16 each through http:// (Content-Length fixed
             up), http2:// (only DATA changed, frame lengths right),
             udp:// and one connect:// tunnel: every request the batcher
             admitted == the single-shot request step at its (seed, rid),
             16 tcp answers == the CPU plain path, the case kernel once
             per flush; (b) the BASELINE.json configs[4] load: 256
             keep-alive connections from a load process of its own (it
             also runs the echo upstream), 16 packets of 64-1460 B each:
             exchanges/s, fuzzed packets/s, p50/p99 round trip, flushes,
             fill, launches, escapes, drops (a packet fuzzed to nothing
             gets no echo: a drop after 5 s), peak device memory; no
             give-up or restart, the case kernel once per flush; (c)
             ``python -m erlamsa_tpu_torch.services.xla_bridge`` over
             stdio: HELLO, FUZZ_BATCH tpu of phase 3's corpus x 4 cases
             == the in-process make_fuzzer step (one case-kernel launch a
             call), 16 FUZZ_CASE and MUX_EVENT frames == the CPU
             handlers, an unknown mutation name answers 0xFF and the next
             frame is served, nothing on stdout but frames; (d) ``python
             -m erlamsa_tpu_torch -i tcp://...`` in a process of its own
             forwards (a)'s first answer.
 11. coverage the coverage plane (``--feedback --coverage --distill``,
             ops/coverage.py, corpus/distill.py, services/monitors.py
             CoverageHub) and the host tier: (a) popcount, fold_maps and
             batch_gains on the card == their numpy twins, tolerance 0,
             at N = 1, 2, 4096 and 4097 maps of 1,024 B and 65,536 B at
             densities 0, 1/256, 1/2 and 1 (the twins run in a process
             of their own started with the script); the fold's device
             time at 4096 x 1024 B; (b) a 64-seed store of 64 B-4 KB, 64
             rows x 2 cases, arena async --adopt: the hash-novelty
             baseline, a --coverage --distill run and a run whose hub
             died under monitor.ingest:*, each on the card == on the CPU
             file for file (coverage stats, the ``# distill:`` line and
             the retired ids too), the dead hub's run == the baseline; a
             process of its own sends a frame for every (case, slot)
             before each run; (c) phase 8's store at batch 4096, 2
             cases, level 2, arena async --adopt --coverage --distill,
             frames for every slot: samples/s beside phase 8's arena
             --adopt, the coverage stage, maps folded, new edges,
             offspring, retired seeds, peak device memory, the case
             kernel once per class a case; (d) ``python -m
             erlamsa_tpu_torch --backend oracle`` for BASELINE.json
             configs[0] and with -w 2 -n 8 -o DIR/%n: md5s == the JAX
             CLI's (the constants the CPU tests hold to it), beside (b);
             phase 3's corpus through the CLI at level 2, 1 case, with
             --trace FILE --xprof DIR == without, the trace's runner
             spans, the profiler's case kernel, the span totals against
             the device's kernel time.
 12. gen     grammar generation (``--gen``, gen/, ops/grammar.py,
             services/gfcomms.py, obs/report.py): (a) the expander on
             the card == the port's CPU expander over 4096 slots of
             cases 0 and 3 (computed by a process of its own started
             with the script) and == the keyed host twin
             (models/genfuzz.generate_keyed) on 64 of them, for
             demo-http, demo-tlv, demo-lines and the reference tests'
             KITCHEN_SINK, fuzz off and on; a DSL grammar 7,808 B wide
             at 4096 slots: ms a panel, steps against max_steps,
             launches a panel (torch.profiler), peak device memory;
             (b) ``python -m erlamsa_tpu_torch --gen FILE:4096 --feedback
             --corpus DIR --layout arena --adopt --batch 4096 -n 2
             --metrics-out --trace`` in this process (ERLAMSA_PALLAS=2):
             samples/s, the ``# gen:`` line, case-kernel launches; the
             same command under ``--chaos gen.expand:x1`` in a process of
             its own writes the same files and store with host_fallback >
             0; at :64, batch 64, card == CPU; ``python -m
             erlamsa_tpu_torch.obs.report`` over (b)'s files prints a
             stage ledger; (c) gfcomms: sequential at a fixed -s replays
             the ErlRand stream's bytes twice; batched on the card, 64
             loopback connections x 16 packets from a process of its
             own, every reply == the CPU engine's expand(conn, slot):
             packets/s, p50/p99.

After each of phases 4 to 7, host-pool workers still running rows
abandoned past -T are stopped, so they take no cores from a later phase.

Then it times each kernel at the main path's shape beside its plain
version and its bound: ``ms`` is device time, CUDA events around replays
of a CUDA graph that holds 20 launches (the host's per-call work left
out), and the wrapper's per-call time (events around back-to-back calls)
is printed beside it. It prints samples/s for each stream, the card's
name and power limit, one JSON line describing the kernels, and as the
last line {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py [--seed N] [--profile] [--compare DIR ...]
    python3 chip_smoke.py --feedback-only
    python3 chip_smoke.py --serving-only
    python3 chip_smoke.py --proxy-only
    python3 chip_smoke.py --coverage-only
    python3 chip_smoke.py --gen-only

--profile   trace one level-2 case at the main path's shape under
            torch.profiler (CPU and CUDA): the ten largest device ops,
            the device's idle share, the case kernel's share of the case;
            and one 64 x 16384 serving slot step (phase 9): its idle
            share and the ten largest host ops;
            and run phase 7 (b) with --struct off too (one case, minutes).
--compare   each DIR holds another checkout of the repository (for
            example the parent commit, from git archive): build its three
            kernels, check their bytes equal these, and time them against
            this checkout's in turns (theirs, ours, ours, theirs) on the
            inputs they are timed on here, each beside its bound;
            with --profile, trace a level-2 case with the first DIR's case
            kernel too; then time the default (composite) stream's device
            path of DIR and of this checkout, in the same turns.
--feedback-only  build the kernels and run phase 8 alone; it prints no
            result lines.
--serving-only  build the kernels and run phase 9 alone; no result lines.
--proxy-only  build the kernels and run phase 10 alone; no result lines.
--coverage-only  build the kernels and run phase 11 alone, phase 8's
            store built meanwhile ((c) waits for it); no result lines.
--gen-only  build the kernels and run phase 12 alone; no result lines.
--full-set-only  build the kernels and run phase 4's level-2 run alone,
            at 2 and at 4 cases, with no store build beside it: a run's
            fixed seconds and its seconds a case; no result lines.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
ROUND_EDGE_WIDTHS = (240,)  # the round kernel's wrap rows alone
I32_MIN, I32_MAX = -2**31, 2**31 - 1
IO_CASES, IO_SPLIT = 2, 1  # phase 6 (a): cases, and where the run stops
MIXED_SPLIT = 1  # phase 6 (b): the case after which the run stops
# phase 6 (b)/(c)'s streams: level 2 (level 0 too before phase 10 came;
# phase 5 holds the full set at level 0 card == CPU, and the CPU tests
# resume it in all three streams)
STATE_LEVELS = (2,)
GRAPH_LAUNCHES = 20  # launches per CUDA graph when timing a kernel
M = 31  # device mutators
BIG_PRI = 300_000_000  # x a score of 8-10 passes 2^31: the int32 bound wraps
# the CUDA == CPU run of the full set (128 rows before phase 12 came)
MIXED_ROWS, MIXED_CASES = 64, 2
# phases 5 and 7 (c): cases of the level-0 card == CPU legs (2 before
# phase 11 came; level 0's class step is phase 3's, held there too)
MIXED_CASES_L0 = 1
FULL_CASES = 2  # phase 4: cases of each full-set run at full width
COMPARE_CASES = 2  # cases of each composite run --compare times
STREAMS = ((2, "case kernel"), (1, "round kernel"), (0, "composite"))
# phase 3's cases per stream: levels 1 and 0 are launch-bound (300-470
# samples/s), so they run 1 (4 before phase 9 came)
STREAM_CASES = {2: CASES, 1: 1, 0: 1}
FULL_CASES_L0 = 1  # phase 4's composite run (2 before phase 9 came)


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
        err = round_edges_vs_plain(L, dev)
        errs["round_apply"] = max(errs["round_apply"], err)
        check(err == 0, f"round kernel != plain on the wrap rows at L={L}")

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
    for L in ROUND_EDGE_WIDTHS:  # a width that does not divide 2^32
        err = round_edges_vs_plain(L, dev)
        errs["round_apply"] = max(errs["round_apply"], err)
        check(err == 0, f"round kernel != plain on the wrap rows at L={L}")
    for L, B in MASK_EDGE_SIZES:  # widths that are not a multiple of 16
        err = mask_vs_plain(np.random.default_rng(L), B, L, dev)
        errs["randmask"] = max(errs["randmask"], err)
        check(err == 0, f"mask kernel != plain at L={L}")
    return errs


def round_edges(L):
    """Round programs whose int32 param arithmetic wraps in the TPU kernel
    (tests/test_torch_round_apply.py holds the same rows against it): the
    splice lengths src_len * reps and lit_len * reps, the roll pos -
    src_start, the swap bounds a1 + l2 and a1 + l2 + l1, the roll -l1,
    and the mask span end ps + pl both ways."""
    from erlamsa_tpu_torch.ops import round_apply as ra

    n = L - L // 4
    rows = [
        dict(kind=ra.K_SPLICE, pos=4, drop=2, src=ra.SRC_SPAN, src_start=0,
             src_len=65536, reps=65536, n=n),
        dict(kind=ra.K_SPLICE, pos=4, drop=2, src=ra.SRC_SPAN, src_start=7,
             src_len=3, reps=1431655767, n=n),
        dict(kind=ra.K_SPLICE, pos=4, drop=2, src=ra.SRC_LIT, lit_len=65537,
             reps=65535, n=n),
        dict(kind=ra.K_SPLICE, pos=9, drop=0, src=ra.SRC_SPAN,
             src_start=I32_MIN, src_len=5, reps=3, n=n),
        dict(kind=ra.K_SWAP, a1=10, l1=20, l2=I32_MAX - 5, n=L),
        dict(kind=ra.K_SWAP, a1=3, l1=I32_MAX, l2=40, n=L),
        dict(kind=ra.K_SWAP, a1=0, l1=I32_MIN, l2=100, n=L),
        dict(kind=ra.K_MASK, ps=10, pl=I32_MAX - 5, mask_op=2, mask_prob=100,
             n=L),
        dict(kind=ra.K_MASK, ps=I32_MIN, pl=-1, mask_op=2, mask_prob=100,
             n=L),
    ]
    P = np.zeros((len(rows), 16), np.int32)
    for b, row in enumerate(rows):
        for name, v in row.items():
            P[b, ra.PARAM_FIELDS.index(name)] = v
    return P


def round_edges_vs_plain(L, dev) -> int:
    """The round kernel against its plain version on the wrap rows, from
    a generator of their own (``rng`` runs as before they were added).
    Returns the largest error."""
    import torch

    from erlamsa_tpu_torch.ops import round_apply as ra

    erng = np.random.default_rng(L + 1)
    P = round_edges(L)
    B = len(P)
    ops = [torch.from_numpy(x).to(dev) for x in (
        erng.integers(0, 2**32, (B, 2), dtype=np.int64), P,
        erng.integers(0, 256, (B, ra.SCRATCH), dtype=np.uint8),
        erng.integers(0, 256, (B, L), dtype=np.uint8))]
    got = ra.round_apply(*ops)
    torch.cuda.synchronize()
    err = max_err(got, ra.round_apply_plain(*ops))
    print(f"kernel-vs-plain round_apply int32-wrap rows: L={L} B={B} "
          f"path={ra.path(L)} max_abs_err={err}")
    return err


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

    cases = STREAM_CASES[level]
    from erlamsa_tpu_torch.ops import prng
    from erlamsa_tpu_torch.ops.buffers import pack, scan_bound
    from erlamsa_tpu_torch.ops.pipeline import make_class_fuzzer
    from erlamsa_tpu_torch.ops.scheduler import init_scores
    from erlamsa_tpu_torch.services.batchrunner import fuzz_cases

    def drive():
        outs = [per_class for _case, per_class in
                fuzz_cases(corpus, seed3, None, cases, dev, level=level)]
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
    for case in range(cases):
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
    for case in range(cases):
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
    samples = BATCH * cases
    print(f"main path ERLAMSA_PALLAS={level or 'unset'}: {BATCH} seeds x "
          f"{cases} cases, {samples / cold_s:.1f} samples/s first run, "
          f"{samples / warm_s:.1f} samples/s second run, launches {launches}; "
          f"lengths fit, padding zero, runs identical, {len(rows)} rows x "
          f"{cases} cases == CPU ({time.perf_counter() - t:.1f}s on the CPU)")
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


def full_set(level, corpus, seed3, dev, cases=FULL_CASES):
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
    runs = [res for _case, res in hybrid_cases(corpus, seed3, None,
                                                cases, dev, level=level,
                                                stats=stats)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = counts()
    check(len(runs) == cases
          and all(len(r) == len(corpus) for r in runs),
          "the full set did not emit one output per row and case")
    changed = sum(out != corpus[i] for r in runs for i, out in enumerate(r))
    check(changed > 0, "the full set mutated nothing")
    check(stats["host_routed"] > 0, "the full set routed no row to the host")
    check(stats["overflow"] == 0, "a 4 KB seed overflowed the device")
    samples = len(corpus) * cases
    share = stats["host_routed"] / samples
    print(f"full set ERLAMSA_PALLAS={level or 'unset'}: {len(corpus)} seeds "
          f"x {cases} cases, 41 codes, {samples / dt:.1f} samples/s, "
          f"host-routed {stats['host_routed']} ({share:.4f}), overflow "
          f"{stats['overflow']}, abandoned {stats['abandoned']}, host wait "
          f"{stats['host_wait_s']:.2f}s against device {stats['device_s']:.2f}s"
          f" of {dt:.2f}s, launches {launches}, {changed} rows changed")
    return launches, samples / dt, stats


def reap_host_workers():
    """Stop host-pool workers left running after their runs: a row
    abandoned past -T keeps running in its worker after the pool was
    shut down without waiting, and would take cores from every later
    phase. No pool is live between phases."""
    import multiprocessing

    left = multiprocessing.active_children()
    for p in left:
        p.terminate()
    for p in left:
        p.join(timeout=30)
    if left:
        print(f"reaped {len(left)} host-pool worker process(es) still "
              "running")


def full_set_cuda_vs_cpu(level, corpus, seed3, dev):
    """Phase 5 for one stream: the whole 64-row run of the full set on
    the card and on the CPU; every row's bytes equal, the host-routed
    ones included (routing depends on every row's scores, so whole runs
    are compared, not subsets). Returns the CPU run's rows per case."""
    from erlamsa_tpu_torch.services.batchrunner import hybrid_cases

    cases = MIXED_CASES if level else MIXED_CASES_L0
    runs, stats = {}, {}
    for d in (dev, "cpu"):
        stats[str(d)] = {}
        t = time.perf_counter()
        runs[str(d)] = [res for _case, res in hybrid_cases(
            corpus, seed3, None, cases, d, level=level,
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
          f"{len(corpus)} rows x {cases} cases equal, "
          f"{g['host_routed']} host-routed, 0 abandoned "
          f"({g['s']:.1f}s on the card, {c['s']:.1f}s on the CPU)")
    return runs["cpu"]


# a loopback TCP listener in a process of its own: accepts argv[2]
# connections, one after the other, and appends each one's bytes to the
# file argv[3] as a record (8-byte little-endian length, then the bytes);
# prints its port first
TCP_SINK = r"""
import socket, sys
srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
srv.bind(("127.0.0.1", 0))
srv.listen(int(sys.argv[1]))
print(srv.getsockname()[1], flush=True)
with open(sys.argv[3], "wb") as out:
    for _ in range(int(sys.argv[2])):
        conn, _ = srv.accept()
        chunks = []
        while chunk := conn.recv(1 << 16):
            chunks.append(chunk)
        conn.close()
        data = b"".join(chunks)
        out.write(len(data).to_bytes(8, "little") + data)
"""

# how far (in connections) the listener may accept a payload from where it
# was sent: the sender opens one connection a payload, one after the other,
# but a network stack may complete two handshakes in the other order (the
# card's machine did so for 1-2 adjacent pairs in about 4 runs of 10, with
# a listener that only accepts as well as with this one)
ACCEPT_REORDER = 8


class TcpSink:
    """The payloads of ``count`` connections to a loopback listener, in
    the order they were accepted (see ACCEPT_REORDER)."""

    def __init__(self, backlog, count, path):
        self.path, self.count = path, count
        self.proc = subprocess.Popen(
            [sys.executable, "-c", TCP_SINK, str(backlog), str(count), path],
            stdout=subprocess.PIPE, text=True)
        self.port = int(self.proc.stdout.readline())

    def take(self, timeout=120.0):
        self.proc.wait(timeout=timeout)
        check(self.proc.returncode == 0,
              f"the tcp sink exited with {self.proc.returncode}")
        got = []
        with open(self.path, "rb") as f:
            blob = f.read()
        off = 0
        while off < len(blob):
            n = int.from_bytes(blob[off:off + 8], "little")
            got.append(blob[off + 8:off + 8 + n])
            off += 8 + n
        return got

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()


def somaxconn() -> str:
    """The kernel's cap on a listener's accept queue."""
    try:
        with open("/proc/sys/net/core/somaxconn") as f:
            return f.read().strip()
    except OSError:
        return "unknown"


def displacement(got, sent):
    """For payloads received in ``got``, the largest distance between
    where each was received and where it was sent in ``sent`` (each sent
    payload matched once, the nearest first), and how many moved; None
    when ``got`` is not ``sent`` reordered (a payload lost, added or
    altered)."""
    if sorted(got) != sorted(sent):
        return None
    where = {}
    for i, p in enumerate(sent):
        where.setdefault(p, []).append(i)
    worst = moved = 0
    for j, p in enumerate(got):
        i = min(where[p], key=lambda i: abs(i - j))
        where[p].remove(i)
        worst, moved = max(worst, abs(i - j)), moved + (i != j)
    return worst, moved


def read_files(d, count):
    """The bytes of the files 0..count-1 a run wrote to d."""
    out = []
    for i in range(count):
        with open(os.path.join(d, str(i)), "rb") as f:
            out.append(f.read())
    return out


def state_io(corpus, mixed, cpu_runs, seed3, dev, card):
    """Phase 6: resumable runs and output sinks through run_batch, the
    loop behind ``python -m erlamsa_tpu_torch`` (-o files and tcp://
    through services/out.py, --state through services/checkpoint.py).
    ``cpu_runs``: phase 5's CPU rows per case, by level."""
    import shutil
    import tempfile

    import torch

    from erlamsa_tpu_torch.ops import cuda_build
    from erlamsa_tpu_torch.ops.registry import DEVICE_CODES, NUM_DEVICE_MUTATORS
    from erlamsa_tpu_torch.oracle.mutations import default_mutations
    from erlamsa_tpu_torch.services import metrics
    from erlamsa_tpu_torch.services.batchrunner import run_batch

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_io_", dir=cuda_build.BUILD_DIR)

    def run(rows, n, out, batch, device=dev, level=2, state=None,
            mutations=None):
        stats = {}
        opts = {"corpus": rows, "seed": seed3, "n": n, "output": out,
                "mutations": mutations, "_stats": stats}
        if state is not None:
            opts.update(state_path=state, checkpoint_every=1)
        check(run_batch(opts, batch=batch, device=device, level=level) == 0,
              f"run_batch failed: -n {n} -o {out}")
        torch.cuda.synchronize()
        return stats

    try:
        # (a) the main path, 30 device codes, case kernel: straight, then
        # interrupted after IO_SPLIT cases and resumed from the state file
        dev_set = [(c, p) for c, p in default_mutations() if c in DEVICE_CODES]
        B, total = len(corpus), len(corpus) * IO_CASES
        dirs = {k: os.path.join(work, k) for k in ("a", "ar", "d")}
        for d in dirs.values():
            os.makedirs(d)
        reset_counts()
        straight = run(corpus, IO_CASES, os.path.join(dirs["a"], "%n"), B,
                       mutations=dev_set)
        l_straight = counts()
        state = os.path.join(work, "a.npz")
        reset_counts()
        first = run(corpus, IO_SPLIT, os.path.join(dirs["ar"], "%n"), B,
                    state=state, mutations=dev_set)
        second = run(corpus, IO_CASES, os.path.join(dirs["ar"], "%n"), B,
                     state=state, mutations=dev_set)
        l_resumed = counts()
        check(second["start_case"] == IO_SPLIT,
              f"(a) resumed at {second['start_case']}, want {IO_SPLIT}")
        check(l_straight["case_rounds"] == IO_CASES
              and l_resumed["case_rounds"] == IO_CASES,
              f"(a) case kernel launches {l_straight} straight, {l_resumed} "
              f"resumed, want {IO_CASES} each")
        files_a = read_files(dirs["a"], total)
        check(files_a == read_files(dirs["ar"], total),
              "(a) the resumed run's files differ from the straight run's")
        check(sum(f != corpus[i % B] for i, f in enumerate(files_a)) > 0,
              "(a) nothing was mutated")
        with np.load(state) as z:
            held = z["scores"]
        check(held.shape == (B, NUM_DEVICE_MUTATORS) and held.dtype == np.int32,
              f"(a) the state holds scores {held.dtype}{list(held.shape)}")
        saves = first["saves"] + second["saves"]
        save_s = first["save_s"] + second["save_s"]
        check(saves == IO_CASES, f"(a) {saves} saves, want {IO_CASES}")
        resumed_dt = first["dt"] + second["dt"]
        print(f"state (a) main path ERLAMSA_PALLAS=2 through run_batch, {B} "
              f"seeds x {IO_CASES} cases, 30 device codes: straight "
              f"{total / straight['dt']:.1f} samples/s ({straight['dt']:.2f}s,"
              f" of which device {straight['device_s']:.2f}s, host wait "
              f"{straight['host_wait_s']:.2f}s)"
              f", resumed {IO_SPLIT} + {IO_CASES - IO_SPLIT} cases "
              f"{total / resumed_dt:.1f} samples/s ({resumed_dt:.2f}s); "
              f"{total} files equal; case kernel launches {l_straight['case_rounds']}"
              f" straight, {l_resumed['case_rounds']} resumed; save_state "
              f"{save_s / saves:.4f}s per case ({saves} saves, "
              f"{held.nbytes} B of scores); host-routed "
              f"{straight['host_routed']}; card {card}")

        # (d) one case to a tcp:// listener == (a)'s files of case 0
        sink = TcpSink(B, B, os.path.join(work, "tcp_sink.bin"))
        try:
            t = time.perf_counter()
            run(corpus, 1, f"tcp://127.0.0.1:{sink.port}", B,
                mutations=dev_set)
            got = sink.take()
            dt = time.perf_counter() - t
        finally:
            sink.close()
        moved = displacement(got, files_a[:B])
        check(moved is not None and moved[0] <= ACCEPT_REORDER,
              f"(d) the tcp sink received {len(got)} payloads: "
              + ("not the files of case 0" if moved is None else
                 f"{moved[1]} accepted up to {moved[0]} connections from "
                 f"where they were sent, past {ACCEPT_REORDER}"))
        print(f"state (d) tcp:// sink on the loopback: the {len(got)} files "
              f"of case 0, each once, unaltered, in the order sent ({moved[1]}"
              f" accepted out of place, at most {moved[0]} connections away; "
              f"{dt:.2f}s, one connection a payload, accept queue {B}, "
              f"somaxconn {somaxconn()})")

        # (b) the full set, interrupted after MIXED_SPLIT cases and resumed
        # on the card; (c) the card's checkpoint resumed on the CPU; (e)
        # the metrics of (b)
        metrics.GLOBAL = metrics.Counters()
        routed_b = 0
        n_rows = len(mixed)
        for level in STATE_LEVELS:
            want = [p for rows in cpu_runs[level] for p in rows]
            out_b = os.path.join(work, f"b{level}")
            out_c = os.path.join(work, f"c{level}")
            os.makedirs(out_b)
            os.makedirs(out_c)
            state_b = os.path.join(work, f"b{level}.npz")
            state_c = os.path.join(work, f"c{level}.npz")
            t = time.perf_counter()
            s1 = run(mixed, MIXED_SPLIT, os.path.join(out_b, "%n"), n_rows,
                     level=level, state=state_b)
            shutil.copyfile(state_b, state_c)
            s2 = run(mixed, MIXED_CASES, os.path.join(out_b, "%n"), n_rows,
                     level=level, state=state_b)
            dt_b = time.perf_counter() - t
            routed_b += sum(s["host_routed"] + s["overflow"] for s in (s1, s2))
            check(s2["start_case"] == MIXED_SPLIT,
                  f"(b) level {level} resumed at {s2['start_case']}")
            got = read_files(out_b, len(want))
            diff = sum(a != b for a, b in zip(got, want))
            check(diff == 0, f"(b) level {level}: {diff} rows of the resumed "
                  "card run differ from the uninterrupted CPU run")
            check(s2["host_routed"] >= 1 and s2["abandoned"] == 0,
                  f"(b) level {level}: {s2['host_routed']} host-routed, "
                  f"{s2['abandoned']} abandoned in the resumed part")
            if level == 2:
                snap = metrics.GLOBAL.snapshot()  # (e), before (c) adds
            t = time.perf_counter()
            s3 = run(mixed, MIXED_CASES, os.path.join(out_c, "%n"), n_rows,
                     device="cpu", level=level, state=state_c)
            dt_c = time.perf_counter() - t
            check(s3["start_case"] == MIXED_SPLIT,
                  f"(c) level {level} resumed on the CPU at {s3['start_case']}")
            lo = MIXED_SPLIT * n_rows
            got_c = [open(os.path.join(out_c, str(i)), "rb").read()
                     for i in range(lo, len(want))]
            check(got_c == want[lo:], f"(c) level {level}: the CPU resumed "
                  "from the card's checkpoint writes other bytes")
            print(f"state (b) full set ERLAMSA_PALLAS={level or 'unset'}, "
                  f"{n_rows} rows: {MIXED_SPLIT} + {MIXED_CASES - MIXED_SPLIT} "
                  f"cases resumed on the card == the CPU run, "
                  f"{s2['host_routed']} host-routed in the resumed part "
                  f"({dt_b:.1f}s); (c) the card's checkpoint after case "
                  f"{MIXED_SPLIT} resumed on the CPU == the same "
                  f"{len(want) - lo} rows ({dt_c:.1f}s)")
            if level == 2:
                routed_2 = routed_b
        # (e) the counters of (b) at level 2: every host-routed row counted
        # once by its code, and the host's per-mutator outcomes
        counted = sum(snap["host_routed"].values())
        applied = sum(v["applied"] for v in snap["mutators"].values())
        check(counted == snap["host_samples"] == routed_2,
              f"(e) the snapshot counts {counted} host-routed rows, the runs "
              f"{routed_2}")
        check(snap["routed_samples"] == n_rows * MIXED_CASES and applied > 0,
              f"(e) routed_samples {snap['routed_samples']}, applied "
              f"{applied}")
        print(f"state (e) metrics after (b) at level 2: host_routed "
              f"{snap['host_routed']} (sum {counted} == the runs' "
              f"{routed_2}), routed_samples {snap['routed_samples']}, "
              f"mutators applied {applied} over {len(snap['mutators'])} "
              f"codes")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"state and I/O phase: {time.perf_counter() - t_phase:.1f}s")
    return l_straight, l_resumed


# phase 7: (a) struct step widths (W, rows per code and document kind);
# (b) the structured corpus's zip rows, one per ZIP_EVERY
STRUCT_WIDTHS = ((256, 8), (8192, 4), (1000000, 2))
ZIP_EVERY = 64
# (b)'s runs: (--struct mode, cases). "off" sends a fifth of the rows to
# the host oracle, where about 6% of them outlive the 30 s budget and
# keep running in the pool's workers after they are abandoned: one case
# took 408-412 s beside an H100 80GB HBM3 (700 W), so it runs, one case,
# with --profile only
STRUCT_CASES = 1  # (b)'s cases in each mode (4 before phase 9 came)
STRUCT_MODES = (("host", STRUCT_CASES), ("device", STRUCT_CASES))
STRUCT_OFF = ("off", 1)


def struct_doc(rng, kind, n):
    """A structured document of n bytes in kind % 4: a JSON document, an
    HTML page, a base64 blob (space-padded to n) or an HTTP request whose
    lines carry URIs; built past n and cut, so long ones end unclosed."""
    import base64

    kind %= 4
    r = int(rng.integers(1 << 30))
    if kind == 0:
        item = (b'{"id": %d, "tags": ["a", "b%d"], "ok": true, "v": [1.5, '
                b'null, {"k": "x%d"}]}, ' % (r, r % 97, r % 13))
        doc = b'{"items": [' + item * (n // len(item) + 1) + b'{}], "n": 1}'
    elif kind == 1:
        row = (b'<div class="c%d"><p>text %d <b>bold</b> <a href="/p?%d">'
               b'link</a></p><br/></div>\n' % (r % 7, r, r % 31))
        doc = (b"<!DOCTYPE html><html><head><title>t</title></head><body>"
               + row * (n // len(row) + 1) + b"</body></html>")
    elif kind == 2:
        m = n // 4 * 4
        doc = base64.b64encode(rng.integers(0, 256, m // 4 * 3, np.uint8)
                               .tobytes())[:m] + b" " * (n - m)
    else:
        line = (b"Referer: http://host%d.example.com/a/b?q=%d&r=%%2F\r\n"
                % (r % 9, r))
        doc = (b"GET https://example.com/p/%d?x=1 HTTP/1.1\r\nHost: "
               b"example.com\r\n" % r + line * (n // len(line) + 1))
    return doc[:n]


def zip_doc(rng, n):
    """A zip archive of n bytes: one stored text member."""
    import io
    import zipfile

    text = seed_bytes(rng, 0, n)
    m = n
    while True:
        z = io.BytesIO()
        with zipfile.ZipFile(z, "w", zipfile.ZIP_STORED) as f:
            f.writestr("dir/file.txt", text[:m])
        if len(z.getvalue()) == n:
            return z.getvalue()
        m -= len(z.getvalue()) - n


def struct_corpus(rng, count):
    """4 KB structured seeds (2049-4096 bytes, class 8192) in quarters of
    JSON, HTML, base64 and HTTP requests, a zip in every ZIP_EVERY-th
    row."""
    out = []
    for i in range(count):
        n = int(rng.integers(2049, 4097))
        out.append(zip_doc(rng, n) if i % ZIP_EVERY == ZIP_EVERY - 1
                   else struct_doc(rng, i, n))
    return out


def struct_vs_cpu(rng, seed3, dev):
    """Phase 7 (a): the struct step on the card against the same function
    on the CPU, byte for byte (data, lengths, applied codes; tolerance
    0), for each code on rows of the four document kinds at each width of
    STRUCT_WIDTHS, half of them filled to the cap (inserts are cut)."""
    import torch

    from erlamsa_tpu_torch.ops import prng
    from erlamsa_tpu_torch.ops import structure as stm
    from erlamsa_tpu_torch.ops import tree_mutators as tm

    base = prng.base_key(seed3)
    for W, per in STRUCT_WIDTHS:
        t = time.perf_counter()
        docs = [struct_doc(rng, k, W if j % 2 else int(rng.integers(W // 2,
                                                                     W)))
                for k in range(4) for j in range(per)]
        tables = [stm.tokenize(d) for d in docs]
        tok_s = time.perf_counter() - t
        rows = [(d, tb, c) for c in range(stm.NUM_STRUCT)
                for d, tb in zip(docs, tables)] + [(docs[0], tables[0], -1)]
        B = len(rows)
        data = torch.zeros((B, W), dtype=torch.uint8)
        for r, (d, _tb, _c) in enumerate(rows):
            data[r, :len(d)] = torch.frombuffer(bytearray(d), dtype=torch.uint8)
        lens = torch.tensor([len(d) for d, _tb, _c in rows], dtype=torch.int32)
        nds = torch.from_numpy(np.stack([tb[0] for _d, tb, _c in rows]))
        cnts = torch.tensor([tb[1] for _d, tb, _c in rows], dtype=torch.int32)
        caps = torch.full((B,), W, dtype=torch.int32)
        codes = np.asarray([c for _d, _tb, c in rows], np.int32)
        slots = rng.integers(0, 1 << 20, B)
        args = (data, lens, nds, cnts, caps)
        before = tm.calls.get("cuda", 0)
        got = tm.struct_step(base.to(dev), 3, slots,
                             *(a.to(dev) for a in args), codes)
        torch.cuda.synchronize()
        check(tm.calls.get("cuda", 0) == before + 1,
              "the struct step did not run on cuda")
        want = tm.struct_step(base, 3, slots, *args, codes)
        for name, g, w in zip(("data", "lens", "applied"), got, want):
            check(torch.equal(g.cpu(), w),
                  f"struct step cuda != cpu at W={W}: {name}")
        applied = want[2].numpy()
        missing = [stm.STRUCT_CODES[c] for c in range(stm.NUM_STRUCT)
                   if not (applied == c).any()]
        check(not missing, f"struct step at W={W}: {missing} never applied")
        changed = sum(bytes(want[0][r, :int(want[1][r])].numpy()) != rows[r][0]
                      for r in range(B))
        print(f"struct step cuda == cpu at W={W}: {B} rows (9 codes x 4 "
              f"kinds x {per}, one passthrough), data, lengths and applied "
              f"equal, {int((applied >= 0).sum())} applied, {changed} "
              f"changed; tokenize {tok_s:.2f}s")


def struct_rows_vs_cpu(corpus, seed3, stats, files, level):
    """Phase 7 (b): CHECK_ROWS rows (not zip) of the --struct device run
    against the CPU port, case by case: the class step through
    make_class_fuzzer with the rows' own indices and carried scores, and
    where the run routed a row to the struct engine, the struct step on
    its seed. Returns (struct-routed row-cases checked, seconds)."""
    import torch

    from erlamsa_tpu_torch.ops import prng
    from erlamsa_tpu_torch.ops import structure as stm
    from erlamsa_tpu_torch.ops.buffers import capacity_for, pack, scan_bound
    from erlamsa_tpu_torch.ops.pipeline import make_class_fuzzer
    from erlamsa_tpu_torch.ops.scheduler import init_scores
    from erlamsa_tpu_torch.ops.tree_mutators import struct_step
    from erlamsa_tpu_torch.services.batchrunner import device_priorities

    t = time.perf_counter()
    B = len(corpus)
    cand = [i for i in range(B) if i % ZIP_EVERY != ZIP_EVERY - 1]
    rows = np.asarray(cand)[np.linspace(0, len(cand) - 1, CHECK_ROWS)
                            .astype(np.int64)]
    cap = capacity_for(len(corpus[rows[0]]))
    check(all(capacity_for(len(s)) == cap for s in corpus),
          "the structured corpus is not one capacity class")
    step = make_class_fuzzer(mutator_pri=device_priorities(None),
                             device="cpu", level=level)
    base = prng.base_key(seed3)
    scores = init_scores(prng.fold_in(base, 999), B)[rows]
    packed = pack([corpus[i] for i in rows], capacity=cap, device="cpu")
    scan_len = scan_bound(max(len(s) for s in corpus), cap)
    tables = {int(i): stm.tokenize(corpus[i]) for i in rows}
    routed_n = 0
    for case in range(STRUCT_CASES):
        data, lens, scores, _meta = step(base, case, torch.from_numpy(rows),
                                         packed.data, packed.lens, scores,
                                         scan_len=scan_len)
        want = {int(i): data[j, :int(lens[j])].numpy().tobytes()
                for j, i in enumerate(rows)}
        routed = [(i, c) for i, c in stats["struct_rows"][case]
                  if i in tables]
        if routed:
            src = torch.zeros((len(routed), cap), dtype=torch.uint8)
            for r, (i, _c) in enumerate(routed):
                src[r, :len(corpus[i])] = torch.frombuffer(
                    bytearray(corpus[i]), dtype=torch.uint8)
            out, olens, _app = struct_step(
                base, case, [i for i, _c in routed], src,
                torch.tensor([len(corpus[i]) for i, _c in routed]),
                torch.from_numpy(np.stack([tables[i][0] for i, _c in routed])),
                torch.tensor([tables[i][1] for i, _c in routed]),
                torch.full((len(routed),), cap), [c for _i, c in routed])
            for r, (i, _c) in enumerate(routed):
                want[i] = out[r, :int(olens[r])].numpy().tobytes()
        routed_n += len(routed)
        for i in rows:
            check(files[case * B + int(i)] == want[int(i)],
                  f"(b) row {int(i)} case {case}: the card's file != the "
                  "CPU port's bytes")
    return routed_n, time.perf_counter() - t


def struct_phase(rng, mixed, seed3, dev, card, with_off=False):
    """Phase 7: the structured-format engine (--struct host|device; with
    ``with_off`` also (b) with --struct off, one case)."""
    import shutil
    import tempfile

    import torch

    from erlamsa_tpu_torch.ops import cuda_build
    from erlamsa_tpu_torch.ops import tree_mutators as tm
    from erlamsa_tpu_torch.services.batchrunner import run_batch

    t_phase = time.perf_counter()
    struct_vs_cpu(rng, seed3, dev)
    corpus = struct_corpus(rng, BATCH)
    check(all(2049 <= len(s) <= 4096 for s in corpus),
          "(b) a structured seed is not 2049-4096 bytes (class 8192)")
    work = tempfile.mkdtemp(prefix="chip_smoke_struct_",
                            dir=cuda_build.BUILD_DIR)

    def run(rows, n, out, mode, device=dev, level=2, state=None):
        stats = {}
        opts = {"corpus": rows, "seed": seed3, "n": n, "output": out,
                "struct": mode, "_stats": stats}
        if state is not None:
            opts.update(state_path=state, checkpoint_every=1)
        check(run_batch(opts, batch=len(rows), device=device,
                        level=level) == 0,
              f"run_batch failed: --struct {mode} -n {n} -o {out}")
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return stats

    try:
        # (b) the structured corpus at full width, the full default set,
        # level 2, in each mode
        B, total = len(corpus), len(corpus) * STRUCT_CASES
        files, stats = {}, {}
        for mode, n in ((STRUCT_OFF,) if with_off else ()) + STRUCT_MODES:
            d = os.path.join(work, "b-" + mode)
            os.makedirs(d)
            reset_counts()
            before = tm.calls.get("cuda", 0)
            stats[mode] = st = run(corpus, n, os.path.join(d, "%n"), mode)
            got = counts()
            steps = tm.calls.get("cuda", 0) - before
            check(got["case_rounds"] == n and got["round_apply"] == 0,
                  f"(b) --struct {mode}: launches {got}, want the case "
                  "kernel once per case")
            check(steps == (n if mode == "device" else 0),
                  f"(b) --struct {mode}: {steps} struct steps on cuda")
            check(st["overflow"] == 0,
                  f"(b) --struct {mode}: {st['overflow']} rows overflowed")
            files[mode] = read_files(d, B * n)
            share = st["host_routed"] / (B * n)
            line = (f"struct (b) --struct {mode}: {B} structured seeds x "
                    f"{n} cases, 41 codes, ERLAMSA_PALLAS=2, "
                    f"{B * n / st['dt']:.1f} samples/s ({st['dt']:.2f}s), "
                    f"host-routed {st['host_routed']} ({share:.4f}), "
                    f"abandoned {st['abandoned']}, host wait "
                    f"{st['host_wait_s']:.2f}s against device "
                    f"{st['device_s']:.2f}s, case kernel launches "
                    f"{got['case_rounds']}")
            if mode != "off":
                per_case = [len(r) for r in st["struct_rows"]]
                line += (f"; struct-routed rows per case {per_case} of "
                         f"{st['struct_resident']} resident; tokenize "
                         f"{st['tokenize_s']:.2f}s at the start; "
                         f"{st['struct_bytes_uploaded']} B uploaded")
                if mode == "device":
                    line += ("; struct step per case " + ", ".join(
                        f"{ms:.3f}" for ms in st["struct_ms"])
                             + " ms (CUDA events)")
                check(all(per_case), f"(b) --struct {mode}: a case routed "
                      "no row to the struct engine")
            print(line + f"; card {card}")
        diff = sum(a != b for a, b in zip(files["device"], files["host"]))
        check(diff == 0, f"(b) {diff} files of --struct device differ from "
              "--struct host")
        changed = sum(f != corpus[i % B] for i, f in enumerate(files["device"]))
        check(changed > 0, "(b) --struct device mutated nothing")
        routed_n, cpu_s = struct_rows_vs_cpu(corpus, seed3, stats["device"],
                                             files["device"], 2)
        print(f"struct (b) --struct device == --struct host: {total} files "
              f"equal, {changed} changed; {CHECK_ROWS} rows x {STRUCT_CASES} "
              f"cases "
              f"== the CPU port ({routed_n} of them struct-routed; "
              f"{cpu_s:.1f}s on the CPU)")
        del files

        # (c) the 64-row mixed corpus, --struct device, on the card and
        # on the CPU at levels 2 and 0; at level 2 also stopped after
        # MIXED_SPLIT cases and resumed from --state
        n_rows = len(mixed)
        for level in (2, 0):
            cases = MIXED_CASES if level else MIXED_CASES_L0
            got, secs = {}, {}
            for name, device in (("card", dev), ("cpu", "cpu")):
                d = os.path.join(work, f"c{level}-{name}")
                os.makedirs(d)
                t = time.perf_counter()
                st = run(mixed, cases, os.path.join(d, "%n"), "device",
                         device=device, level=level)
                secs[name] = time.perf_counter() - t
                check(st["abandoned"] == 0,
                      f"(c) level {level} {name}: {st['abandoned']} abandoned")
                got[name] = read_files(d, n_rows * cases)
            diff = sum(a != b for a, b in zip(got["card"], got["cpu"]))
            check(diff == 0, f"(c) level {level}: {diff} files differ "
                  "between cuda and cpu with --struct device")
            note = ""
            if level == 2:
                d = os.path.join(work, "c2-resumed")
                os.makedirs(d)
                state = os.path.join(work, "c2.npz")
                run(mixed, MIXED_SPLIT, os.path.join(d, "%n"), "device",
                    state=state)
                st2 = run(mixed, MIXED_CASES, os.path.join(d, "%n"),
                          "device", state=state)
                check(st2["start_case"] == MIXED_SPLIT,
                      f"(c) resumed at {st2['start_case']}")
                check(read_files(d, n_rows * MIXED_CASES) == got["card"],
                      "(c) the resumed --struct device run differs from the "
                      "straight one")
                note = (f"; {MIXED_SPLIT} + {MIXED_CASES - MIXED_SPLIT} "
                        "cases resumed from --state == straight")
            print(f"struct (c) --struct device ERLAMSA_PALLAS="
                  f"{level or 'unset'}: {n_rows} mixed rows x {cases} "
                  f"cases, cuda == cpu ({secs['card']:.1f}s on the card, "
                  f"{secs['cpu']:.1f}s on the CPU){note}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"struct phase: {time.perf_counter() - t_phase:.1f}s")


# phase 8: the feedback corpus engine (corpus/runner.py, --feedback)
CAMPAIGN_SEEDS = 8192  # seeds in the campaign store
CAMPAIGN_MIN, CAMPAIGN_MAX = 64, 16384  # seed sizes, log-uniform
# (b): cases of the buckets sync and both --adopt runs, whose files are
# held against the first cases of a long run or each other; (c): cases
# of the resumed run, stopped after CAMPAIGN_SPLIT
CAMPAIGN_SHORT = 2
CAMPAIGN_SPLIT = 1  # (c): the case after which the run stops
CAMPAIGN_CPU_ROWS, CAMPAIGN_CPU_CASES = 64, 2  # (d): cuda == cpu
ARENA_PAGES = 4096  # (a): pages of the paged-op arena
# (b): the long runs' cases (4 before phase 9 came)
CAMPAIGN_LONG = 2
# (b): the runs, each from its own copy of the store, and their cases
CAMPAIGN_RUNS = (
    ("buckets async", CAMPAIGN_LONG, {"pipeline": "async",
                                      "layout": "buckets"}),
    ("buckets sync", CAMPAIGN_SHORT, {"pipeline": "sync",
                                      "layout": "buckets"}),
    ("arena async", CAMPAIGN_LONG, {"pipeline": "async",
                                    "layout": "arena"}),
    ("arena adopt", CAMPAIGN_SHORT, {"pipeline": "async", "layout": "arena",
                                     "adopt": True}),
    ("buckets adopt", CAMPAIGN_SHORT, {"pipeline": "async",
                                       "layout": "buckets", "adopt": True}),
)
# (b): the runs whose files must be equal, the shorter run's files
# against the same first files of the longer one
CAMPAIGN_EQUAL = (("buckets sync", "buckets async"),
                  ("arena async", "buckets async"),
                  ("arena adopt", "buckets adopt"))


def campaign_corpus(rng, count):
    """Seeds of 64 B to 16 KB, log-uniform, in the three shapes of
    seed_bytes: bucket capacities 256 to 32768."""
    sizes = np.exp(rng.uniform(np.log(CAMPAIGN_MIN), np.log(CAMPAIGN_MAX),
                               count))
    return [seed_bytes(rng, i, int(n)) for i, n in enumerate(sizes)]


def build_store(root, seed):
    """The campaign corpus into a CorpusStore at ``root``, one add per
    seed as an import does; its seconds go to root/build.json. Run in a
    process of its own (``--build-store``) while phases 1-3 run: each add
    fsyncs its seed and rewrites the whole corpus.json."""
    from erlamsa_tpu_torch.corpus.store import CorpusStore

    corpus = campaign_corpus(np.random.default_rng(seed + 3),
                             CAMPAIGN_SEEDS)
    t = time.perf_counter()
    store = CorpusStore(os.path.join(root, "store"))
    for s in corpus:
        store.add(s, origin="import")
    secs = time.perf_counter() - t
    with open(os.path.join(root, "build.json"), "w") as f:
        json.dump({"seconds": secs, "seeds": len(store),
                   "bytes": sum(len(s) for s in corpus)}, f)
    return 0


def copy_store(src, dst):
    """A store copy whose seed files are hard links: the store never
    writes a seed file in place (new files and corpus.json land by
    rename), so the copies cannot reach each other."""
    import shutil

    shutil.copytree(src, dst, copy_function=os.link)
    return dst


def digests(d, count):
    """sha1 of the files 0..count-1 a run wrote to d."""
    import hashlib

    out = []
    for i in range(count):
        with open(os.path.join(d, str(i)), "rb") as f:
            out.append(hashlib.sha1(f.read()).digest())
    return out


def paged_vs_cpu(rng, dev):
    """Phase 8 (a): each paged op on a [ARENA_PAGES, 256] arena, then a
    DeviceArena sequence (admission, tables, gathers, eviction, spills
    full and injected, device-side adoption, defrag), on the card == on
    the CPU, byte for byte (every page but the trash page, whose content
    is undefined)."""
    import torch

    from erlamsa_tpu_torch.ops import paged

    P, W = ARENA_PAGES, paged.PAGE
    host = rng.integers(0, 256, (P, W), dtype=np.uint8)
    host[paged.ZERO_PAGE] = 0
    live = rng.permutation(np.arange(paged.RESERVED_PAGES, P))
    rows, run = 256, 8
    table = live[:rows * run].reshape(rows, run).astype(np.int32)
    table[rows // 2:, run // 2:] = paged.ZERO_PAGE
    wtable = np.where(table == paged.ZERO_PAGE, paged.TRASH_PAGE, table)
    data = rng.integers(0, 256, (rows, run * W), dtype=np.uint8)
    src = rng.integers(0, 256, (rows, run * W), dtype=np.uint8)
    pick = rng.integers(0, rows, rows).astype(np.int32)
    lens = rng.integers(0, run * W + 1, rows).astype(np.int32)
    idx = np.concatenate([live[:1000], np.full(24, paged.TRASH_PAGE)])
    pages = rng.integers(0, 256, (len(idx), W), dtype=np.uint8)
    perm = np.arange(P, dtype=np.int32)
    perm[paged.RESERVED_PAGES:] = live
    ops = {
        "gather": lambda a, t: paged.gather_rows(a, table),
        "scatter": lambda a, t: paged.scatter_rows(a, wtable, t(data)),
        "adopt": lambda a, t: paged.adopt_rows(a, t(src), pick, wtable,
                                               lens),
        "upload": lambda a, t: paged.upload_pages(a, idx.astype(np.int32),
                                                  pages),
        "permute": lambda a, t: paged.permute_pages(a, perm),
    }
    keep = np.arange(P) != paged.TRASH_PAGE
    for name, op in ops.items():
        got = {}
        for d in (dev, "cpu"):
            a = torch.from_numpy(host.copy()).to(d)
            res = op(a, lambda x, d=d: torch.from_numpy(x).to(d))
            res = res.cpu().numpy()
            got[str(d)] = res if name == "gather" else res[keep]
        check(np.array_equal(got[str(dev)], got["cpu"]),
              f"(a) paged {name}: cuda != cpu")
    seq = {str(d): arena_sequence(d) for d in (dev, "cpu")}
    check(seq[str(dev)] == seq["cpu"],
          "(a) the DeviceArena sequence differs between cuda and cpu")
    stats = seq["cpu"][-1][1]
    check(stats["spills"] >= 2 and stats["adopted"] >= 1
          and stats["defrags"] == 1,
          f"(a) the sequence did not reach spills, adoption and defrag: "
          f"{stats}")
    print(f"feedback (a) paged gather, scatter, adopt, upload, permute on "
          f"[{P}, {W}] ({rows} rows x {run} pages) and a DeviceArena "
          f"sequence (spills {stats['spills']}, evictions "
          f"{stats['evictions']}, adopted {stats['adopted']}, defrags "
          f"{stats['defrags']}): cuda == cpu, tolerance 0")


def arena_sequence(device):
    """One scripted DeviceArena run on ``device``: the stats, tables,
    gathered rows and pages (trash page left out) after each step."""
    import torch

    from erlamsa_tpu_torch.corpus.arena import TRASH_PAGE, DeviceArena
    from erlamsa_tpu_torch.corpus.assembler import bucket_capacity
    from erlamsa_tpu_torch.services import chaos

    obs = []
    rng = np.random.default_rng(8)
    ar = DeviceArena(96, page=256, classes=(256, 4096, 32768),
                     classify=bucket_capacity, device=device)
    seeds = {f"s{i:02d}": bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
             for i, n in enumerate(rng.integers(1, 20000, 24))}

    def snap(tag):
        pages = ar._arena.cpu().numpy()
        keep = np.arange(pages.shape[0]) != TRASH_PAGE
        obs.append((tag, ar.stats(), pages[keep].tobytes()))

    for sid, data in seeds.items():
        ar.ensure(sid, data, tick=0)
    ar.flush()
    snap("admit")
    for tick in (1, 2):
        sids = list(rng.choice(list(seeds), 16))
        for g in ar.tables_for(sids, [seeds[s] for s in sids], tick=tick):
            obs.append(("table", g.capacity, g.rows.tolist(),
                        g.table.tolist(), g.spilled,
                        ar.gather(g.table).cpu().numpy().tobytes()))
        snap(f"case {tick}")
    chaos.configure("arena.spill:x2", seed=13)
    try:
        obs.append(("forced", [ar.ensure(f"f{i}", b"xy" * 50, tick=3)
                               for i in range(3)]))
    finally:
        chaos.configure(None)
    out = torch.from_numpy(rng.integers(0, 256, (8, 4096),
                                        dtype=np.uint8)).to(device)
    for j in range(4):
        ar.enqueue_adopt(f"a{j}", int(rng.integers(1, 4097)), out, j)
    obs.append(("adopted", ar.adopt_pending(tick=4)))
    snap("adopt")
    ar.defrag()
    snap("defrag")
    return obs


def campaign_run(name, store, out, seed3, n, batch, device, **extra):
    """One run_corpus_batch run (the loop behind ``python -m
    erlamsa_tpu_torch --feedback --corpus DIR``) at level 2 with the 30
    device codes, its files to out/%n: returns (stats, metrics snapshot,
    launches, digests of its files, seconds, peak device bytes). It fails
    unless the run returns 0, undegraded, with the case kernel once per
    class a case on the card."""
    import torch

    from erlamsa_tpu_torch.corpus.runner import run_corpus_batch
    from erlamsa_tpu_torch.ops.registry import DEVICE_CODES
    from erlamsa_tpu_torch.oracle.mutations import default_mutations
    from erlamsa_tpu_torch.services import metrics

    os.makedirs(out, exist_ok=True)
    stats = {}
    opts = {"corpus_dir": store, "seed": seed3, "n": n, "feedback": True,
            "mutations": [(c, p) for c, p in default_mutations()
                          if c in DEVICE_CODES], "_stats": stats,
            "output": os.path.join(out, "%n"), **extra}
    on_cuda = torch.device(device).type == "cuda"
    metrics.GLOBAL = metrics.Counters()
    reset_counts()
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    check(run_corpus_batch(opts, batch=batch, device=device, level=2) == 0,
          f"{name}: the run failed")
    if on_cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = counts()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    snap = metrics.GLOBAL.snapshot()
    res = snap["resilience"]
    check(not res["degraded"] and not res["events"].get("device_lost"),
          f"{name}: degraded {res['degraded']}, events {res['events']}")
    # one step per class a case, each launching the case kernel once
    steps = sum(b["batches"] for b in stats["buckets"].values())
    if on_cuda:
        check(launches["case_rounds"] == steps >= len(stats["schedules"])
              and launches["round_apply"] == 0,
              f"{name}: launches {launches}, want the case kernel once "
              f"per class a case ({steps} steps)")
    return stats, snap, launches, digests(out, batch * n), secs, peak


def feedback_phase(seed, seed3, dev, card, build):
    """Phase 8: the feedback corpus engine through run_corpus_batch (the
    loop behind ``python -m erlamsa_tpu_torch --feedback --corpus DIR``)
    on the campaign store ``build`` (the --build-store process started
    with the script) makes."""
    import shutil
    import tempfile

    from erlamsa_tpu_torch.corpus.store import CorpusStore
    from erlamsa_tpu_torch.ops import cuda_build
    from erlamsa_tpu_torch.ops.registry import DEVICE_CODES
    from erlamsa_tpu_torch.oracle.mutations import default_mutations

    t_phase = time.perf_counter()
    paged_vs_cpu(np.random.default_rng(seed + 4), dev)
    proc, root = build
    t = time.perf_counter()
    check(proc.wait(timeout=900) == 0, "the store build failed")
    waited = time.perf_counter() - t
    with open(os.path.join(root, "build.json")) as f:
        built = json.load(f)
    store_dir = os.path.join(root, "store")
    check(built["seeds"] == CAMPAIGN_SEEDS,
          f"the store holds {built['seeds']} seeds")
    print(f"feedback store: {built['seeds']} seeds, {built['bytes']} B, "
          f"built in {built['seconds']:.1f}s (one add per seed, a process "
          f"of its own started with the script; phase 8 waited "
          f"{waited:.1f}s)")
    dev_set = [(c, p) for c, p in default_mutations() if c in DEVICE_CODES]
    work = tempfile.mkdtemp(prefix="chip_smoke_feedback_",
                            dir=cuda_build.BUILD_DIR)
    n_copy = [0]

    def run(name, n=CASES, batch=BATCH, device=dev, out=None, store=None,
            state=None, **extra):
        """campaign_run on a fresh copy of the store (or ``store``), its
        files to a fresh directory (or ``out``), which it returns too."""
        n_copy[0] += 1
        store = store or copy_store(store_dir, os.path.join(
            work, f"store{n_copy[0]}"))
        out = out or os.path.join(work, f"out{n_copy[0]}")
        if state is not None:
            extra.update(state_path=state, checkpoint_every=1)
        return (*campaign_run(name, store, out, seed3, n, batch, device,
                              **extra), out)

    try:
        # (b) the campaign: each run from its own copy of the store
        runs, rates = {}, {}
        for name, n, extra in CAMPAIGN_RUNS:
            st, snap, launches, files, secs, peak, out = run(name, n=n,
                                                             **extra)
            runs[name] = files
            total = st["total"]
            rates[name] = total / st["dt"]
            check(total == BATCH * n, f"(b) {name}: {total} samples")
            rows = sum(b["rows"] for b in st["buckets"].values())
            waste = sum(b["padded_bytes_wasted"]
                        for b in st["buckets"].values())
            stages = ", ".join(
                f"{k} {snap['pipeline']['stages'].get(k, 0.0):.3f}"
                for k in ("schedule", "assemble", "dispatch", "drain_wait",
                          "hash", "write"))
            widths = sorted({w for _r, w, _s in st["step_shapes"]})
            line = (f"feedback (b) {name}: {BATCH} x {n} cases, "
                    f"ERLAMSA_PALLAS=2, 30 device codes, "
                    f"{total / st['dt']:.1f} samples/s ({st['dt']:.2f}s in "
                    f"the loop, {secs:.2f}s the call), "
                    f"{st['bytes_uploaded'] / total:.1f} B uploaded/sample, "
                    f"{waste / max(rows, 1):.1f} padded B wasted/sample, "
                    f"{len(st['step_shapes'])} step shapes (rows, width, "
                    f"scan) {st['step_shapes']}, stages s: {stages}, case "
                    f"kernel launches "
                    f"{launches['case_rounds']}, {st['new_hashes']} novel "
                    f"hashes, {st['offspring']} offspring, peak device "
                    f"memory {peak} B")
            if "arena" in st:
                ar = st["arena"]
                check(ar["spills"] == 0, f"(b) {name}: {ar['spills']} spills")
                line += (f"; arena {ar['pages']} x {ar['page_size']} B = "
                         f"{ar['pages'] * ar['page_size']} B resident, "
                         f"{ar['resident_seeds']} seeds, occupancy "
                         f"{ar['occupancy']}, uploads {ar['uploads']} "
                         f"({ar['bytes_uploaded']} B), adopted "
                         f"{ar['adopted']}, evictions {ar['evictions']}, "
                         "classes " + ", ".join(
                             f"{c}: {v['resident_seeds']}"
                             for c, v in ar["classes"].items()))
            print(line + f"; card {card}")
            if name == "buckets async":
                check(widths == [256 << k for k in range(8)],
                      f"(b) the classes span {widths}, want 256-32768")
                seen = CorpusStore(os.path.join(work, "store1"))
                seed_d = digests_of(
                    [seen.get(s) for ids in st["schedules"] for s in ids])
                changed = sum(a != b for a, b in zip(files, seed_d))
                check(changed > 0, "(b) nothing was mutated")
            shutil.rmtree(out)
        for a, b in CAMPAIGN_EQUAL:
            k = min(len(runs[a]), len(runs[b]))
            diff = sum(x != y for x, y in zip(runs[a], runs[b]))
            check(k >= BATCH * CAMPAIGN_SHORT and diff == 0,
                  f"(b) {diff} of the first {k} files of {a} differ from "
                  f"{b}")
        print("feedback (b) files equal: " + "; ".join(
            f"{a} == {b} ({min(len(runs[a]), len(runs[b]))} files)"
            for a, b in CAMPAIGN_EQUAL)
              + f"; {changed} of buckets async's differ from their "
              "scheduled seed")

        # (c) arena async stopped after CAMPAIGN_SPLIT cases and resumed
        # to CAMPAIGN_SHORT == the first cases of (b)'s straight run
        store = copy_store(store_dir, os.path.join(work, "store-c"))
        state = os.path.join(work, "c.npz")
        out = os.path.join(work, "out-c")
        run("(c) first part", n=CAMPAIGN_SPLIT, store=store, out=out,
            state=state, pipeline="async", layout="arena")
        st2, _snap, _l, files, secs, _p, _o = run(
            "(c) resumed", n=CAMPAIGN_SHORT, store=store, out=out,
            state=state, pipeline="async", layout="arena")
        check(len(st2["schedules"]) == CAMPAIGN_SHORT - CAMPAIGN_SPLIT,
              f"(c) the resumed run scheduled {len(st2['schedules'])} cases")
        check(files == runs["arena async"][:len(files)],
              "(c) the resumed arena run differs from the straight one")
        print(f"feedback (c) arena async {CAMPAIGN_SPLIT} + "
              f"{CAMPAIGN_SHORT - CAMPAIGN_SPLIT} cases resumed from --state "
              f"== straight ({len(files)} files; resumed part {secs:.2f}s)")
        shutil.rmtree(out)

        # (e) the CLI in a process of its own == (b)'s arena async run,
        # started here so that it runs beside (d)'s CPU legs
        store = copy_store(store_dir, os.path.join(work, "store-e"))
        out_e = os.path.join(work, "out-e")
        os.makedirs(out_e)
        mfile = os.path.join(work, "e-metrics.json")
        here = os.path.dirname(os.path.abspath(__file__))
        t_e = time.perf_counter()
        with open(os.path.join(work, "e.log"), "w+") as log:
            cli = subprocess.Popen(
                [sys.executable, "-m", "erlamsa_tpu_torch", "--feedback",
                 "--corpus", store, "--layout", "arena", "-s",
                 ",".join(map(str, seed3)), "-n", str(CAMPAIGN_LONG), "--batch",
                 str(BATCH), "-m", ",".join(f"{c}={p}" for c, p in dev_set),
                 "-o", os.path.join(out_e, "%n"), "--metrics-out", mfile],
                cwd=here, env=dict(os.environ, ERLAMSA_PALLAS="2"),
                stdout=log, stderr=log)
            try:
                # (d) the card == the CPU port, both layouts
                for layout in ("buckets", "arena"):
                    got, secs = {}, {}
                    for d in (dev, "cpu"):
                        _st, _sn, _l, got[str(d)], secs[str(d)], _p, o = run(
                            f"(d) {layout} on {d}", n=CAMPAIGN_CPU_CASES,
                            batch=CAMPAIGN_CPU_ROWS, device=d, layout=layout)
                        shutil.rmtree(o)
                    check(got[str(dev)] == got["cpu"],
                          f"(d) {layout}: cuda != cpu")
                    print(f"feedback (d) {layout}: {CAMPAIGN_CPU_ROWS} rows "
                          f"x {CAMPAIGN_CPU_CASES} cases, cuda == cpu "
                          f"({secs[str(dev)]:.1f}s on the card, "
                          f"{secs['cpu']:.1f}s on the CPU)")
                rc = cli.wait(timeout=600)
            finally:
                if cli.poll() is None:
                    cli.kill()
                    cli.wait()
            secs = time.perf_counter() - t_e
            log.seek(0)
            said = log.read()
        check(rc == 0, "(e) the CLI failed: " + said[-2000:])
        with open(mfile) as f:
            resil = json.load(f)["resilience"]
        check(not resil["degraded"] and not resil["events"].get("device_lost"),
              f"(e) the CLI run degraded: {resil}")
        check(digests(out_e, BATCH * CAMPAIGN_LONG) == runs["arena async"],
              "(e) the CLI's files differ from the in-process arena run")
        last = [ln for ln in said.splitlines() if ln.startswith("# ")]
        print(f"feedback (e) python -m erlamsa_tpu_torch --feedback --corpus "
              f"DIR --layout arena (ERLAMSA_PALLAS=2, its own process beside "
              f"(d), {secs:.1f}s) == the in-process arena async run "
              f"({BATCH * CAMPAIGN_LONG} files); it said: "
              f"{last[-1] if last else ''}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"feedback phase: {time.perf_counter() - t_phase:.1f}s")
    return rates["arena adopt"]


# phase 9: the FaaS serving tier (services/faas.py, ``-H``): engines,
# load and the CLI. The CLI's defaults: continuous, 64 slots x 16384 B,
# --queue-cap 1024; the flush engine at --batch 1024
SERVE_CAPACITY, SERVE_SLOTS, SERVE_QUEUE = 16384, 64, 1024
SERVE_CLASSES = (256, 4096, 16384)
SERVE_MIXED = 256  # (a) mixed payloads, level 2
SERVE_LEVEL_REQUESTS = 64  # (a) levels 1 and 0, card == CPU
SERVE_CPU_ROWS = 64  # (a) level-2 rows held against the CPU plain path
SERVE_FLUSH_ROWS = 64  # (a) the flush engine's batch
LOAD_REQUESTS, LOAD_CONNECTIONS, LOAD_CLIENTS = 10_000, 512, 2  # (b)
LOAD_OVERSIZE = 8  # (b) requests over 16384 B: the oracle escape
LOAD_FLUSH_BATCH = 1024  # (b) the flush engine's batch (--batch)
LOAD_FLUSH_REQUESTS = 2_500  # (b) the flush load's requests
BURST_REQUESTS, BURST_BYTES = 2048, 4096  # (c)

LOAD_CLIENT = r"""
import asyncio, hashlib, json, sys, time
port, conns, payload_path, items_path, out_path = sys.argv[1:6]
with open(payload_path, "rb") as f:
    blob = f.read()
payloads, off = [], 0
while off < len(blob):
    n = int.from_bytes(blob[off:off + 8], "little")
    payloads.append(blob[off + 8:off + 8 + n])
    off += 8 + n
with open(items_path) as f:
    items = json.load(f)

async def client(queue, results):
    reader, writer = await asyncio.open_connection("127.0.0.1", int(port))
    try:
        while not queue.empty():
            pos, idx = queue.get_nowait()
            body = payloads[idx]
            t0 = time.perf_counter()
            writer.write(b"POST /erlamsa/erlamsa_esi:fuzz HTTP/1.1\r\n"
                         b"Host: 127.0.0.1\r\nContent-Length: %d\r\n\r\n"
                         % len(body) + body)
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            status = int(head.split(b" ", 2)[1])
            n = 0
            for line in head.split(b"\r\n")[1:]:
                name, _, value = line.partition(b":")
                if name.strip().lower() == b"content-length":
                    n = int(value)
            data = await reader.readexactly(n)
            results.append([pos, idx, status, time.perf_counter() - t0, n,
                            hashlib.sha1(data).hexdigest()])
    finally:
        writer.close()

async def main():
    queue = asyncio.Queue()
    for pos, idx in items:
        queue.put_nowait((pos, idx))
    results = []
    print("ready", flush=True)
    sys.stdin.readline()
    t0 = time.time()
    await asyncio.gather(*(client(queue, results) for _ in range(int(conns))))
    with open(out_path, "w") as f:
        json.dump({"start": t0, "end": time.time(), "results": results}, f)

asyncio.run(main())
"""


def serve_payloads(rng, count):
    """Payloads of 64 B to 16 KB, log-uniform, in the three shapes of
    seed_bytes."""
    sizes = np.exp(rng.uniform(np.log(64), np.log(16384), count))
    return [seed_bytes(rng, i, int(n)) for i, n in enumerate(sizes)]


def serve_load(port, payloads, items, work, tag):
    """``items`` (payload indices) over LOAD_CONNECTIONS keep-alive
    connections from LOAD_CLIENTS load processes (stdlib asyncio, no
    torch), all released at once. Returns (wall seconds, results): one
    [position, payload index, status, seconds, length, sha1] per
    request."""
    ppath = os.path.join(work, "payloads.bin")
    with open(ppath, "wb") as f:
        for p in payloads:
            f.write(len(p).to_bytes(8, "little") + p)
    procs = []
    try:
        for c in range(LOAD_CLIENTS):
            ipath = os.path.join(work, f"{tag}-items-{c}.json")
            with open(ipath, "w") as f:
                json.dump([[pos, idx] for pos, idx in enumerate(items)
                           if pos % LOAD_CLIENTS == c], f)
            procs.append((subprocess.Popen(
                [sys.executable, "-c", LOAD_CLIENT, str(port),
                 str(LOAD_CONNECTIONS // LOAD_CLIENTS), ppath, ipath,
                 os.path.join(work, f"{tag}-out-{c}.json")],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True),
                os.path.join(work, f"{tag}-out-{c}.json")))
        for proc, _out in procs:
            check(proc.stdout.readline().strip() == "ready",
                  f"({tag}) a load client did not start")
        for proc, _out in procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        spans, results = [], []
        for proc, out in procs:
            check(proc.wait(timeout=600) == 0, f"({tag}) a load client failed")
            with open(out) as f:
                got = json.load(f)
            spans.append((got["start"], got["end"]))
            results += got["results"]
    finally:
        for proc, _out in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdin.close()
            proc.stdout.close()
    wall = max(e for _s, e in spans) - min(s for s, _e in spans)
    check(len(results) == len(items), f"({tag}) {len(results)} answers for "
          f"{len(items)} requests")
    return wall, sorted(results)


def single_shots(pairs, capacity, dev, level, seed3):
    """The port's flush step in one call over (rid, payload) pairs."""
    from erlamsa_tpu_torch.ops import prng
    from erlamsa_tpu_torch.ops.slots import make_request_step

    step = make_request_step(capacity, len(pairs), device=dev, level=level)
    data = np.zeros((len(pairs), capacity), np.uint8)
    lens = np.zeros(len(pairs), np.int32)
    for i, (_rid, p) in enumerate(pairs):
        data[i, :len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    out, n = step(prng.base_key(seed3), np.array([r for r, _p in pairs],
                                                 np.int32), data, lens)
    out, n = out.cpu().numpy(), n.cpu().numpy()
    return [bytes(out[i, :int(n[i])]) for i in range(len(pairs))]


def submit_all(engine, payloads):
    """Every payload admitted in order (request ids 0, 1, ...), then
    every answer awaited."""
    reqs = [engine.submit(p, {}) for p in payloads]
    for r in reqs:
        check(r.done.wait(300), "a serving request timed out")
    check([r.rid for r in reqs] == list(range(len(payloads))),
          "request ids are not the submit order")
    return [r.result for r in reqs]


def settle(engine, served) -> None:
    """Wait until the drain has counted ``served`` requests and, for the
    continuous engine, every slot is home (a client can read its answer
    just before the drain counts it)."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        home = (not hasattr(engine, "_free")
                or sorted(engine._free) == list(range(engine.slots)))
        if engine.served >= served and home:
            return
        time.sleep(0.01)
    check(False, f"served {engine.served} of {served}, free list "
          f"{getattr(engine, '_free', None)}")


def burst(engine, port, payload, work, dev, seed3) -> None:
    """(c): BURST_REQUESTS concurrent requests of one payload to a fresh
    continuous server: the answers are the single-shot bytes of request
    ids 0..BURST_REQUESTS-1."""
    import hashlib

    t = time.perf_counter()
    _wall, res = serve_load(port, [payload], [0] * BURST_REQUESTS, work,
                            "burst")
    settle(engine, BURST_REQUESTS)
    want = single_shots([(r, payload) for r in range(BURST_REQUESTS)],
                        SERVE_CAPACITY, dev, 2, seed3)
    check(sorted(r[5] for r in res) ==
          sorted(hashlib.sha1(w).hexdigest() for w in want),
          f"(c) the burst's answers != the single-shot bytes of request "
          f"ids 0..{BURST_REQUESTS - 1}")
    print(f"serving (c) {BURST_REQUESTS} concurrent requests of one "
          f"{len(payload)} B payload: {engine.steps} steps, the answers == "
          f"the single-shot step's at batch {BURST_REQUESTS} for request "
          f"ids 0..{BURST_REQUESTS - 1} ({len(set(r[5] for r in res))} "
          f"distinct; {time.perf_counter() - t:.1f}s)")


def serving_faults(engine, events0, where):
    """No give-up, step retry or supervisor restart since ``events0``."""
    from erlamsa_tpu_torch.services import metrics, supervisor

    events = metrics.GLOBAL.event_counts()
    moved = {k: v - events0.get(k, 0) for k, v in events.items()
             if k in ("serving_give_up", "retry:serving.step",
                      "retry:batcher.step") and v != events0.get(k, 0)}
    crashed = {name: st["crashes"] for name, st in
               supervisor.thread_stats().items()
               if name.startswith(("serving-", "tpu-batcher-",
                                   "fuzzproxy-"))
               and st["crashes"]}
    check(not moved and not crashed and engine.failed == 0,
          f"{where}: faults {moved}, supervisor restarts {crashed}, "
          f"{engine.failed} empty give-ups")


def serving_phase(seed, seed3, dev, card, profile=False):
    """Phase 9: the FaaS serving tier (``python -m erlamsa_tpu_torch -H``):
    (a) engine bytes, (b) the BASELINE.json configs[3] load through
    serve() in both modes, (c) a concurrent burst's bytes, (d) the CLI in
    a process of its own."""
    import hashlib
    import tempfile
    import threading
    import urllib.request

    import torch

    from erlamsa_tpu_torch.ops.slots import STEP_CACHE
    from erlamsa_tpu_torch.services import metrics
    from erlamsa_tpu_torch.services.batcher import TpuBatcher
    from erlamsa_tpu_torch.services.faas import serve
    from erlamsa_tpu_torch.services.serving import ContinuousEngine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 9)
    payloads = serve_payloads(rng, SERVE_MIXED)
    pairs = list(enumerate(payloads))

    # (a) engine-level bytes: level 2 on the card == the single-shot step
    # on the card, 64 rows == the CPU plain path; the multi-class engine
    # and the flush engine give the same bytes; levels 1 and 0 == the CPU
    t = time.perf_counter()
    events0 = metrics.GLOBAL.event_counts()
    eng = ContinuousEngine(capacity=SERVE_CAPACITY, slots=SERVE_SLOTS,
                           seed=seed3, device=dev, level=2)
    reset_counts()
    t_steps = time.perf_counter()
    got = submit_all(eng, payloads)
    t_steps = time.perf_counter() - t_steps
    launches = counts()["case_rounds"]
    check(launches == eng.steps, f"(a) {launches} case-kernel launches in "
          f"{eng.steps} steps")
    want = single_shots(pairs, SERVE_CAPACITY, dev, 2, seed3)
    check(got == want, "(a) the continuous engine != the single-shot step")
    cpu = single_shots(pairs[:SERVE_CPU_ROWS], SERVE_CAPACITY, "cpu", 2,
                       seed3)
    check(cpu == want[:SERVE_CPU_ROWS], "(a) level 2: cuda != cpu")
    multi = ContinuousEngine(slots=SERVE_SLOTS, seed=seed3,
                             classes=SERVE_CLASSES, device=dev, level=2)
    reset_counts()
    got_m = submit_all(multi, payloads)
    check(counts()["case_rounds"] == multi.steps,
          "(a) multi-class: not one case-kernel launch per pool step")
    for cap in SERVE_CLASSES:
        lo = max([c for c in SERVE_CLASSES if c < cap], default=0)
        sub = [(r, p) for r, p in pairs if lo < len(p) <= cap]
        check(sub, f"(a) no payload routes to class {cap}")
        check([got_m[r] for r, _p in sub] ==
              single_shots(sub, cap, dev, 2, seed3),
              f"(a) multi-class != the single-shot step at width {cap}")
    flush = TpuBatcher(batch=SERVE_FLUSH_ROWS, capacity=SERVE_CAPACITY,
                       seed=seed3, device=dev, level=2)
    check(submit_all(flush, payloads) == want,
          "(a) the flush engine != the continuous engine")
    for e in (eng, multi, flush):
        serving_faults(e, events0, "(a)")
    print(f"serving (a) level 2: {SERVE_MIXED} payloads of "
          f"{min(map(len, payloads))}-{max(map(len, payloads))} B in order "
          f"through ContinuousEngine ({eng.steps} steps of {SERVE_SLOTS} x "
          f"{SERVE_CAPACITY}, {t_steps / eng.steps * 1000:.1f} ms a step "
          f"with no HTTP server beside it, {launches} case-kernel "
          f"launches) == the "
          f"single-shot step on the card, {SERVE_CPU_ROWS} == the CPU; "
          f"classes {SERVE_CLASSES} ({multi.steps} pool steps) and "
          f"TpuBatcher ({flush.flushes} flushes of {SERVE_FLUSH_ROWS}) equal "
          f"({time.perf_counter() - t:.1f}s)")
    if profile:
        profile_slot_step(payloads, seed3, dev, card)
    level_pairs = pairs[:SERVE_LEVEL_REQUESTS]
    for level in (1, 0):
        t = time.perf_counter()
        e = ContinuousEngine(capacity=SERVE_CAPACITY, slots=SERVE_SLOTS,
                             seed=seed3, device=dev, level=level)
        reset_counts()
        got_l = submit_all(e, [p for _r, p in level_pairs])
        used = counts()
        t_card = time.perf_counter() - t
        check(got_l == single_shots(level_pairs, SERVE_CAPACITY, "cpu",
                                    level, seed3),
              f"(a) level {level}: cuda != cpu")
        check(used["case_rounds"] == 0 and
              (used["round_apply"] > 0) == (level == 1),
              f"(a) level {level} launched {used}")
        serving_faults(e, events0, f"(a) level {level}")
        print(f"serving (a) level {level}: {len(level_pairs)} requests, "
              f"{e.steps} steps, {used['round_apply']} round-kernel "
              f"launches, cuda == cpu ({t_card:.1f}s on the card, "
              f"{time.perf_counter() - t - t_card:.1f}s on the CPU)")

    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        # (d)'s CLI starts now, in a process of its own, and is asked
        # after (b)
        here = os.path.dirname(os.path.abspath(__file__))
        cli_port = free_port()
        cli_log = open(os.path.join(work, "cli.log"), "w+")
        cli = subprocess.Popen(
            [sys.executable, "-m", "erlamsa_tpu_torch", "-s",
             ",".join(map(str, seed3)), "-H", f"127.0.0.1:{cli_port}"],
            cwd=here, env=dict(os.environ, ERLAMSA_PALLAS="2"),
            stdout=subprocess.PIPE, stderr=cli_log, text=True)
        killer = threading.Timer(300, cli.kill)
        killer.start()
        try:
            # (b) the configs[3] load over 512 keep-alive connections, 8
            # requests over the top width, in both modes; the continuous
            # server first answers (c)'s burst
            big = [seed_bytes(rng, i, SERVE_CAPACITY + 1 + 512 * i)
                   for i in range(LOAD_OVERSIZE)]
            load_payloads = payloads + big
            one = seed_bytes(rng, 1, BURST_BYTES)
            for mode, n_req in (("continuous", LOAD_REQUESTS),
                                ("flush", LOAD_FLUSH_REQUESTS)):
                items = [i % SERVE_MIXED for i in range(n_req)]
                for k in range(LOAD_OVERSIZE):  # early, so none ends it
                    items[1 + k * (n_req // (4 * LOAD_OVERSIZE))] = \
                        SERVE_MIXED + k
                port = free_port()
                srv = serve("127.0.0.1", port,
                            {"seed": seed3, "serving": mode,
                             "capacity": SERVE_CAPACITY,
                             "slots": SERVE_SLOTS, "queue_cap": SERVE_QUEUE},
                            backend="tpu", batch=LOAD_FLUSH_BATCH,
                            block=False, device=dev, level=2)
                engine = srv.RequestHandlerClass.batcher
                try:
                    if mode == "continuous":
                        burst(engine, port, one, work, dev, seed3)
                    st0 = engine.stats()
                    comp0 = STEP_CACHE.stats()["compiles"]
                    events0 = metrics.GLOBAL.event_counts()
                    rejected0 = sum(metrics.GLOBAL.snapshot()["rejected"]
                                    .values())
                    stages0 = dict(
                        metrics.GLOBAL.snapshot()["pipeline"]["stages"])
                    torch.cuda.reset_peak_memory_stats()
                    reset_counts()
                    wall, res = serve_load(port, load_payloads, items, work,
                                           mode)
                    settle(engine, st0["served"] + n_req - LOAD_OVERSIZE)
                    launches = counts()["case_rounds"]
                    peak = torch.cuda.max_memory_allocated()
                    st = engine.stats()
                    stage = ("serving_drain" if mode == "continuous"
                             else "batcher_drain")
                    stages = metrics.GLOBAL.snapshot()["pipeline"]["stages"]
                    step_s = stages[stage] - stages0.get(stage, 0.0)
                finally:
                    srv.shutdown()
                    srv.server_close()
                steps, served, escapes = (st[k] - st0[k] for k in
                                          ("steps", "served", "escapes"))
                statuses = sorted({r[2] for r in res})
                check(statuses == [200], f"(b) {mode}: statuses {statuses}")
                check(sum(metrics.GLOBAL.snapshot()["rejected"].values())
                      == rejected0, f"(b) {mode}: requests were shed")
                width = (engine.width if mode == "continuous"
                         else engine.capacity)
                long = [r for r in res if r[1] < SERVE_MIXED and r[4] > width]
                check(not long,
                      f"(b) {mode}: {len(long)} answers over {width} B")
                check(escapes == LOAD_OVERSIZE,
                      f"(b) {mode}: {escapes} oracle escapes")
                check(served == n_req - LOAD_OVERSIZE,
                      f"(b) {mode}: served {served}")
                check(launches == steps, f"(b) {mode}: {launches} "
                      f"case-kernel launches in {steps} steps")
                check(STEP_CACHE.stats()["compiles"] == comp0,
                      f"(b) {mode}: a step was built on the request path")
                serving_faults(engine, events0, f"(b) {mode}")
                lat = np.array([r[3] for r in res])
                esc_ms = max(r[3] for r in res if r[1] >= SERVE_MIXED) * 1000
                rows = st["slots"]
                print(f"serving (b) {mode} (level 2, {rows} rows x "
                      f"{st['width']} B, --queue-cap {SERVE_QUEUE}): "
                      f"{n_req} requests from {LOAD_CONNECTIONS} "
                      f"keep-alive connections in {wall:.2f}s: "
                      f"{n_req / wall:.1f} requests/s, latency p50 "
                      f"{np.percentile(lat, 50) * 1000:.1f} ms, p99 "
                      f"{np.percentile(lat, 99) * 1000:.1f} ms; {steps} "
                      f"steps, {step_s / steps * 1000:.1f} ms a step from "
                      f"dispatch to results on the host, fill "
                      f"{served / (steps * rows):.4f} "
                      f"(EWMA {st['fill_efficiency']}), "
                      f"{steps / served:.4f} steps per request, "
                      f"{launches} case-kernel launches, {escapes} oracle "
                      f"escapes (slowest {esc_ms:.1f} ms), peak device "
                      f"memory {peak} B; all 200, none shed, no give-up, "
                      f"fault or restart; card {card}")

            # (d) the CLI in a process of its own answers request id 0
            t = time.perf_counter()
            line = cli.stdout.readline()
            if not line.startswith("# faas listening"):
                cli_log.seek(0)
                check(False, "(d) the CLI did not start: " + line
                      + cli_log.read()[-2000:])
            req = urllib.request.Request(
                f"http://127.0.0.1:{cli_port}/erlamsa/erlamsa_esi:fuzz",
                data=payloads[0])
            answer = urllib.request.urlopen(req, timeout=120).read()
            check(answer == got[0],
                  "(d) the CLI's answer != (a)'s bytes for request id 0")
            print(f"serving (d) python -m erlamsa_tpu_torch -H "
                  f"(ERLAMSA_PALLAS=2, its own process): request id 0 == "
                  f"(a)'s bytes ({len(answer)} B; "
                  f"{time.perf_counter() - t:.1f}s after (b))")
        finally:
            killer.cancel()
            if cli.poll() is None:
                cli.terminate()
                try:
                    cli.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    cli.kill()
                    cli.wait()
            cli.stdout.close()
            cli_log.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"serving phase: {time.perf_counter() - t_phase:.1f}s")


# phase 10: the fuzzing proxy (``-i``, services/proxy.py) and the ``-m
# xla`` bridge server (services/xla_bridge.py). The CLI's defaults: the
# flush batcher at 256 rows x 16384 B and a 20 ms deadline, level 2
PROXY_EXCHANGES = {"tcp": 32, "http": 16, "http2": 16, "udp": 16,
                   "connect": 16}  # (a) strict request/response exchanges
PROXY_CPU_ROWS = 16  # (a) tcp answers held against the CPU plain path
PROXY_SIZES = (64, 1460)  # packet sizes, bytes (one Ethernet MSS at most)
PROXY_CONNECTIONS, PROXY_PER_CONN = 256, 16  # (b) the configs[4] load
PROXY_TIMEOUT = 5.0  # (b) a packet's echo wait; past it, a drop
BRIDGE_CASES = 4  # (c) FUZZ_BATCH calls of phase 3's corpus
BRIDGE_HOST_SAMPLES = 16  # (c) FUZZ_CASE and MUX_EVENT samples
EXCHANGE_WAIT = 120.0  # any one wait of (a), (c) and (d)
PROXY_WIDTH: dict = {}  # FuzzProxy batcher options (a CPU rehearsal shrinks)
CLI_ARGS: list = []  # extra args of (d)'s CLI (a CPU rehearsal)
BRIDGE_ARGS: list = []  # extra args of (c)'s bridge (a CPU rehearsal)

LOAD_PROXY_CLIENT = r"""
import asyncio, json, sys, time
conns, per_conn, timeout, payload_path, out_path = sys.argv[1:6]
conns, per_conn, timeout = int(conns), int(per_conn), float(timeout)
with open(payload_path, "rb") as f:
    blob = f.read()
payloads, off = [], 0
while off < len(blob):
    n = int.from_bytes(blob[off:off + 8], "little")
    payloads.append(blob[off + 8:off + 8 + n])
    off += 8 + n

async def echo(reader, writer):
    try:
        while True:
            data = await reader.read(65536)
            if not data:
                break
            writer.write(data)
            await writer.drain()
    except OSError:
        pass
    finally:
        writer.close()

async def client(c, port, results):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        for k in range(per_conn):
            body = payloads[(c * per_conn + k) % len(payloads)]
            t0 = time.perf_counter()
            writer.write(body)
            await writer.drain()
            try:
                first = await asyncio.wait_for(reader.read(65536), timeout)
            except asyncio.TimeoutError:
                results.append([c, k, 0, time.perf_counter() - t0, 0])
                continue
            if not first:
                results.append([c, k, -1, time.perf_counter() - t0, 0])
                break
            n = len(first)
            rtt = time.perf_counter() - t0
            while True:  # a reply the proxy sent in pieces
                try:
                    more = await asyncio.wait_for(reader.read(65536), 0.01)
                except asyncio.TimeoutError:
                    break
                if not more:
                    break
                n += len(more)
            results.append([c, k, 1, rtt, n])
    finally:
        writer.close()

async def main():
    srv = await asyncio.start_server(echo, "127.0.0.1", 0)
    print("ready", srv.sockets[0].getsockname()[1], flush=True)
    port = int(sys.stdin.readline())
    results = []
    t0 = time.time()
    await asyncio.gather(*(client(c, port, results) for c in range(conns)))
    t1 = time.time()
    with open(out_path, "w") as f:
        json.dump({"start": t0, "end": t1, "results": results}, f)
    srv.close()

asyncio.run(main())
"""


def wait_until(cond, what, timeout=EXCHANGE_WAIT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.001)


class EchoUpstream:
    """A loopback TCP echo server, a thread per connection; ``received``
    keeps, per connection, everything it echoed."""

    def __init__(self, echo=True):
        import socket
        import threading

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self.echo = echo
        self.received: list = []
        self.threads = []
        t = threading.Thread(target=self._accept, daemon=True)
        t.start()
        self.threads.append(t)

    def _accept(self):
        import threading

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            buf = bytearray()
            self.received.append(buf)
            t = threading.Thread(target=self._serve, args=(conn, buf),
                                 daemon=True)
            t.start()
            self.threads.append(t)

    def _serve(self, conn, buf):
        with conn:
            try:
                while True:
                    data = conn.recv(65536)
                    if not data:
                        break
                    buf += data
                    if self.echo:
                        conn.sendall(data)
            except OSError:
                pass

    def close(self):
        import socket

        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        for t in self.threads:
            t.join(5)


def proxy_taps(proxy):
    """Record the proxy's ``_fuzz_maybe`` calls [(direction, in, out)] and
    the requests its batcher admitted [(direction, request)] (a request
    carries its rid, data and result)."""
    import threading

    log, reqs = [], []
    real_fuzz, real_submit = proxy._fuzz_maybe, proxy.batcher.submit
    local = threading.local()  # the direction of this pump thread's packet

    def fuzz_maybe(data, prob, npacket, direction, conn_state):
        local.direction = direction
        out = real_fuzz(data, prob, npacket, direction, conn_state)
        log.append((direction, data, out))
        return out

    def submit(data, opts):
        req = real_submit(data, opts)
        reqs.append((local.direction, req))
        return req

    proxy._fuzz_maybe = fuzz_maybe
    proxy.batcher.submit = submit
    return log, reqs


def geometry(proxy) -> str:
    b = proxy.batcher
    return f"{b.batch} x {b.capacity}, {b.max_latency * 1000:g} ms"


def proxy_packets(rng, count, proto):
    """Packets of PROXY_SIZES in phase 3's three shapes; http:// wraps
    each body in a request with a Content-Length, http2:// in a DATA
    frame after the preface, SETTINGS and a HEADERS frame."""
    from erlamsa_tpu_torch.models import http2
    from erlamsa_tpu_torch.models.hpack import HpackContext

    lo, hi = PROXY_SIZES
    bodies = [seed_bytes(rng, i, int(rng.integers(lo, hi + 1)))
              for i in range(count)]
    if proto == "http":
        return [b"POST /p/%d HTTP/1.1\r\nHost: target\r\nContent-Length: "
                b"%d\r\n\r\n" % (i, len(b)) + b for i, b in enumerate(bodies)]
    if proto == "http2":
        block = HpackContext().encode([(b":method", b"POST"),
                                       (b":path", b"/upload")])
        first = (http2.PREFACE
                 + http2.build_frame(http2.T_SETTINGS, 0, 0, bytes(6))
                 + http2.build_frame(http2.T_HEADERS, http2.F_END_HEADERS, 1,
                                     block))
        frames = [http2.build_frame(http2.T_DATA, 0, 1, b) for b in bodies]
        return [first + frames[0]] + frames[1:]
    return bodies


def strict_tcp(sock, packets, log) -> bytes:
    """One packet at a time: send it, wait until the proxy fuzzed it, the
    upstream echoed it and the proxy fuzzed the whole echo, then read
    everything the proxy sent back. Returns the client's bytes."""
    import select

    got = bytearray()

    def out_bytes(d):
        return sum(len(o) for dd, _i, o in list(log) if dd == d)

    for k, pkt in enumerate(packets):
        sock.sendall(pkt)
        wait_until(lambda: sum(d == "c->s" for d, _i, _o in list(log))
                   == k + 1, f"packet {k} (c->s)")
        wait_until(lambda: sum(len(i) for d, i, _o in list(log)
                               if d == "s->c") == out_bytes("c->s"),
                   f"packet {k}'s echo (s->c)")
        want = out_bytes("s->c")
        deadline = time.monotonic() + EXCHANGE_WAIT
        while len(got) < want:
            r, _w, _x = select.select([sock], [], [],
                                      max(0.0, deadline - time.monotonic()))
            check(r, f"packet {k}: the client got {len(got)} of {want} B")
            chunk = sock.recv(65536)
            check(chunk, f"packet {k}: the proxy closed the connection")
            got += chunk
    return bytes(got)


def proxy_exchanges(proto, packets, seed3, dev):
    """(a) for one protocol: a fresh proxy at -P 1.0,1.0 (udp: echo
    datagrams), strict exchanges, the counts read around them. Returns
    (proxy, log, requests, client bytes, upstream bytes, launches,
    seconds)."""
    import socket

    from erlamsa_tpu_torch.services.proxy import FuzzProxy

    lport = free_port()
    up = udp = None
    if proto == "udp":
        udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        udp.bind(("127.0.0.1", 0))
        udp.settimeout(EXCHANGE_WAIT)
        rport = udp.getsockname()[1]
    else:
        up = EchoUpstream()
        rport = up.port
    spec = (f"connect://{lport}::" if proto == "connect"
            else f"{proto}://{lport}:127.0.0.1:{rport}")
    proxy = FuzzProxy(spec, "1.0,1.0", {"seed": seed3}, device=dev, level=2,
                      **PROXY_WIDTH)
    log, reqs = proxy_taps(proxy)
    flushes0 = proxy.batcher.flushes
    reset_counts()
    t = time.perf_counter()
    try:
        proxy.start(block=False)
        if proto == "udp":
            c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            c.settimeout(EXCHANGE_WAIT)
            got, seen = [], []
            try:
                for pkt in packets:
                    c.sendto(pkt, ("127.0.0.1", lport))
                    data, addr = udp.recvfrom(65536)
                    seen.append(data)
                    udp.sendto(data, addr)
                    got.append(c.recvfrom(65536)[0])
            finally:
                c.close()
            received = b"".join(seen)
        else:
            with socket.create_connection(("127.0.0.1", lport),
                                          timeout=EXCHANGE_WAIT) as c:
                if proto == "connect":
                    c.sendall(b"CONNECT 127.0.0.1:%d HTTP/1.1\r\n\r\n" % rport)
                    check(b" 200 " in c.recv(1024), "(a) connect: no 200")
                c.settimeout(None)
                got = strict_tcp(c, packets, log)
            wait_until(lambda: up.received, "(a) the upstream connection")
            received = bytes(up.received[0])
        secs = time.perf_counter() - t
        launches = counts()["case_rounds"]
    finally:
        proxy.stop()
        if up is not None:
            up.close()
        if udp is not None:
            udp.close()
    flushes = proxy.batcher.flushes - flushes0
    check(launches == flushes, f"(a) {proto}: {launches} case-kernel "
          f"launches in {flushes} flushes")
    return proxy, log, reqs, got, received, launches, secs


def proxy_phase(seed, seed3, dev, card) -> int:
    """Phase 10: (a) the proxy's bytes per protocol, (b) the
    BASELINE.json configs[4] load, (c) the bridge over stdio, (d) the
    CLI's -i in a process of its own. Returns the case-kernel launches of
    (a), (b) and (c)'s in-process steps."""
    import socket
    import threading

    from erlamsa_tpu_torch.models import http2
    from erlamsa_tpu_torch.services import metrics
    from erlamsa_tpu_torch.services.proxy import _split_http

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 10)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ERLAMSA_PALLAS="2")
    total = 0
    work = tempfile.mkdtemp(prefix="chip_smoke_proxy_")
    # (d)'s CLI starts now, in a process of its own, and is asked after
    # (c); its upstream records and does not echo
    cli_up = EchoUpstream(echo=False)
    cli_port = free_port()
    cli_log = open(os.path.join(work, "cli.log"), "w+")
    cli = subprocess.Popen(
        [sys.executable, "-m", "erlamsa_tpu_torch", "-s",
         ",".join(map(str, seed3)), "-i",
         f"tcp://{cli_port}:127.0.0.1:{cli_up.port}", "-P", "1.0,1.0",
         *CLI_ARGS], cwd=here, env=env, stdout=cli_log,
        stderr=subprocess.STDOUT)
    killer = threading.Timer(600, cli.kill)
    killer.start()
    try:
        # (a) each protocol's bytes: every admitted request == the
        # single-shot request step at its (seed, rid)
        events0 = metrics.GLOBAL.event_counts()
        first = None
        for proto, n in PROXY_EXCHANGES.items():
            packets = proxy_packets(rng, n, proto)
            proxy, log, reqs, got, received, launches, secs = \
                proxy_exchanges(proto, packets, seed3, dev)
            total += launches
            pairs = [(r.rid, r.data) for _d, r in reqs]
            check([r.rid for _d, r in reqs] == list(range(len(reqs))),
                  f"(a) {proto}: request ids are not the submit order")
            answers = [r.result for _d, r in reqs]
            check(answers == single_shots(pairs, proxy.batcher.capacity, dev,
                                          2, seed3),
                  f"(a) {proto}: the proxy's answers != the single-shot "
                  "request step")
            st = proxy.batcher.stats()
            serving_faults(proxy.batcher, events0, f"(a) {proto}")
            c2s = [(i, o) for d, i, o in log if d == "c->s"]
            s2c = [(i, o) for d, i, o in log if d == "s->c"]
            extra = ""
            if proto == "tcp":
                first = (packets[0], answers[0])
                cpu = single_shots(pairs[:PROXY_CPU_ROWS],
                                   proxy.batcher.capacity, "cpu", 2, seed3)
                check(cpu == answers[:PROXY_CPU_ROWS], "(a) tcp: cuda != cpu")
                extra = f", {PROXY_CPU_ROWS} == the CPU"
            if proto == "udp":
                check(got == [o for _i, o in s2c],
                      "(a) udp: the client's datagrams != the s->c answers")
                check(received == b"".join(o for _i, o in c2s),
                      "(a) udp: the upstream's datagrams != the c->s answers")
            else:
                check(received == b"".join(o for _i, o in c2s),
                      f"(a) {proto}: the upstream's bytes != the c->s "
                      "outputs")
                check(got == b"".join(o for _i, o in s2c),
                      f"(a) {proto}: the client's bytes != the s->c outputs")
            if proto == "http":
                for inp, out in c2s + s2c:
                    parts = _split_http(inp)
                    if parts is None:
                        continue
                    head, body = _split_http(out)
                    n_cl = [int(ln.split(b":", 1)[1]) for ln in
                            head.split(b"\r\n")
                            if ln.lower().startswith(b"content-length:")]
                    check(n_cl == [len(body)],
                          "(a) http: Content-Length not fixed up")
                extra = ", Content-Length fixed up"
            if proto == "http2":
                frames, rem = http2.parse_frames(received)
                check(rem == b"", "(a) http2: a frame length is wrong")
                sent, _r = http2.parse_frames(b"".join(packets))
                check([f[:3] for f in frames] == [f[:3] for f in sent],
                      "(a) http2: the frame sequence changed")
                check(all(a == b for a, b in zip(frames, sent)
                          if a[0] != http2.T_DATA),
                      "(a) http2: a frame other than DATA changed")
                check([f[3] for f in frames if f[0] == http2.T_DATA]
                      == [r.result for d, r in reqs if d == "c->s"],
                      "(a) http2: DATA payloads != the batcher's answers")
                extra = ", only DATA changed, frame lengths right"
            print(f"proxy (a) {proto}:// -P 1.0,1.0 (level 2, "
                  f"{geometry(proxy)}): {n} strict exchanges of "
                  f"{min(map(len, packets))}-{max(map(len, packets))} B in "
                  f"{secs:.2f}s, "
                  f"{len(reqs)} requests in {st['steps']} flushes, "
                  f"{launches} case-kernel launches, {st['escapes']} "
                  f"escapes; every answer == the single-shot request step"
                  f"{extra}")

        # (b) the configs[4] load: 256 keep-alive connections, 16 packets
        # each, through tcp:// at -P 1.0,1.0 to the load process's echo
        total += proxy_load(rng, seed3, dev, work, card)

        # (c) the bridge over stdio, as ERLAMSA_XLA_BRIDGE_CMD starts it
        total += bridge_run(np.random.default_rng(seed), seed3, dev, env,
                            here)

        # (d) the CLI's -i forwards (a)'s first answer
        t = time.perf_counter()
        deadline = time.monotonic() + EXCHANGE_WAIT
        while True:
            if cli.poll() is not None:
                cli_log.seek(0)
                check(False, "(d) the CLI exited: " + cli_log.read()[-2000:])
            try:
                c = socket.create_connection(("127.0.0.1", cli_port),
                                             timeout=EXCHANGE_WAIT)
                break
            except ConnectionRefusedError:
                check(time.monotonic() < deadline, "(d) the CLI never "
                      "listened")
                time.sleep(0.1)
        with c:
            c.sendall(first[0])
            wait_until(lambda: cli_up.received
                       and len(cli_up.received[0]) >= len(first[1]),
                       "(d) the CLI's forwarded packet")
        time.sleep(0.05)
        check(bytes(cli_up.received[0]) == first[1],
              "(d) the CLI forwarded other bytes than (a)'s first answer")
        print(f"proxy (d) python -m erlamsa_tpu_torch -i tcp://... -P 1.0,1.0 "
              f"(ERLAMSA_PALLAS=2, its own process): the first packet's "
              f"forwarded bytes == (a)'s first answer ({len(first[1])} B; "
              f"{time.perf_counter() - t:.1f}s after (c))")
    finally:
        killer.cancel()
        if cli.poll() is None:
            cli.terminate()
            try:
                cli.wait(timeout=30)
            except subprocess.TimeoutExpired:
                cli.kill()
                cli.wait()
        cli_log.close()
        cli_up.close()
        shutil.rmtree(work, ignore_errors=True)
    print(f"proxy phase: {time.perf_counter() - t_phase:.1f}s, {total} "
          f"case-kernel launches")
    return total


def proxy_load(rng, seed3, dev, work, card) -> int:
    """(b): PROXY_CONNECTIONS keep-alive connections from a load process
    of its own (stdlib asyncio; it also runs the echo upstream), each
    sending PROXY_PER_CONN packets and waiting for the echo. Returns the
    case-kernel launches."""
    import torch

    from erlamsa_tpu_torch.services import metrics
    from erlamsa_tpu_torch.services.proxy import FuzzProxy

    lo, hi = PROXY_SIZES
    payloads = [seed_bytes(rng, i, int(rng.integers(lo, hi + 1)))
                for i in range(PROXY_CONNECTIONS * PROXY_PER_CONN)]
    ppath = os.path.join(work, "proxy-payloads.bin")
    with open(ppath, "wb") as f:
        for p in payloads:
            f.write(len(p).to_bytes(8, "little") + p)
    out = os.path.join(work, "proxy-load.json")
    load = subprocess.Popen(
        [sys.executable, "-c", LOAD_PROXY_CLIENT, str(PROXY_CONNECTIONS),
         str(PROXY_PER_CONN), str(PROXY_TIMEOUT), ppath, out],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    proxy = None
    try:
        line = load.stdout.readline().split()
        check(line[:1] == ["ready"], "(b) the load process did not start")
        lport = free_port()
        proxy = FuzzProxy(f"tcp://{lport}:127.0.0.1:{line[1]}", "1.0,1.0",
                          {"seed": seed3}, device=dev, level=2, **PROXY_WIDTH)
        st0 = proxy.batcher.stats()
        events0 = metrics.GLOBAL.event_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        proxy.start(block=False)
        reset_counts()
        load.stdin.write(f"{lport}\n")
        load.stdin.flush()
        check(load.wait(timeout=600) == 0, "(b) the load process failed")
        launches = counts()["case_rounds"]
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        st = proxy.batcher.stats()
    finally:
        if load.poll() is None:
            load.kill()
            load.wait()
        load.stdin.close()
        load.stdout.close()
        if proxy is not None:
            proxy.stop()
    with open(out) as f:
        got = json.load(f)
    res = got["results"]
    wall = got["end"] - got["start"]
    flushes, served, escapes = (st[k] - st0[k] for k in
                                ("steps", "served", "escapes"))
    ok = [r for r in res if r[2] == 1]
    dropped = sum(1 for r in res if r[2] == 0)
    closed = sum(1 for r in res if r[2] == -1)
    check(len(res) == PROXY_CONNECTIONS * PROXY_PER_CONN and not closed,
          f"(b) {len(res)} exchanges, {closed} connections closed")
    check(launches == flushes, f"(b) {launches} case-kernel launches in "
          f"{flushes} flushes")
    check(len(ok) > 0.9 * len(res), f"(b) only {len(ok)} of {len(res)} "
          "exchanges answered")
    serving_faults(proxy.batcher, events0, "(b)")
    rtt = np.array([r[3] for r in ok])
    print(f"proxy (b) configs[4] load: tcp:// -P 1.0,1.0 (level 2, "
          f"{geometry(proxy)}), {PROXY_CONNECTIONS} keep-alive connections "
          f"x {PROXY_PER_CONN} packets of {lo}-{hi} B = {len(res)} "
          f"exchanges in {wall:.2f}s: {len(ok) / wall:.1f} exchanges/s, "
          f"{(served + escapes) / wall:.1f} fuzzed packets/s, round trip "
          f"p50 {np.percentile(rtt, 50) * 1000:.1f} ms, p99 "
          f"{np.percentile(rtt, 99) * 1000:.1f} ms; {flushes} flushes, fill "
          f"{served / max(1, flushes * st['slots']):.4f}, {launches} "
          f"case-kernel launches, {escapes} escapes, {dropped} dropped "
          f"(no echo in {PROXY_TIMEOUT:g}s: a packet fuzzed to nothing), "
          f"peak device memory {peak} B; no give-up or restart; card {card}")
    return launches


def bridge_frames(proc, frames):
    """Write request frames to the bridge process, read one response
    frame each."""
    import struct

    from erlamsa_tpu_torch.services import xla_bridge as xb

    out = []
    for op, header, payload in frames:
        proc.stdin.write(xb.encode_frame(op, header, payload))
        proc.stdin.flush()
        hdr = proc.stdout.read(4)
        check(len(hdr) == 4, "(c) the bridge closed its stdout")
        (ln,) = struct.unpack(">I", hdr)
        body = proc.stdout.read(ln)
        check(len(body) == ln, "(c) a truncated frame")
        out.append(hdr + body)
    return out


def bridge_run(rng, seed3, dev, env, here) -> int:
    """(c): the bridge server as a process of its own over stdio: HELLO,
    FUZZ_BATCH tpu of phase 3's corpus for BRIDGE_CASES cases == the
    in-process make_fuzzer step on the card (one case-kernel launch a
    call), FUZZ_CASE and MUX_EVENT == the handlers on the CPU, an unknown
    name answers 0xFF and the next frame is served. Returns the in-process
    steps' case-kernel launches."""
    import threading

    from erlamsa_tpu_torch.services import xla_bridge as xb

    t = time.perf_counter()
    corpus = make_corpus(rng, BATCH)
    lens = [len(s) for s in corpus]
    payload = b"".join(corpus)
    seed = list(seed3)
    err = tempfile.TemporaryFile()
    proc = subprocess.Popen(
        [sys.executable, "-m", "erlamsa_tpu_torch.services.xla_bridge",
         *BRIDGE_ARGS], cwd=here, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=err)
    killer = threading.Timer(600, proc.kill)
    killer.start()
    try:
        t_start = time.perf_counter()
        hello = bridge_frames(proc, [(xb.OP_HELLO, {"version": 1}, b"")])[0]
        check(hello == xb.BridgeServer().handle(xb.OP_HELLO, {}, b""),
              "(c) HELLO")
        t_ready = time.perf_counter() - t_start
        got, secs = [], []
        for case in range(BRIDGE_CASES):
            t0 = time.perf_counter()
            got += bridge_frames(proc, [(xb.OP_FUZZ_BATCH,
                                         {"seed": seed, "case": case,
                                          "backend": "tpu", "lens": lens},
                                         payload)])
            secs.append(time.perf_counter() - t0)
        host = BRIDGE_HOST_SAMPLES
        small = [s[:int(rng.integers(16, 512))] for s in corpus[:host]]
        state = [int(x) for x in rng.integers(1, 30000, 3)]
        requests = [(xb.OP_FUZZ_CASE, {"seed": [seed3[0], 22, i]}, s)
                    for i, s in enumerate(small)]
        mux = []
        cpu = xb.BridgeServer(device="cpu")
        cpu.handle(xb.OP_HELLO, {}, b"")
        for i, s in enumerate(small):
            header = {"state": state}
            resp = bridge_frames(proc, [(xb.OP_MUX_EVENT, header, s)])[0]
            want = cpu.handle(xb.OP_MUX_EVENT, header, s)
            check(resp == want, f"(c) MUX_EVENT {i} != the CPU handler")
            state = xb.decode_body(resp[4:])[1]["state"]
            mux.append(resp)
        cases = bridge_frames(proc, requests)
        check(cases == [cpu.handle(*r) for r in requests],
              "(c) FUZZ_CASE != the CPU handler")
        bad, ping = bridge_frames(proc, [
            (xb.OP_FUZZ_CASE, {"seed": seed, "mutations": "nosuch"}, b"x"),
            (xb.OP_PING, {}, b"")])
        check(xb.decode_body(bad[4:])[0] == xb.OP_ERROR and
              "nosuch" in xb.decode_body(bad[4:])[1]["error"],
              "(c) an unknown mutation name did not answer 0xFF")
        check(xb.decode_body(ping[4:])[0] == xb.OP_PING | xb.RESP,
              "(c) the frame after the error was not served")
        for resp in got + mux + cases:
            check(xb.decode_body(resp[4:])[0] != xb.OP_ERROR,
                  "(c) an error frame: " + str(xb.decode_body(resp[4:])[1]))
        proc.stdin.close()
        check(proc.wait(timeout=60) == 0, "(c) the bridge did not exit")
        check(proc.stdout.read() == b"", "(c) bytes on stdout past the "
              "last frame")
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
    # the same FUZZ_BATCH in process, the counts read around each call
    launches, in_secs = 0, []
    for case in range(BRIDGE_CASES):
        reset_counts()
        t0 = time.perf_counter()
        h, p = xb._handle_fuzz_batch({"seed": seed, "case": case,
                                      "backend": "tpu", "lens": lens},
                                     payload, dev, 2)
        in_secs.append(time.perf_counter() - t0)
        n = counts()["case_rounds"]
        check(n == 1, f"(c) the in-process step launched the case kernel "
              f"{n} times")
        launches += n
        check(got[case] == xb.encode_frame(xb.OP_FUZZ_BATCH | xb.RESP, h, p),
              f"(c) case {case}: the bridge's FUZZ_BATCH != the in-process "
              "step")
    frame_in = len(xb.encode_frame(xb.OP_FUZZ_BATCH, {"lens": lens}, payload))
    print(f"bridge (c) python -m erlamsa_tpu_torch.services.xla_bridge "
          f"(stdio, ERLAMSA_PALLAS=2): HELLO {t_ready:.1f}s after start; "
          f"FUZZ_BATCH tpu of {BATCH} seeds of {min(lens)}-{max(lens)} B x "
          f"{BRIDGE_CASES} cases == the in-process make_fuzzer step "
          f"({launches} case-kernel launches, one a call): "
          f"{BATCH * BRIDGE_CASES / sum(secs):.1f} samples/s through the "
          f"bridge ({', '.join(f'{s:.3f}' for s in secs)} s a call, frames "
          f"of {frame_in} B in and {', '.join(str(len(g)) for g in got)} B "
          f"out) against {BATCH * BRIDGE_CASES / sum(in_secs):.1f} in "
          f"process ({', '.join(f'{s:.3f}' for s in in_secs)} s); "
          f"{BRIDGE_HOST_SAMPLES} FUZZ_CASE and MUX_EVENT frames == the "
          f"CPU handlers, an unknown name answered 0xFF and the next frame "
          f"was served ({time.perf_counter() - t:.1f}s)")
    return launches


# phase 11: the host tier, the coverage plane and distillation
COV_WIDTHS = (1024, 65536)  # (a) COVERAGE_MAP_BYTES and AFL's map
COV_COUNTS = (1, 2, 4096, 4097)  # (a) maps a call
COV_DENSITIES = (0.0, 1 / 256, 0.5, 1.0)  # (a) share of set bits
COV_SEEDS, COV_SEED_MAX = 64, 4096  # (b) the small store: seeds, bytes
COV_ROWS, COV_CASES = CAMPAIGN_CPU_ROWS, CAMPAIGN_CPU_CASES  # (b)
COV_CAMPAIGN_CASES = CAMPAIGN_SHORT  # (c) cases at phase 8's size
# (d) python -m erlamsa_tpu_torch --backend oracle: the md5 of stdout for
# BASELINE.json configs[0], and of the files of -w 2 -n 8 -o DIR/%n over
# a file holding the same line (each file's name, a zero byte, its
# bytes, in index order); tests/test_torch_host_tier.py holds both equal
# to the JAX CLI's
HOST_LINE = b"Hello erlamsa!\n"
HOST_CONFIGS0_MD5 = "fc776a068a1501ce6965bd816b1df1f6"
HOST_WORKERS_MD5 = "ca204ac51d53e811d625f4c21e15fdd5"
TRACE_CLI_ARGS: list = []  # extra args of (d)'s traced CLI (a CPU rehearsal)

# an instrumented target's connect-back stand-in: for every (case, slot)
# one coverage frame of a map drawn from a seeded RNG (a quarter light
# new edges, the rest are empty or repeat an earlier map), all sent
# before the run starts; the frame is services/dist.py's
COVERAGE_SENDER = r"""
import json, random, socket, struct, sys, zlib
host, port, cases, batch, width, seed = sys.argv[1:7]
cases, batch, width = int(cases), int(batch), int(width)
rng = random.Random(int(seed))
sent, out = [], []
for case in range(cases):
    for slot in range(batch):
        kind = rng.randrange(4)
        if kind == 0 or not sent:
            m = bytearray(width)
            for _ in range(rng.randrange(1, 6)):
                m[rng.randrange(width)] = rng.randrange(1, 256)
            blob = bytes(m)
        elif kind == 1:
            blob = sent[rng.randrange(len(sent))]
        else:
            blob = bytes(width)
        sent.append(blob)
        hdr = json.dumps({"op": "cov", "case": case, "slot": slot,
                          "epoch": 0, "crc": zlib.crc32(blob)},
                         separators=(",", ":")).encode()
        out.append(b"\x8fEF1" + struct.pack("<II", len(hdr), len(blob))
                   + hdr + blob)
with socket.create_connection((host, int(port)), timeout=30) as s:
    s.sendall(b"".join(out))
"""


def cov_maps(rng, n, width, density):
    """uint8[n, width]: each bit set with probability ``density``."""
    if density == 0.0:
        return np.zeros((n, width), np.uint8)
    if density == 1.0:
        return np.full((n, width), 0xFF, np.uint8)
    if density == 0.5:
        return np.frombuffer(rng.bytes(n * width), np.uint8).reshape(
            n, width).copy()
    bits = np.zeros(n * width * 8, bool)
    bits[rng.integers(0, bits.size, int(bits.size * density))] = True
    return np.packbits(bits).reshape(n, width)


def cov_cases(seed):
    """(width, density, maps[max count], acc) of phase 11 (a), from the
    seed alone: the twin process and the card make the same maps."""
    rng = np.random.default_rng(seed + 12)
    for width in COV_WIDTHS:
        for density in COV_DENSITIES:
            maps = cov_maps(rng, max(COV_COUNTS), width, density)
            acc = cov_maps(rng, 1, width, density / 2)[0]
            yield width, density, maps, acc


def cov_twins(out, seed) -> int:
    """``--cov-twins FILE``: the numpy twins of ops/coverage.py over phase
    11 (a)'s maps, in a process of its own started with the script (the
    largest, 4097 x 64 KB, take seconds each on the host)."""
    from erlamsa_tpu_torch.ops import coverage as cov

    res, t = {}, time.perf_counter()
    for width, density, maps, acc in cov_cases(seed):
        for n in COV_COUNTS:
            k = f"{width}-{density}-{n}"
            res[k + "-pop"] = cov.popcount_np(maps[:n])
            res[k + "-fold"] = cov.fold_maps_np(acc, maps[:n])
            res[k + "-gains"], res[k + "-acc"] = cov.batch_gains_np(
                acc, maps[:n])
    res["seconds"] = np.float64(time.perf_counter() - t)
    np.savez(out + ".tmp.npz", **res)
    os.replace(out + ".tmp.npz", out)
    return 0


def cov_ops_vs_twins(seed, dev, twins):
    """Phase 11 (a): popcount, fold_maps and batch_gains on the card ==
    their numpy twins (the --cov-twins process's), tolerance 0; the
    fold's device time at 4096 x 1024 B from CUDA events."""
    import torch

    from erlamsa_tpu_torch.ops import coverage as cov

    proc, path = twins
    t = time.perf_counter()
    check(proc.wait(timeout=600) == 0, "the numpy twin process failed")
    waited = time.perf_counter() - t
    want = np.load(path)
    checked, fold_ms = 0, None
    for width, density, maps, acc in cov_cases(seed):
        maps_d = torch.from_numpy(maps).to(dev)
        acc_d = torch.from_numpy(acc).to(dev)
        for n in COV_COUNTS:
            k = f"{width}-{density}-{n}"
            pop = cov.popcount(maps_d[:n])
            fold = cov.fold_maps(acc_d, maps_d[:n])
            gains, acc2 = cov.batch_gains(acc_d, maps_d[:n])
            check(pop.dtype == gains.dtype == torch.int32
                  and fold.dtype == acc2.dtype == torch.uint8
                  and pop.device.type == fold.device.type
                  == gains.device.type == dev.type,
                  f"(a) {k}: dtypes {pop.dtype} {fold.dtype} {gains.dtype}")
            for name, got in (("pop", pop), ("fold", fold),
                              ("gains", gains), ("acc", acc2)):
                check(np.array_equal(got.cpu().numpy(), want[f"{k}-{name}"]),
                      f"(a) {name} at {k} differs from its numpy twin")
            checked += 1
            if (width, n, density) == (COV_WIDTHS[0], COV_COUNTS[2], 0.5):
                fold_ms = cuda_ms(lambda: cov.batch_gains(acc_d, maps_d[:n]),
                                  20)
                fold_only = cuda_ms(lambda: cov.fold_maps(acc_d, maps_d[:n]),
                                    20)
        del maps_d
    print(f"coverage (a) popcount, fold_maps, batch_gains on the card == "
          f"numpy twins, tolerance 0: {checked} cases (N "
          f"{'/'.join(map(str, COV_COUNTS))} x widths "
          f"{'/'.join(map(str, COV_WIDTHS))} B x densities 0, 1/256, 1/2, "
          f"1); at {COV_COUNTS[2]} x {COV_WIDTHS[0]} B, density 1/2, "
          f"batch_gains {fold_ms:.4f} ms, fold_maps "
          f"{fold_only:.4f} ms device (CUDA events); the twins took "
          f"{float(want['seconds']):.1f}s on the host in their own process "
          f"(waited {waited:.1f}s)")


def load_hub(frames_of, n_frames, dead=False):
    """A CoverageHub holding ``n_frames`` frames that COVERAGE_SENDER,
    in a process of its own, sent for ``frames_of`` = (cases, batch,
    seed); with ``dead`` its ingest faults (monitor.ingest:*) until the
    breaker opens."""
    from erlamsa_tpu_torch.constants import COVERAGE_MAP_BYTES
    from erlamsa_tpu_torch.services import chaos
    from erlamsa_tpu_torch.services.monitors import CoverageHub

    cases, batch, seed = frames_of
    if dead:
        chaos.configure("monitor.ingest:*", seed=seed)
    hub = CoverageHub(port=0).start()
    try:
        subprocess.run([sys.executable, "-c", COVERAGE_SENDER, hub.host,
                        str(hub.port), str(cases), str(batch),
                        str(COVERAGE_MAP_BYTES), str(seed)],
                       check=True, timeout=120)
        wait_until((lambda: not hub.alive()) if dead
                   else (lambda: hub.pending_frames() == n_frames),
                   "the coverage frames")
    finally:
        chaos.configure(None)
    return hub


def coverage_run(name, store, work, seed3, batch, n, device, hub=None,
                 **extra):
    """campaign_run, arena async --adopt (with ``hub``, --coverage and
    the hub's frames): returns its results, then the `# distill:` line
    and the retired seed ids."""
    import io

    out = os.path.join(work, "out-" + name.replace(" ", "-"))
    if hub is not None:
        extra.update(coverage=True, coverage_hub=hub)
    err, real = io.StringIO(), sys.stderr
    sys.stderr = err
    try:
        got = campaign_run(name, store, out, seed3, n, batch, device,
                           pipeline="async", layout="arena", adopt=True,
                           **extra)
    except BaseException:
        real.write(err.getvalue()[-2000:])
        raise
    finally:
        sys.stderr = real
    said = [ln for ln in err.getvalue().splitlines()
            if ln.startswith("# distill:")]
    rdir = os.path.join(store, "retired")
    retired = sorted(os.listdir(rdir)) if os.path.isdir(rdir) else []
    shutil.rmtree(out)
    return (*got, said, retired)


def coverage_triangle(seed, seed3, dev, work):
    """Phase 11 (b): the coverage triangle at a small size, on the card
    and on the CPU: the hash-novelty baseline, a coverage-gated run with
    --adopt --distill and a run whose hub died under monitor.ingest:*."""
    from erlamsa_tpu_torch.corpus.store import CorpusStore

    rng = np.random.default_rng(seed + 13)
    sizes = np.exp(rng.uniform(np.log(CAMPAIGN_MIN), np.log(COV_SEED_MAX),
                               COV_SEEDS))
    small = os.path.join(work, "small")
    store = CorpusStore(small)
    for i, n in enumerate(sizes):
        store.add(seed_bytes(rng, i, int(n)), origin="import")
    frames = (COV_CASES, COV_ROWS, seed + 14)
    got, secs = {}, {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        t = time.perf_counter()
        runs = {}
        runs["base"] = coverage_run(f"(b) base {key}", copy_store(
            small, os.path.join(work, f"b-base-{key}")), work, seed3,
            COV_ROWS, COV_CASES, d)
        hub = load_hub(frames, COV_CASES * COV_ROWS)
        try:
            runs["cov"] = coverage_run(f"(b) coverage {key}", copy_store(
                small, os.path.join(work, f"b-cov-{key}")), work, seed3,
                COV_ROWS, COV_CASES, d, hub=hub, distill=True)
        finally:
            hub.stop()
            hub.join(timeout=10)
        hub = load_hub(frames, COV_CASES * COV_ROWS, dead=True)
        try:
            runs["dead"] = coverage_run(f"(b) dead hub {key}", copy_store(
                small, os.path.join(work, f"b-dead-{key}")), work, seed3,
                COV_ROWS, COV_CASES, d, hub=hub)
        finally:
            hub.stop()
            hub.join(timeout=10)
        got[key], secs[key] = runs, time.perf_counter() - t
        base, cov, dead = runs["base"], runs["cov"], runs["dead"]
        check(dead[3] == base[3] and dead[0]["offspring"]
              == base[0]["offspring"],
              f"(b) {key}: the dead hub's run differs from the baseline")
        check(dead[0]["coverage"]["degraded"]
              and dead[1]["resilience"]["events"].get("coverage_lost") == 1,
              f"(b) {key}: the dead hub did not degrade the run")
        check(cov[3] != base[3], f"(b) {key}: coverage changed nothing")
        check(len(cov[6]) == 1 and cov[7],
              f"(b) {key}: distill said {cov[6]}, retired {cov[7]}")
    card, cpu = got["card"], got["cpu"]
    for name in ("base", "cov", "dead"):
        check(card[name][3] == cpu[name][3],
              f"(b) {name}: the card's files differ from the CPU's")
    c, p = card["cov"], cpu["cov"]
    check(c[0]["coverage"] == p[0]["coverage"]
          and c[0]["offspring"] == p[0]["offspring"]
          and c[6] == p[6] and c[7] == p[7],
          f"(b) coverage stats, offspring, distill or retired ids differ: "
          f"{c[0]['coverage']} {p[0]['coverage']} {c[6]} {p[6]}")
    cs = c[0]["coverage"]
    print(f"coverage (b) {COV_SEEDS} seeds of {CAMPAIGN_MIN}-{COV_SEED_MAX} "
          f"B, {COV_ROWS} rows x {COV_CASES} cases, arena async --adopt, "
          f"frames for every slot from a process of its own: baseline, "
          f"--coverage --distill and a dead hub (monitor.ingest:*), card == "
          f"CPU file for file in each; the dead hub's run == the baseline; "
          f"coverage: {cs['maps']} maps, {cs['new_edges']} new edges, "
          f"{c[0]['offspring']} offspring (baseline "
          f"{card['base'][0]['offspring']}); {c[6][0][2:]}; retired "
          f"{len(c[7])} == the CPU's; {secs['card']:.1f}s on the card, "
          f"{secs['cpu']:.1f}s on the CPU")


def coverage_campaign(seed, seed3, dev, card, work, store_dir, adopt_rate):
    """Phase 11 (c): phase 8's campaign store with --coverage --distill,
    frames for every slot: samples/s beside phase 8's arena --adopt, the
    coverage stage, maps folded, new edges, offspring, retired seeds,
    peak device memory; the case kernel once per class a case."""
    n = COV_CAMPAIGN_CASES
    hub = load_hub((n, BATCH, seed + 15), n * BATCH)
    try:
        st, snap, launches, _files, secs, peak, said, retired = \
            coverage_run("(c) coverage", copy_store(
                store_dir, os.path.join(work, "c-store")), work, seed3,
                BATCH, n, dev, hub=hub, distill=True)
    finally:
        hub.stop()
        hub.join(timeout=10)
    cs = st["coverage"]
    check(cs["folds"] == n and cs["maps"] == n * BATCH
          and not cs["degraded"] and cs["hub"]["frames"] == n * BATCH,
          f"(c) coverage stats {cs}")
    check(st["total"] == n * BATCH, f"(c) {st['total']} samples")
    cov_s = snap["pipeline"]["stages"].get("coverage", 0.0)
    beside = (f"phase 8's arena --adopt {adopt_rate:.1f} samples/s this call"
              if adopt_rate else "phase 8 not run in this call")
    print(f"coverage (c) the campaign store ({CAMPAIGN_SEEDS} seeds), "
          f"{BATCH} x {n} cases, level 2, arena async --adopt --coverage "
          f"--distill: {st['total'] / st['dt']:.1f} samples/s ({beside}), "
          f"coverage stage {cov_s / n:.4f}s a case, {cs['maps']} maps "
          f"folded, {cs['new_edges']} new edges ({cs['edges']} in all), "
          f"{st['offspring']} offspring adopted, {len(retired)} seeds "
          f"retired ({said[0][2:] if said else 'no distill line'}), case "
          f"kernel launches {launches['case_rounds']}, peak device memory "
          f"{peak} B, {secs:.1f}s the call; card {card}")
    return launches["case_rounds"]


def host_cli(args, cwd, stdin=b"", env=None, timeout=600):
    """``python -m erlamsa_tpu_torch`` in a process of its own; returns
    (stdout, stderr)."""
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-m", "erlamsa_tpu_torch", *args],
                         cwd=cwd, input=stdin, capture_output=True,
                         timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=here, **(env or {})))
    check(res.returncode == 0, f"(d) {args[:6]}... failed: "
          f"{res.stderr[-2000:].decode(errors='replace')}")
    return res.stdout, res.stderr.decode(errors="replace")


def files_md5(d):
    """md5 over each file's name, a zero byte and its bytes, in index
    order (the -w digest)."""
    import hashlib

    h = hashlib.md5()
    for f in sorted(os.listdir(d), key=int):
        with open(os.path.join(d, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()


def host_tier(work):
    """Phase 11 (d), the host tier: configs[0] and -w 2 through the CLI's
    --backend oracle, each md5 == the JAX CLI's (held in the CPU
    tests)."""
    import hashlib

    out, _err = host_cli(["--backend", "oracle", "-s", "1,2,3"], work,
                         stdin=HOST_LINE)
    check(hashlib.md5(out).hexdigest() == HOST_CONFIGS0_MD5,
          "(d) configs[0]'s stdout differs from the JAX CLI's")
    with open(os.path.join(work, "hello"), "wb") as f:
        f.write(HOST_LINE)
    os.makedirs(os.path.join(work, "w"))
    host_cli(["--backend", "oracle", "-s", "1,2,3", "-w", "2", "-n", "8",
              "-o", "w/%n", "hello"], work)
    check(files_md5(os.path.join(work, "w")) == HOST_WORKERS_MD5,
          "(d) -w 2's files differ from the JAX CLI's")


def trace_args(corpus, seed3, work, tag):
    """The CLI's arguments for the level-2 run_batch of phase 3's corpus
    (its seeds the files under work/seeds), outputs under work/tag."""
    from erlamsa_tpu_torch.ops.registry import DEVICE_CODES

    seeds = os.path.join(work, "seeds")
    os.makedirs(os.path.join(work, tag))
    return (["-s", ",".join(map(str, seed3)), "-n", "1", "--batch",
             str(len(corpus)), "-m", ",".join(DEVICE_CODES), "-o",
             f"{tag}/%n", *TRACE_CLI_ARGS]
            + [os.path.join(seeds, f) for f in sorted(os.listdir(seeds))])


def traced_run(corpus, seed3, work, plain_md5, card):
    """Phase 11 (d), second half: the same run with --trace FILE --xprof
    DIR writes the same files; the trace is Chrome-trace JSON holding the
    runner's spans, the profiler's trace names the case kernel; the span
    totals against the device's kernel time."""
    t = time.perf_counter()
    _out, err = host_cli(trace_args(corpus, seed3, work, "traced")
                         + ["--trace", "t.json", "--xprof", "xp"], work,
                         env={"ERLAMSA_PALLAS": "2"})
    secs = time.perf_counter() - t
    check(files_md5(os.path.join(work, "traced")) == plain_md5,
          "(d) --trace/--xprof changed the files")
    with open(os.path.join(work, "t.json")) as f:
        doc = json.load(f)
    spans = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            n, d = spans.get(e["name"], (0, 0.0))
            spans[e["name"]] = (n + 1, d + e["dur"] / 1e3)
    check({"batch.dispatch", "batch.drain", "batch.write"} <= set(spans),
          f"(d) the trace lacks the runner's spans: {sorted(spans)}")
    profs = os.listdir(os.path.join(work, "xp"))
    check(len(profs) == 1, f"(d) --xprof wrote {profs}")
    with open(os.path.join(work, "xp", profs[0])) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    case = [e for e in kern if "case_rounds_kernel" in e.get("name", "")]
    check(case, "(d) the profiler's trace names no case kernel")
    dev_ms = sum(e.get("dur", 0) for e in kern) / 1e3
    case_ms = sum(e.get("dur", 0) for e in case) / 1e3
    totals = ", ".join(f"{k} {n}x {ms:.1f} ms" for k, (n, ms)
                       in sorted(spans.items()))
    print(f"host (d) run_batch of phase 3's corpus, 1 case, level 2, "
          f"--trace --xprof in its own process ({secs:.1f}s): the same "
          f"{len(corpus)} files as without; span totals (host): {totals}; "
          f"device kernels {len(kern)} launches {dev_ms:.1f} ms, of which "
          f"the case kernel {len(case)}x {case_ms:.3f} ms; "
          f"{err.count('profiler_')} profiler notes; card {card}")


def coverage_phase(seed, seed3, dev, card, corpus, build, twins,
                   adopt_rate=None):
    """Phase 11: (a) ops/coverage on the card == numpy twins; (b) the
    coverage triangle card == CPU; (c) coverage on phase 8's store
    (``build``: the process making it, and its directory); (d) the host
    tier and --trace/--xprof through the CLI. Returns the case kernel's
    launches of (c)."""
    import tempfile
    import threading

    from erlamsa_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_cov_",
                            dir=cuda_build.BUILD_DIR)
    # (d)'s host tier and untraced run, each in a thread of its own (each
    # drives a process), beside (a) and (b), which time only the fold
    bg = {}

    def background(key, job):
        try:
            t = time.perf_counter()
            bg[key] = job()
            bg[key + "_s"] = time.perf_counter() - t
        except BaseException as e:  # re-raised in the phase's thread
            bg["error"] = e

    def plain():
        host_cli(trace_args(corpus, seed3, work, "plain"), work,
                 env={"ERLAMSA_PALLAS": "2"})
        return files_md5(os.path.join(work, "plain"))

    try:
        os.makedirs(os.path.join(work, "seeds"))
        for i, s in enumerate(corpus):
            with open(os.path.join(work, "seeds", f"{i:05d}"), "wb") as f:
                f.write(s)
        threads = [threading.Thread(target=background, args=job,
                                    name=f"chip_smoke-{job[0]}")
                   for job in (("host", lambda: host_tier(work)),
                               ("plain", plain))]
        for th in threads:
            th.start()
        try:
            cov_ops_vs_twins(seed, dev, twins)
            coverage_triangle(seed, seed3, dev, work)
        finally:
            for th in threads:
                th.join()
        if "error" in bg:
            raise bg["error"]
        print(f"host (d) --backend oracle in its own process: configs[0] "
              f"md5 {HOST_CONFIGS0_MD5} and -w 2 -n 8 -o DIR/%n md5 "
              f"{HOST_WORKERS_MD5} == the JAX CLI's ({bg['host_s']:.1f}s); "
              f"the untraced run {bg['plain_s']:.1f}s, both beside (a) and "
              f"(b)")
        check(build[0].wait(timeout=900) == 0, "the store build failed")
        launches = coverage_campaign(seed, seed3, dev, card, work,
                                     os.path.join(build[1], "store"),
                                     adopt_rate)
        traced_run(corpus, seed3, work, bg["plain"], card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"coverage phase: {time.perf_counter() - t_phase:.1f}s")
    return launches


GEN_SLOTS = 4096  # (a) slots of a panel; (b) samples seeding the store
GEN_CASES = (0, 3)  # (a) cases of each panel held card == CPU
GEN_TWIN_SLOTS = 64  # (a) slots of each panel held to the keyed twin
GEN_GRAMMARS = ("demo-http", "demo-tlv", "demo-lines", "sink")
# (a) and (b): a DSL grammar whose panel is 7,808 B wide (64 sized
# records of 120 random bytes), the widest the campaign's classes take
GEN_WIDE = "(loop 64 (sizer u16be (rbinary 120)))"
# tests/test_grammar_kernels.py's grammar of every node kind, nested
KITCHEN_SINK = """
; all node kinds, nested
(static "HDR\\x00")
(loop 3
  (pick_pref
    (3 (sizer u16be (rbinary 3) (pick (static "") (static "!")
                                      (range 65 70))))
    (1 (sizer u32le (static "deep") (loop 2 (rbyte))))
    (1 (rword)))
  (static "|"))
(pick (rdword) (rddword) (session k "dflt"))
(range 97 99)
"""
GEN_CAMPAIGN_CASES = 2  # (b) cases of each campaign run
GEN_SMALL = 64  # (b) samples and batch of the card == CPU runs
GF_CONNS = 64  # (c) batched gfcomms connections
GF_PACKETS = 16  # (c) packets a connection

GF_CLIENT = r"""
import json, socket, sys, threading, time
port, want_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
with open(want_path) as f:
    want = [[bytes.fromhex(r) for r in rows] for rows in json.load(f)]
first = {}
for c, rows in enumerate(want):
    first.setdefault(rows[0], []).append(c)
lat, found, errors = [], [], []
lock = threading.Lock()

def conn():
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.settimeout(60)
        buf, mine, k = b"", None, 0
        while k < len(want[0]):
            t = time.perf_counter()
            s.sendall(b"ping")
            if mine is None:
                # the first reply names the connection among the server's
                while not any(buf == r for r in first):
                    if not any(r.startswith(buf) for r in first):
                        raise RuntimeError("reply 0 is no connection's")
                    chunk = s.recv(65536)
                    if not chunk:
                        raise RuntimeError("closed")
                    buf += chunk
                ids = first[buf]
                mine = ids
            exp = want[mine[0]][k]
            if k:
                while len(buf) < len(exp):
                    chunk = s.recv(65536)
                    if not chunk:
                        raise RuntimeError("closed")
                    buf += chunk
            if buf != exp:
                raise RuntimeError(f"reply {k} differs")
            with lock:
                lat.append(time.perf_counter() - t)
            buf, k = b"", k + 1
        s.close()
        with lock:
            found.append(mine[0])
    except Exception as e:
        with lock:
            errors.append(repr(e))

threads = [threading.Thread(target=conn) for _ in want]
t0 = time.perf_counter()
for th in threads:
    th.start()
for th in threads:
    th.join()
with open(out_path, "w") as f:
    json.dump({"wall": time.perf_counter() - t0, "lat": lat,
               "found": found, "errors": errors}, f)
"""


def gen_grammar(name):
    """A compiled grammar of phase 12: a builtin, the sink or the wide."""
    from erlamsa_tpu_torch.gen import BUILTIN_GRAMMARS, compile_grammar

    text = {"sink": KITCHEN_SINK, "wide": GEN_WIDE}.get(name)
    return compile_grammar(text or BUILTIN_GRAMMARS[name], source=name)


def twin_slots():
    return np.linspace(0, GEN_SLOTS - 1, GEN_TWIN_SLOTS).astype(np.int64)


def start_gen_twins(here, seed, out, threads):
    """Phase 12 (a)'s CPU side (gen_twins) in a process of its own:
    returns (process, its output file)."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--gen-twins", out, "--gen-threads", str(threads)], cwd=here)
    return proc, out


def gen_twins(out, seed, threads=4) -> int:
    """Phase 12 (a)'s CPU side, in a process of its own started with the
    script: for each grammar, fuzz off and on and each case, the port's
    expander on the CPU over GEN_SLOTS slots and the keyed host twin on
    GEN_TWIN_SLOTS of them; the wide grammar's CPU rows on those slots.
    Written to ``out`` (.npz)."""
    import torch

    from erlamsa_tpu_torch.models.genfuzz import generate_keyed
    from erlamsa_tpu_torch.ops import grammar, prng

    torch.set_num_threads(threads)
    base = prng.base_key((seed, 22, 33))
    arrays = {}

    def twin(cg, case, fuzz, tag):
        rows = [generate_keyed(cg, grammar.gen_sample_key(
            base, cg.grammar_id, case, int(s)), fuzz=fuzz)
            for s in twin_slots()]
        arrays[tag + "twin"] = np.stack([np.frombuffer(r, np.uint8)
                                         for r, _n, _t in rows])
        arrays[tag + "twin_lens"] = np.array([n for _r, n, _t in rows])
        arrays[tag + "twin_trunc"] = np.array([int(t) for *_r, t in rows])

    for name in GEN_GRAMMARS:
        cg = gen_grammar(name)
        for fuzz in (False, True):
            expand = grammar.make_expand(cg, fuzz=fuzz)
            for case in GEN_CASES:
                tag = f"{name}-{int(fuzz)}-{case}-"
                panel, lens, trunc = expand(base, case, np.arange(GEN_SLOTS))
                arrays[tag + "panel"] = panel.numpy()
                arrays[tag + "lens"] = lens.numpy()
                arrays[tag + "trunc"] = trunc.numpy()
                twin(cg, case, fuzz, tag)
    cg = gen_grammar("wide")
    panel, lens, trunc = grammar.make_expand(cg)(base, 0, twin_slots())
    arrays["wide-panel"] = panel.numpy()
    arrays["wide-lens"] = lens.numpy()
    arrays["wide-trunc"] = trunc.numpy()
    twin(cg, 0, False, "wide-")
    np.savez(out + ".tmp.npz", **arrays)
    os.replace(out + ".tmp.npz", out)
    return 0


def gen_expander(seed3, dev, card, twins):
    """Phase 12 (a): the expander on the card == the CPU expander over
    GEN_SLOTS slots of GEN_CASES, == the keyed twin on GEN_TWIN_SLOTS,
    for the builtins and the sink, fuzz off and on (``twins``: the
    process making the CPU side, and its file); the wide grammar's
    panel timed, its launches counted by torch.profiler, its peak
    memory, its rows == the CPU's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from erlamsa_tpu_torch.ops import grammar, prng

    base = prng.base_key(seed3, device=dev)
    slots = np.arange(GEN_SLOTS)
    sel = twin_slots()
    card_out = {}
    times = {}
    for name in GEN_GRAMMARS:
        cg = gen_grammar(name)
        for fuzz in (False, True):
            expand = grammar.make_expand(cg, fuzz=fuzz)
            for case in GEN_CASES:
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = [x.cpu().numpy() for x in expand(base, case, slots)]
                times[(name, fuzz, case)] = (
                    (time.perf_counter() - t) * 1e3, expand.steps,
                    int(got[2].sum()))
                card_out[(name, fuzz, case)] = got
    wide = gen_grammar("wide")
    expand = grammar.make_expand(wide)
    expand(base, 0, slots)  # the tables to the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    wide_out = [x.cpu().numpy() for x in expand(base, 0, slots)]
    wide_ms = (time.perf_counter() - t) * 1e3
    wide_steps = expand.steps
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        expand(base, 0, slots)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t) * 1e3
    busy, ops = device_busy(prof)
    launches = sum(e.count for e in ops)

    proc, path = twins
    t = time.perf_counter()
    check(proc.wait(timeout=900) == 0, "(a) the CPU expander failed")
    waited = time.perf_counter() - t
    cpu = np.load(path)
    for (name, fuzz, case), (panel, lens, trunc) in card_out.items():
        tag = f"{name}-{int(fuzz)}-{case}-"
        for what, a in (("panel", panel), ("lens", lens), ("trunc", trunc)):
            check(np.array_equal(a, cpu[tag + what]),
                  f"(a) {name} fuzz={fuzz} case {case}: card != CPU {what}")
        for what, a in (("twin", panel[sel]), ("twin_lens", lens[sel]),
                        ("twin_trunc", trunc[sel])):
            check(np.array_equal(a, cpu[tag + what]),
                  f"(a) {name} fuzz={fuzz} case {case}: card != keyed "
                  f"twin ({what})")
    for what, a in (("panel", wide_out[0][sel]), ("lens", wide_out[1][sel]),
                    ("trunc", wide_out[2][sel]), ("twin", wide_out[0][sel]),
                    ("twin_lens", wide_out[1][sel]),
                    ("twin_trunc", wide_out[2][sel])):
        check(np.array_equal(a, cpu["wide-" + what]),
              f"(a) wide: card != CPU/twin {what}")
    check(not wide_out[2].any() and int(wide_out[1].min()) > 0,
          "(a) wide rows truncated or empty")
    for name in GEN_GRAMMARS:
        cg = gen_grammar(name)
        print(f"gen (a) {name} (width {cg.width}, max_steps "
              f"{cg.max_steps}) x {GEN_SLOTS} slots, cases {GEN_CASES}: "
              + "; ".join(
                  f"fuzz {'on' if f else 'off'} case {c}: {ms:.1f} ms, "
                  f"{steps} steps, {tr} truncated"
                  for (n, f, c), (ms, steps, tr) in times.items()
                  if n == name)
              + f"; card == CPU, {GEN_TWIN_SLOTS} slots == keyed twin")
    print(f"gen (a) wide {GEN_WIDE!r} (width {wide.width}) x {GEN_SLOTS} "
          f"slots: {wide_ms:.1f} ms a panel (wall, synchronized; the "
          f"tables already on the card), {wide_steps} steps of max_steps "
          f"{wide.max_steps}, {launches} launches a panel "
          f"(torch.profiler; {prof_ms:.1f} ms profiled, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / prof_ms:.3f}), peak "
          f"device memory {peak} B, {int(wide_out[1].sum())} bytes; "
          f"{GEN_TWIN_SLOTS} rows == CPU == keyed twin; the CPU side "
          f"waited {waited:.1f}s; card {card}")


def gen_cli(argv, env):
    """``python -m erlamsa_tpu_torch`` in this process (the campaign's
    launches are counted here): returns (exit code, stderr text)."""
    import io

    from erlamsa_tpu_torch.obs import trace
    from erlamsa_tpu_torch.services import chaos, cli, metrics

    metrics.GLOBAL = metrics.Counters()
    err, real = io.StringIO(), sys.stderr
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    sys.stderr = err
    try:
        rc = cli.main(argv)
    except BaseException:
        real.write(err.getvalue()[-3000:])
        raise
    finally:
        sys.stderr = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        trace.configure(None)
        chaos.configure(None)
    return rc, err.getvalue()


def gen_args(seed3, work, tag, spec, batch, device):
    """The campaign's command line: --gen SPEC seeding a --feedback
    store under work/tag, files to work/tag-out."""
    os.makedirs(os.path.join(work, tag + "-out"))
    return ["-s", ",".join(map(str, seed3)), "-n", str(GEN_CAMPAIGN_CASES),
            "--gen", spec, "--feedback", "--corpus",
            os.path.join(work, tag), "--layout", "arena", "--adopt",
            "--batch", str(batch), "--device", device, "-o",
            os.path.join(work, tag + "-out", "%n")]


def gen_campaign(seed3, dev, card, work, meanwhile):
    """Phase 12 (b): --gen wide:4096 --feedback --corpus DIR --adopt
    --batch 4096 -n 2 through the CLI on the card (ERLAMSA_PALLAS=2),
    with --metrics-out and --trace; the same command under --chaos
    gen.expand:x1 in a process of its own meanwhile (its panel on the
    keyed twin) writes the same files; at :64, batch 64, card == CPU;
    obs.report over the files prints a stage ledger. ``meanwhile()``
    runs while the chaos run ends. Returns the case kernel's launches of
    the clean run."""
    import torch

    grammar_file = os.path.join(work, "wide.gf")
    with open(grammar_file, "w") as f:
        f.write(GEN_WIDE + "\n")
    spec = f"{grammar_file}:{GEN_SLOTS}"
    here = os.path.dirname(os.path.abspath(__file__))
    t_chaos = time.perf_counter()
    chaos_log = open(os.path.join(work, "chaos.err"), "w+")
    chaos_proc = subprocess.Popen(
        [sys.executable, "-m", "erlamsa_tpu_torch",
         *gen_args(seed3, work, "chaos", spec, BATCH, dev.type),
         "--chaos", "gen.expand:x1", "--metrics-out",
         os.path.join(work, "chaos-m.json")], cwd=work,
        env=dict(os.environ, PYTHONPATH=here, ERLAMSA_PALLAS="2"),
        stdout=subprocess.DEVNULL, stderr=chaos_log)
    try:
        metrics_path = os.path.join(work, "m.json")
        trace_path = os.path.join(work, "t.json")
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rc, err = gen_cli(gen_args(seed3, work, "clean", spec, BATCH,
                                   dev.type)
                          + ["--metrics-out", metrics_path, "--trace",
                             trace_path], {"ERLAMSA_PALLAS": "2"})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        check(rc == 0, f"(b) the campaign failed: {err[-2000:]}")
        said = [ln for ln in err.splitlines() if ln.startswith("# gen:")]
        check(len(said) == 1 and "host-degraded" not in said[0],
              f"(b) the # gen: line: {said}")
        with open(metrics_path) as f:
            snap = json.load(f)
        check(snap["gen"]["expansions"] == GEN_SLOTS
              and snap["gen"]["host_fallback"] == 0,
              f"(b) gen metrics {snap['gen']}")
        stages = snap["pipeline"]["stages"]
        check(launches["case_rounds"] > 0 and launches["round_apply"] == 0,
              f"(b) launches {launches}")
        samples = GEN_CAMPAIGN_CASES * BATCH
        clean = digests(os.path.join(work, "clean-out"), samples)

        # the report tool over the clean run's files
        res = subprocess.run(
            [sys.executable, "-m", "erlamsa_tpu_torch.obs.report",
             "--metrics", metrics_path, "--trace", trace_path], cwd=work,
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=here))
        check(res.returncode == 0 and "-- stage ledger" in res.stdout,
              f"(b) obs.report: {res.stdout[-1000:]} {res.stderr[-1000:]}")
        ledger = res.stdout.split("-- stage ledger")[1].split("\n\n")[0]
        ledger_rows = [ln for ln in ledger.splitlines()[1:] if ln.strip()]
        check(ledger_rows, "(b) obs.report printed an empty stage ledger")

        # card == CPU at a small size, each run through the CLI here
        small = {}
        t_small = time.perf_counter()
        for i, device in enumerate((dev.type, "cpu")):
            tag = f"small-{i}"
            rc, err = gen_cli(gen_args(seed3, work, tag,
                                       f"{grammar_file}:{GEN_SMALL}",
                                       GEN_SMALL, device),
                              {"ERLAMSA_PALLAS": "2"})
            check(rc == 0, f"(b) the {device} run at :{GEN_SMALL} failed: "
                  f"{err[-2000:]}")
            small[i] = (digests(os.path.join(work, tag + "-out"),
                                     GEN_CAMPAIGN_CASES * GEN_SMALL),
                             sorted(os.listdir(os.path.join(work, tag,
                                                            "seeds"))))
        check(small[0] == small[1],
              f"(b) at :{GEN_SMALL}, batch {GEN_SMALL}: card != CPU")
        small_s = time.perf_counter() - t_small

        meanwhile()
        chaos_proc.wait(timeout=900)
        chaos_secs = time.perf_counter() - t_chaos
        chaos_log.seek(0)
        chaos_err = chaos_log.read()
        check(chaos_proc.returncode == 0,
              f"(b) the chaos run failed: {chaos_err[-2000:]}")
        with open(os.path.join(work, "chaos-m.json")) as f:
            chaos_gen = json.load(f)["gen"]
        check(chaos_gen["host_fallback"] > 0,
              f"(b) the chaos run's gen metrics {chaos_gen}")
        check(digests(os.path.join(work, "chaos-out"), samples) == clean,
              "(b) the chaos run's files differ from the clean run's")
        check(sorted(os.listdir(os.path.join(work, "chaos", "seeds")))
              == sorted(os.listdir(os.path.join(work, "clean", "seeds"))),
              "(b) the chaos run's store differs from the clean run's")
        chaos_said = [ln for ln in chaos_err.splitlines()
                      if ln.startswith("# gen:")]
    finally:
        if chaos_proc.poll() is None:
            chaos_proc.kill()
            chaos_proc.wait()
        chaos_log.close()
    stage_s = ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items()))
    print(f"gen (b) --gen wide:{GEN_SLOTS} --feedback --layout arena "
          f"--adopt --batch {BATCH} -n {GEN_CAMPAIGN_CASES}, level 2, "
          f"through the CLI: {samples / secs:.1f} samples/s over the run "
          f"({secs:.1f}s, the store's {GEN_SLOTS} adds included); "
          f"{said[0][2:]}; case kernel launches {launches['case_rounds']}; "
          f"stages (s): {stage_s}; peak device memory {peak} B; card "
          f"{card}")
    print(f"gen (b) the same under --chaos gen.expand:x1 in its own "
          f"process ({chaos_secs:.1f}s): {chaos_said[0][2:] if chaos_said else '?'}; "
          f"host_fallback {chaos_gen['host_fallback']}, files and store == "
          f"the clean run's; at :{GEN_SMALL}, batch {GEN_SMALL}: card == "
          f"CPU (files and store; {small_s:.1f}s both); obs.report: "
          f"{len(ledger_rows)} stage ledger rows")
    return launches["case_rounds"]


def gf_session(port, packets):
    """One connection to a gfcomms server, lockstep, each reply read to
    its expected length (``packets``: (request, expected reply))."""
    import socket

    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.settimeout(60)
        for req, want in packets:
            s.sendall(req)
            buf = b""
            while len(buf) < len(want):
                chunk = s.recv(65536)
                check(chunk, "(c) the server closed the connection")
                buf += chunk
            out.append(buf)
    return out


def gen_gfcomms(seed3, dev, card, work):
    """Phase 12 (c): gfcomms sequential at a fixed seed replays the
    ErlRand stream's bytes twice; batched on the card, GF_CONNS loopback
    connections x GF_PACKETS packets from a process of its own: every
    reply == the CPU engine's expand(conn, slot); packets/s, p50/p99."""
    from erlamsa_tpu_torch.gen import (BUILTIN_GRAMMARS, GenEngine,
                                       parse_grammar)
    from erlamsa_tpu_torch.models.genfuzz import fuzz_grammar
    from erlamsa_tpu_torch.services.gfcomms import GfComms
    from erlamsa_tpu_torch.utils.erlrand import ErlRand

    tree = parse_grammar(BUILTIN_GRAMMARS["demo-lines"])
    r = ErlRand(seed3)
    want = [fuzz_grammar(r, tree) for _ in range(GF_PACKETS)]
    runs = []
    for _ in range(2):
        srv = GfComms(0, grammar=tree, seed=seed3).serve(block=False)
        try:
            runs.append(gf_session(srv._srv.getsockname()[1],
                                   [(b"x", w) for w in want]))
        finally:
            srv.stop()
    check(runs[0] == runs[1] == want,
          "(c) sequential gfcomms did not replay the seed's bytes")

    cg = gen_grammar("sink")
    # every (connection, packet) in one expansion on the CPU
    t = time.perf_counter()
    cpu, _trunc = GenEngine(cg, seed3, fuzz=True, device="cpu").expand(
        np.repeat(np.arange(GF_CONNS), GF_PACKETS),
        slots=np.tile(np.arange(GF_PACKETS), GF_CONNS))
    expected = [cpu[c * GF_PACKETS:(c + 1) * GF_PACKETS]
                for c in range(GF_CONNS)]
    cpu_s = time.perf_counter() - t
    want_path = os.path.join(work, "gf-want.json")
    with open(want_path, "w") as f:
        json.dump([[w.hex() for w in rows] for rows in expected], f)
    eng = GenEngine(cg, seed3, fuzz=True, device=dev)
    srv = GfComms(0, seed=seed3, engine=eng).serve(block=False)
    try:
        out_path = os.path.join(work, "gf-out.json")
        res = subprocess.run(
            [sys.executable, "-c", GF_CLIENT,
             str(srv._srv.getsockname()[1]), want_path, out_path],
            capture_output=True, text=True, timeout=600)
        check(res.returncode == 0, f"(c) the load client: {res.stderr}")
    finally:
        srv.stop()
    with open(out_path) as f:
        load = json.load(f)
    check(not load["errors"], f"(c) batched replies: {load['errors'][:4]}")
    check(sorted(load["found"]) == list(range(GF_CONNS)),
          f"(c) connections answered as {sorted(load['found'])}")
    check(eng.expansions == GF_CONNS * GF_PACKETS and not eng.degraded,
          f"(c) {eng.expansions} expansions, degraded {eng.degraded}")
    lat = np.sort(np.array(load["lat"])) * 1e3
    print(f"gen (c) gfcomms sequential -s {','.join(map(str, seed3))}: "
          f"{GF_PACKETS} replies == the ErlRand stream's, twice; batched "
          f"on the card (sink, fuzz): {GF_CONNS} loopback connections x "
          f"{GF_PACKETS} packets from a process of its own, every reply "
          f"== the CPU engine's expand(conn, slot): "
          f"{len(lat) / load['wall']:.1f} packets/s, p50/p99 "
          f"{np.percentile(lat, 50):.2f}/{np.percentile(lat, 99):.2f} ms "
          f"({load['wall']:.1f}s; the CPU's {GF_CONNS * GF_PACKETS} rows "
          f"{cpu_s:.1f}s); card {card}")


def gen_phase(seed, seed3, dev, card, twins):
    """Phase 12: grammar generation on the card. Returns the case
    kernel's launches of (b)'s campaign."""
    from erlamsa_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_gen_",
                            dir=cuda_build.BUILD_DIR)
    try:
        # (c) and (a) while (b)'s chaos run, in its own process, ends
        launches = gen_campaign(seed3, dev, card, work, lambda: (
            gen_gfcomms(seed3, dev, card, work),
            gen_expander(seed3, dev, card, twins)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"gen phase: {time.perf_counter() - t_phase:.1f}s")
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digests_of(payloads):
    import hashlib

    return [hashlib.sha1(p).digest() for p in payloads]


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


def dev_us(e):
    """A profiler entry's own device time in us."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_busy(prof):
    """(ms the device was busy: the union of its op intervals, the
    device ops by own device time, largest first)."""
    import torch

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
    ops = [e for e in prof.key_averages() if e.device_type == dev_type]
    ops.sort(key=dev_us, reverse=True)
    return busy / 1e3, ops


def profile_slot_step(payloads, seed3, dev, card):
    """Phase 9 with --profile: one 64 x 16384 level-2 slot step (the
    first 64 payloads of (a)) under torch.profiler, as the engine thread
    runs it (upload, step, event, copy out): wall, device busy and idle
    share, the case kernel's share, and the ten largest host ops by own
    CPU time with their call counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from erlamsa_tpu_torch.ops import prng
    from erlamsa_tpu_torch.ops import slots as slotops
    from erlamsa_tpu_torch.ops.paged import PAGE, new_arena

    rows = SERVE_CAPACITY // PAGE
    table_np = slotops.slot_table(SERVE_SLOTS, rows)
    table = slotops.to_device(table_np, torch.int64, dev)
    arena = new_arena(slotops.arena_pages(SERVE_SLOTS, rows), device=dev)
    step = slotops.STEP_CACHE.slot_step(SERVE_SLOTS, rows, device=dev,
                                        level=2)
    base = prng.base_key(seed3, device=dev)
    part = payloads[:SERVE_SLOTS]
    lens = np.array([len(p) for p in part], np.int32)
    occ = np.ones(SERVE_SLOTS, np.int32)

    def one(k):
        rids = np.arange(k * SERVE_SLOTS, (k + 1) * SERVE_SLOTS,
                         dtype=np.int32)
        slotops.upload_slots(arena, table_np, list(enumerate(part)))
        out, n = step(arena, table, base, rids, lens, occ)
        torch.cuda.synchronize()
        return out.cpu(), n.cpu()

    one(0)  # warm: allocator, pinned host blocks
    t = time.perf_counter()
    one(1)
    plain_wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        one(1)
        wall = (time.perf_counter() - t) * 1e3
    busy, ops = device_busy(prof)
    kern = sum(dev_us(e) for e in ops if "case_rounds_kernel" in e.key) / 1e3
    host = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CUDA]
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    launches = sum(e.count for e in ops)
    print(f"profile serving slot step (level 2) at [{SERVE_SLOTS}, "
          f"{SERVE_CAPACITY}]: {plain_wall:.3f} ms unprofiled, {wall:.3f} "
          f"ms profiled, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {launches} device ops; case kernel "
          f"{kern:.4f} ms; card {card}")
    for e in host[:10]:
        print(f"  host {e.self_cpu_time_total / 1e3:9.4f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    for e in ops[:5]:
        print(f"  device {dev_us(e) / 1e3:9.4f} ms x{e.count:<5d} "
              f"{e.key[:90]}")


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
    busy, ops = device_busy(prof)
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
    ap.add_argument("--feedback-only", action="store_true",
                    help="build the kernels and run phase 8 alone (no "
                         "result lines)")
    ap.add_argument("--full-set-only", action="store_true",
                    help="build the kernels and run phase 4 at level 2 "
                         "alone, at 2 and 4 cases (no result lines)")
    ap.add_argument("--serving-only", action="store_true",
                    help="build the kernels and run phase 9 alone (no "
                         "result lines)")
    ap.add_argument("--proxy-only", action="store_true",
                    help="build the kernels and run phase 10 alone (no "
                         "result lines)")
    ap.add_argument("--coverage-only", action="store_true",
                    help="build the kernels and run phase 11 alone, its "
                         "store built meanwhile (no result lines)")
    ap.add_argument("--gen-only", action="store_true",
                    help="build the kernels and run phase 12 alone (no "
                         "result lines)")
    ap.add_argument("--build-store", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)  # phase 8's store, in a process
    ap.add_argument("--cov-twins", metavar="FILE", default=None,
                    help=argparse.SUPPRESS)  # phase 11 (a)'s numpy twins
    ap.add_argument("--gen-twins", metavar="FILE", default=None,
                    help=argparse.SUPPRESS)  # phase 12 (a)'s CPU side
    ap.add_argument("--gen-threads", type=int, default=4,
                    help=argparse.SUPPRESS)  # its torch threads
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
    if args.build_store:
        return build_store(args.build_store, args.seed)
    if args.cov_twins:
        return cov_twins(args.cov_twins, args.seed)
    if args.gen_twins:
        return gen_twins(args.gen_twins, args.seed, args.gen_threads)
    t_start = time.perf_counter()
    if args.full_set_only:
        return full_set_alone(args.seed)
    if args.serving_only:
        return serving_alone(args.seed, t_start, args.profile)
    if args.proxy_only:
        return proxy_alone(args.seed, t_start)
    from erlamsa_tpu_torch.ops import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    store_root = tempfile.mkdtemp(prefix="chip_smoke_store_",
                                  dir=cuda_build.BUILD_DIR)
    gen_path = os.path.join(store_root, "gen.npz")
    # processes started later by phases(), stopped here however it ends
    later = []
    if args.gen_only:
        # phase 12 (a)'s CPU expander in a process of its own meanwhile
        later.append(start_gen_twins(here, args.seed, gen_path, 4))
        try:
            return gen_alone(args.seed, t_start, later[0])
        finally:
            if later[0][0].poll() is None:
                later[0][0].kill()
                later[0][0].wait()
            shutil.rmtree(store_root, ignore_errors=True)
    # phase 8's campaign store builds in a process of its own meanwhile
    store_proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(args.seed),
         "--build-store", store_root], cwd=here)
    # and phase 11 (a)'s numpy twins in another
    twins_path = os.path.join(store_root, "twins.npz")
    twins_proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(args.seed),
         "--cov-twins", twins_path], cwd=here)
    try:
        if args.coverage_only:
            return coverage_alone(args.seed, t_start,
                                  (store_proc, store_root),
                                  (twins_proc, twins_path))
        return phases(args, here, t_start, (store_proc, store_root),
                      (twins_proc, twins_path), later, gen_path)
    finally:
        for proc in [store_proc, twins_proc] + [p for p, _f in later]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(store_root, ignore_errors=True)


def full_set_alone(seed) -> int:
    """--full-set-only: phase 4's level-2 run on a corpus like phase 3's,
    at FULL_CASES and twice as many cases, nothing else running: the
    two rates give a run's fixed seconds and its seconds a case."""
    from erlamsa_tpu_torch.ops import cuda_build

    cuda_build.build_all(["round_apply", "case_rounds", "randmask"])
    corpus = make_corpus(np.random.default_rng(seed), BATCH)
    secs = {}
    for cases in (FULL_CASES, 2 * FULL_CASES):
        launches, rate, _stats = full_set(2, corpus, (seed, 22, 33), "cuda",
                                          cases=cases)
        reap_host_workers()
        check(launches["case_rounds"] == cases,
              f"{cases} cases launched {launches}")
        secs[cases] = BATCH * cases / rate
    per_case = (secs[2 * FULL_CASES] - secs[FULL_CASES]) / FULL_CASES
    print(f"full set ERLAMSA_PALLAS=2 alone: {secs[FULL_CASES]:.2f}s at "
          f"{FULL_CASES} cases, {secs[2 * FULL_CASES]:.2f}s at "
          f"{2 * FULL_CASES}: {per_case:.2f}s a case, "
          f"{secs[FULL_CASES] - FULL_CASES * per_case:.2f}s fixed a run; "
          f"card {card_line()}")
    return 0


def serving_alone(seed, t_start, profile) -> int:
    """--serving-only: build the kernels and run phase 9 alone (with
    --profile, one slot step traced too)."""
    import torch

    from erlamsa_tpu_torch.ops import cuda_build

    for mod in ("jax", "erlamsa_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")
    card = card_line()
    print(f"card: {card}")
    cuda_build.build_all(["round_apply", "case_rounds", "randmask"])
    serving_phase(seed, (seed, 22, 33), torch.device("cuda"), card,
                  profile=profile)
    print(f"chip_smoke --serving-only: {time.perf_counter() - t_start:.1f}s")
    return 0


def proxy_alone(seed, t_start) -> int:
    """--proxy-only: build the kernels and run phase 10 alone."""
    import torch

    from erlamsa_tpu_torch.ops import cuda_build

    for mod in ("jax", "erlamsa_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")
    card = card_line()
    print(f"card: {card}")
    cuda_build.build_all(["round_apply", "case_rounds", "randmask"])
    proxy_phase(seed, (seed, 22, 33), torch.device("cuda"), card)
    print(f"chip_smoke --proxy-only: {time.perf_counter() - t_start:.1f}s")
    return 0


def coverage_alone(seed, t_start, build, twins) -> int:
    """--coverage-only: build the kernels and run phase 11 alone on a
    corpus like phase 3's; (c) waits for the store build."""
    import torch

    from erlamsa_tpu_torch.ops import cuda_build

    for mod in ("jax", "erlamsa_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")
    card = card_line()
    print(f"card: {card}")
    cuda_build.build_all(["round_apply", "case_rounds", "randmask"])
    corpus = make_corpus(np.random.default_rng(seed), BATCH)
    coverage_phase(seed, (seed, 22, 33), torch.device("cuda"), card, corpus,
                   build, twins)
    print(f"chip_smoke --coverage-only: {time.perf_counter() - t_start:.1f}s")
    return 0


def gen_alone(seed, t_start, gen_cpu) -> int:
    """--gen-only: build the kernels and run phase 12 alone."""
    import torch

    from erlamsa_tpu_torch.ops import cuda_build

    for mod in ("jax", "erlamsa_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")
    card = card_line()
    print(f"card: {card}")
    cuda_build.build_all(["round_apply", "case_rounds", "randmask"])
    gen_phase(seed, (seed, 22, 33), torch.device("cuda"), card, gen_cpu)
    print(f"chip_smoke --gen-only: {time.perf_counter() - t_start:.1f}s")
    return 0


def phases(args, here, t_start, build, twins, later, gen_path) -> int:
    """Phases 1-12 and the kernel timings; ``build`` is phase 8's store
    build (process, directory), ``twins`` phase 11 (a)'s numpy twins
    (process, file); phase 12 (a)'s CPU side starts before phase 8 into
    ``gen_path``, its (process, file) appended to ``later``."""
    import torch

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
    if args.feedback_only:
        feedback_phase(args.seed, (args.seed, 22, 33), dev, card, build)
        print(f"chip_smoke --feedback-only: "
              f"{time.perf_counter() - t_start:.1f}s")
        return 0
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

    # 5. the full set on the card == on the CPU, whole 64-row runs; it
    # times no rate, so it runs before phase 4, beside the store build
    mixed = mixed_corpus(np.random.default_rng(args.seed + 1), MIXED_ROWS)
    cpu_runs = {level: full_set_cuda_vs_cpu(level, mixed, seed3, dev)
                for level in (2, 0)}
    reap_host_workers()

    # phase 8's store build runs beside phases 1-3 and 5 only: phases 4
    # and 6 on time host-bound runs
    proc, _root = build
    t = time.perf_counter()
    check(proc.wait(timeout=900) == 0, "the store build failed")
    print(f"phases 1-3 and 5: {t - t_start:.1f}s; phase 4 waited "
          f"{time.perf_counter() - t:.1f}s for the store build to end")

    # 4. the full default set at full width, in the case-kernel stream and
    # the default composite one, the counts read per run
    full = {level: full_set(level, corpus, seed3, dev, cases=cases)
            for level, cases in ((2, FULL_CASES), (0, FULL_CASES_L0))}
    reap_host_workers()
    check(full[2][0]["case_rounds"] == FULL_CASES and
          full[2][0]["round_apply"] == 0,
          f"the full set at ERLAMSA_PALLAS=2 launched {full[2][0]}, want the "
          "case kernel once per case")
    check(not any(full[0][0].values()),
          f"the full set's composite path launched {full[0][0]}")
    # 6. state and I/O through run_batch
    state_io(corpus, mixed, cpu_runs, seed3, dev, card)
    reap_host_workers()
    # 7. the structured-format engine through run_batch
    struct_phase(np.random.default_rng(args.seed + 2), mixed, seed3, dev,
                 card, with_off=args.profile)
    reap_host_workers()
    # phase 12 (a)'s CPU expander, in a process of its own beside phases
    # 8-11 (after the host-bound phases 4-7, on two threads)
    later.append(start_gen_twins(here, args.seed, gen_path, 2))
    # 8. the feedback corpus engine through run_corpus_batch
    adopt_rate = feedback_phase(args.seed, seed3, dev, card, build)
    # 9. the FaaS serving tier through serve() and the CLI's -H
    serving_phase(args.seed, seed3, dev, card, profile=args.profile)
    # 10. the fuzzing proxy (-i) and the bridge server (-m xla)
    proxy_launches = proxy_phase(args.seed, seed3, dev, card)
    # 11. the coverage plane, distillation and the host tier
    cov_launches = coverage_phase(args.seed, seed3, dev, card, corpus,
                                  build, twins, adopt_rate=adopt_rate)
    # 12. grammar generation: the expander, the --gen campaign, gfcomms
    gen_launches = gen_phase(args.seed, seed3, dev, card, later[-1])

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
                 launches[2]["case_rounds"] + proxy_launches
                 + cov_launches + gen_launches,
                 max(errs["case_rounds"], err),
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
    # randmask_single (the same kernel, one row): the first timing row
    one = (mkeys[0], params[0], mdata[0])
    ms = graph_ms(lambda: rm.randmask_single(*one))
    wrap_ms = cuda_ms(lambda: rm.randmask_single(*one), 50)
    plain_ms = cuda_ms(lambda: rm.randmask_plain(*(x[None] for x in one)), 5)
    err = max_err(rm.randmask_single(*one),
                  rm.randmask_plain(*(x[None] for x in one))[0])
    check(err == 0, "randmask_single != plain at the main path's width")
    words = int(inspan[0].sum()) + int((inspan[0] & (occ_n[0] < 50)).sum())
    moved = 2 * L + 16 + 5 * 4
    bound_ms, bound_by = bound(moved, words, pipes)
    rows.append(("randmask_single", "erlamsa_tpu/ops/pallas_kernels.py:363",
                 mask_launches, max(errs["randmask"], err), ms, plain_ms,
                 bound_ms, bound_by, 1, L, moved, words, wrap_ms))
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
        "source": f"erlamsa_tpu_torch/csrc/{name.split('_single')[0]}.cu",
        "replaces": rep,
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
