"""Batch runner: corpus -> padded class panels -> mutation -> outputs
(erlamsa_tpu/services/batchrunner.py::run_tpu_batch).

Seeds are replicated round-robin up to the batch size, grouped by the
smallest capacity class that fits them, and keyed by their ORIGINAL
corpus index, so a sample's bytes do not depend on how the classes
partition the batch. Scheduler scores carry from case to case.

Each case, the hybrid dispatcher (services/hybrid.py) routes some rows to
the host oracle on the case's pre scores; rows in a class above
``device_capacity_max`` go to the oracle whole. Results overlay in the
reference's order: device, then host, then overflow. Case k is launched
(split, device steps, host work submitted) before case k-1's host
outcomes are applied, so split(k) sees host scores through case k-2,
exactly as in the reference.

With ``struct`` "host" or "device" (--struct) the structured-format
engine takes the struct codes (ops/structure.py): they leave the
dispatcher's host set (zip stays), each distinct seed is tokenized once
into a span table, and each case the router picks, on the same pre
scores, rows and a struct code for each; those rows still run the class
step (their scores update) and their bytes are then replaced by the span
splice. "device" runs it as ops/tree_mutators.struct_step on a source
panel uploaded once (per case only row indices, slots and codes cross);
"host" runs the span-oracle on a host thread. Both write the same bytes.
Results overlay in the order device, struct, host, overflow.

With a state file (--state) a run checkpoints and resumes as the
reference's does, in the same file format (services/checkpoint.py): after
case k it saves the device scores as of case k, the host scores the
split of case k+1 saw and those with case k's outcomes folded in. A
resumed run feeds the first into the dispatcher before its first launch
and swaps the second in right after it, so it routes and writes exactly
what the uninterrupted run did. -n is the total number of cases.

With --trace (obs/trace.py) each class step's launch is a
``batch.dispatch`` span, the copy-out of a case's device rows
``batch.drain``, the wait on its host rows ``batch.host_wait`` and its
writes ``batch.write``: the host's share of a case beside the device's
kernels under --xprof. Spans change no byte.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..constants import CAPACITY_CLASSES, DEFAULT_MAX_RUNNING_TIME
from ..obs import trace
from ..ops import payloads, prng, registry
from ..ops import structure as stm
from ..ops.buffers import capacity_for, pack, scan_bound
from ..ops.pipeline import make_class_fuzzer
from ..ops.registry import DEVICE_CODES, NUM_DEVICE_MUTATORS
from ..ops.scheduler import init_scores
from ..ops.tree_mutators import struct_step
from ..oracle.engine import fuzz as oracle_fuzz
from ..oracle.mutations import default_mutations
from ..utils.watchdog import CaseTimeout, run_with_timeout
from . import logger, metrics, out
from .checkpoint import load_state, save_state
from .hybrid import HybridDispatcher


def _load_corpus(paths: list[str], recursive: bool,
                 direct: list[bytes] | None = None,
                 store_dir: str | None = None) -> list[bytes]:
    from ..oracle.gen import _expand_paths

    if direct is not None and store_dir is None:
        # in-process callers (chip_smoke, tests) hand the corpus over
        # directly instead of staging files
        return list(direct)
    if store_dir is not None:
        # --corpus: dedup everything through the persistent store and run
        # over the deduped seed set, in store insertion order
        from ..corpus.store import CorpusStore

        store = CorpusStore(store_dir)
        for s in direct or []:
            store.add(s, origin="direct")
        in_paths = [p for p in paths if p != "-"]
        if in_paths:
            new, dup, skipped = store.add_paths(
                _expand_paths(in_paths) if recursive else in_paths
            )
            print(f"# corpus: {new} new, {dup} duplicate, {skipped} "
                  f"skipped -> {len(store)} seeds in store", file=sys.stderr)
        return [store.get(sid) for sid in store.ids()]
    if paths in ([], ["-"]):
        return [sys.stdin.buffer.read()]
    seeds = []
    for p in _expand_paths(paths) if recursive else paths:
        # a mid-run raise on one bad file would abandon the whole batch:
        # skip unreadable/empty seeds with a logged warning instead
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError as e:
            logger.log("warning", "corpus: skipping unreadable seed %s: %s",
                       p, e)
            continue
        if not data:
            logger.log("warning", "corpus: skipping empty seed %s", p)
            continue
        seeds.append(data)
    return seeds


def service_budget(opts: dict) -> float:
    """Per-case budget of host-routed work: -T when given, else the
    reference's 30 s service default."""
    mrt = opts.get("maxrunningtime")
    return DEFAULT_MAX_RUNNING_TIME if mrt is None else float(mrt)


def device_priorities(mutations) -> list[int]:
    """The device priority vector (registry order) of the selected set
    [(code, pri)] (None: the oracle's default set)."""
    selected = dict(mutations or default_mutations())
    return [selected.get(code, 0) for code in DEVICE_CODES]


def class_panels(corpus: list[bytes], device, rows=None):
    """{capacity: (indices int64, Batch, scan_len)} for the corpus rows
    ``rows`` (default: all of them)."""
    groups: dict[int, list[int]] = {}
    for i in range(len(corpus)) if rows is None else rows:
        groups.setdefault(capacity_for(len(corpus[i])), []).append(i)
    return {
        cls: (torch.as_tensor(np.asarray(idx, np.int64), device=device),
              pack([corpus[i] for i in idx], capacity=cls, device=device),
              scan_bound(max(len(corpus[i]) for i in idx), cls))
        for cls, idx in sorted(groups.items())
    }


class DevicePath:
    """The device side of a run: the class panels of ``rows`` and the
    scores of every corpus row (int32[len(corpus), 31]), carried from
    case to case. ``level`` picks the stream (ops/fused.pallas_level;
    None reads ERLAMSA_PALLAS)."""

    def __init__(self, corpus, seed, mutator_pri, device, level=None,
                 rows=None):
        self.panels = class_panels(corpus, device, rows)
        self.step = make_class_fuzzer(mutator_pri=mutator_pri, device=device,
                                      level=level)
        self.base = prng.base_key(tuple(seed), device=device)
        self.scores = init_scores(prng.fold_in(self.base, 999), len(corpus))

    def run(self, case):
        """Mutate every panel for one case. Returns [(indices, data, lens,
        scores, meta) per class]."""
        outs = []
        for idx, packed, scan_len in self.panels.values():
            with trace.span("batch.dispatch", case=case,
                            capacity=int(packed.data.shape[1]),
                            rows=len(idx)):
                data, lens, cls_scores, meta = self.step(
                    self.base, case, idx, packed.data, packed.lens,
                    self.scores[idx], scan_len=scan_len)
            self.scores[idx] = cls_scores
            outs.append((idx, data, lens, cls_scores, meta))
        return outs


def fuzz_cases(corpus: list[bytes], seed, mutator_pri, n_cases: int,
               device, level=None):
    """The device path alone: pack ``corpus`` into class panels on
    ``device`` and mutate it for ``n_cases`` cases. Yields (case,
    [(indices, data, lens, scores, meta) per class])."""
    path = DevicePath(corpus, seed, mutator_pri, device, level)
    for case in range(n_cases):
        yield case, path.run(case)


def _resume(state_path, seed, batch, level):
    """(start case, device scores, host scores pre, host scores post) of
    the checkpoint at ``state_path`` that fits this run, or None to start
    fresh (no file, unreadable, another stream's stamp, another seed or
    shape), with the reference's stderr lines."""
    if not state_path or not os.path.exists(state_path):
        return None
    st = load_state(state_path, level=level)
    if st is None:
        print("# checkpoint unreadable, starting fresh", file=sys.stderr)
        return None
    ck_seed, start_case, ck_scores, ck_host, ck_host_post = st
    if (ck_seed != tuple(seed)
            or ck_scores.shape != (batch, NUM_DEVICE_MUTATORS)):
        print("# checkpoint mismatch (seed/shape), starting fresh",
              file=sys.stderr)
        return None
    print(f"# resumed at case {start_case}", file=sys.stderr)
    return start_case, ck_scores, ck_host, ck_host_post


def hybrid_cases(corpus: list[bytes], seed, mutations, n_cases: int,
                 device, level=None, budget=DEFAULT_MAX_RUNNING_TIME,
                 device_max=CAPACITY_CLASSES[-1], stats=None,
                 state_path=None, checkpoint_every=1, struct="off"):
    """The full mutator set over ``corpus``: device classes, struct rows,
    host-routed rows and overflow rows, case by case. ``mutations`` is
    [(code, pri)] (None: the oracle's default set). Yields (case, [bytes
    per row]). ``struct``: "off", "host" or "device" (--struct).

    ``state_path``: checkpoint file. A run resumes from it when it fits
    (same seed, batch and stream) and saves to it after every
    ``checkpoint_every`` cases and after the last; ``n_cases`` is then
    the total, so a finished run yields nothing. Saves happen once the
    consumer has taken the case (its outputs written).

    ``stats``, a dict, gathers counts and times: host_routed, overflow,
    abandoned, device_s (issuing the device steps and reading their
    results back), host_wait_s (blocked on host work), start_case,
    saves and save_s (seconds in save_state); with the struct engine also
    struct (the mode), struct_bytes_uploaded (host to device bytes of the
    struct engine: the source panel once, then the routing vectors per
    case), struct_resident (rows in the source panel), tokenize_s (the
    span tables and applicability at the start), struct_rows (per case,
    the [(row, code)] routed) and, on a CUDA device, struct_ms (per case,
    the struct step's time on the stream between two CUDA events)."""
    if struct not in ("off", "host", "device"):
        raise ValueError(
            f"struct must be one of off/host/device, got {struct!r}")
    flag_before = registry.struct_kernels_enabled()
    registry.set_struct_kernels(struct != "off")
    try:
        yield from _hybrid_cases(corpus, seed, mutations, n_cases, device,
                                 level, budget, device_max, stats,
                                 state_path, checkpoint_every, struct)
    finally:
        # process-global: later runs in this process see their own split
        registry.set_struct_kernels(flag_before)


class _StructPanel:
    """The struct engine's set-up for a run: the span table of each
    distinct seed, the router, and the rows it may route (struct-
    applicable, not overflow) packed into one source panel as wide as
    their largest capacity class, each row keeping its own cap; on the
    device for "device" mode, uploaded once."""

    def __init__(self, corpus, seed, selected, overflow_set, mode, device):
        t = time.perf_counter()
        cache = stm.SpanCache()
        self.router = stm.StructRouter(seed, selected)
        first: dict[bytes, int] = {}  # tokenize each distinct seed once
        self.router.prepare(corpus, cache,
                            keys=[first.setdefault(raw, i)
                                  for i, raw in enumerate(corpus)])
        self.tokenize_s = time.perf_counter() - t
        appl = self.router.applicable_any()
        self.ids = [i for i in range(len(corpus))
                    if appl[i] and i not in overflow_set]
        self.pos_of = {i: r for r, i in enumerate(self.ids)}
        k = len(self.ids)
        self.caps = np.asarray([capacity_for(len(corpus[i]))
                                for i in self.ids], np.int32)
        self.src = np.zeros((k, int(self.caps.max()) if k else 0), np.uint8)
        self.lens = np.zeros(k, np.int32)
        self.nds = np.zeros((k, stm.SPAN_NODES, 4), np.int32)
        self.cnts = np.zeros(k, np.int32)
        for r, i in enumerate(self.ids):
            raw = corpus[i]
            self.src[r, :len(raw)] = np.frombuffer(raw, np.uint8)
            self.lens[r] = len(raw)
            self.nds[r], self.cnts[r] = cache.get(first[raw], raw)
        self.uploaded = 0
        self.dev = None
        if mode == "device" and k:
            arrays = (self.src, self.lens, self.nds, self.cnts, self.caps)
            self.dev = [torch.as_tensor(a, device=device) for a in arrays]
            self.uploaded = sum(a.nbytes for a in arrays)


def _hybrid_cases(corpus, seed, mutations, n_cases, device, level, budget,
                  device_max, stats, state_path, checkpoint_every, struct):
    selected = dict(mutations or default_mutations())
    seed = tuple(seed)
    batch = len(corpus)
    st = {} if stats is None else stats
    st.update(host_routed=0, overflow=0, abandoned=0, device_s=0.0,
              host_wait_s=0.0, start_case=0, saves=0, save_s=0.0,
              struct=struct, struct_bytes_uploaded=0)
    resumed = _resume(state_path, seed, batch, level)
    start_case = resumed[0] if resumed else 0
    st["start_case"] = start_case
    if state_path and start_case >= n_cases:
        print(f"# run already complete ({start_case}/{n_cases} cases)",
              file=sys.stderr)
        return
    overflow_idx = [i for i, s in enumerate(corpus)
                    if capacity_for(len(s)) > device_max]
    overflow_set = set(overflow_idx)
    # the struct codes leave the dispatcher's host set when the engine
    # takes them
    hybrid_sel = (selected if struct == "off" else
                  {c: p for c, p in selected.items()
                   if c not in stm.STRUCT_CODES})
    hybrid = HybridDispatcher(list(hybrid_sel.items()), seed,
                              max_running_time=budget)
    dev_path = DevicePath(corpus, seed, device_priorities(mutations), device,
                          level, rows=[i for i in range(batch)
                                       if i not in overflow_set])
    # post-outcome host scores to swap in AFTER the first resumed launch:
    # split(k) must see the pre state (one-case outcome lag), split(k+1)
    # the post state, as the uninterrupted run's splits did
    resume_host_post = None
    if resumed:
        dev_path.scores = torch.as_tensor(resumed[1]).to(dev_path.scores)
        for code, val in resumed[2].items():
            if code in hybrid.host_scores:
                hybrid.host_scores[code] = val
        resume_host_post = resumed[3]
    if overflow_idx:
        print(f"# {len(overflow_idx)} samples exceed the device budget "
              f"({device_max}B class): oracle-routed", file=sys.stderr)
    sp = None
    if struct != "off":
        sp = _StructPanel(corpus, seed, selected, overflow_set, struct,
                          device)
        st.update(struct_resident=len(sp.ids), tokenize_s=sp.tokenize_s,
                  struct_bytes_uploaded=sp.uploaded, struct_rows=[],
                  struct_ms=[])
        if not sp.ids:
            sp = None  # nothing struct-applicable in this corpus
    host_base = prng.base_key(seed)  # --struct host draws on the CPU
    on_cuda = torch.device(device).type == "cuda"

    def fuzz_struct_host(case_idx: int, routed):
        """--struct host: the span-oracle serves the routed rows with the
        counter-keyed draws the device step computes."""
        res = {}
        for i, ci in routed:
            r = sp.pos_of[i]
            key = stm.struct_sample_key(host_base, case_idx, i)
            res[i] = stm.host_struct_fuzz(key, corpus[i], sp.nds[r],
                                          int(sp.cnts[r]), ci,
                                          int(sp.caps[r]))
        return res

    def struct_launch(case, routed):
        """Start the struct step on the rows ``routed`` [(row, code)] of
        the resident panel (device), or submit the span-oracle (host)."""
        if struct == "host":
            return pool.submit(fuzz_struct_host, case, routed)
        sel = np.asarray([sp.pos_of[i] for i, _ in routed], np.int64)
        ev = None
        if on_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        sel_t = torch.as_tensor(sel, device=device)
        out = struct_step(dev_path.base, case, [i for i, _ in routed],
                          *(a[sel_t] for a in sp.dev),
                          [c for _, c in routed])
        if ev is not None:
            ev[1].record()
        # sel here; the row order, slots and codes struct_step uploads
        st["struct_bytes_uploaded"] += 4 * sel.nbytes
        return out, ev

    def fuzz_overflow(case_idx: int):
        """The whole oracle pipeline with the complete selected set for
        each sample beyond the largest device class, under the same
        budget as host-routed samples. Returns ({index: bytes}, the
        number abandoned); an abandoned sample emits b""."""
        res, lost = {}, 0
        for i in overflow_idx:
            seed3 = (seed[0], seed[1] ^ case_idx, seed[2] ^ (i + 1))
            try:
                res[i] = run_with_timeout(
                    oracle_fuzz, budget, corpus[i], seed=seed3,
                    mutations=list(selected.items()))
            except CaseTimeout:
                res[i] = b""
                lost += 1
        return res, lost

    def launch(case):
        """Split on the case's pre scores, issue the device steps and
        submit the host and overflow work. With a state file, the scores
        after this case are kept (a copy on the device): the next launch
        updates them before this case is saved."""
        t = time.perf_counter()
        scores_np = dev_path.scores.cpu().numpy()
        t2 = time.perf_counter()
        host_mask = hybrid.split(case, corpus, device_scores=scores_np)
        # struct routing sees the same pre scores; hybrid-routed and
        # overflow rows are excluded, so no row lands in two result sets
        struct_rows = []
        if sp is not None:
            excl = host_mask.copy()
            excl[overflow_idx] = True
            codes = sp.router.route(case, device_scores=scores_np,
                                    excluded=excl)
            struct_rows = [(i, int(codes[i])) for i in sp.ids
                           if codes[i] >= 0]
            st["struct_rows"].append(struct_rows)
        t3 = time.perf_counter()
        outs = dev_path.run(case)
        scores_after = dev_path.scores.clone() if state_path else None
        struct_work = struct_launch(case, struct_rows) if struct_rows else None
        st["device_s"] += (t2 - t) + (time.perf_counter() - t3)
        host_idx = [(int(i), corpus[i]) for i in np.nonzero(host_mask)[0]
                    if i not in overflow_set]
        host_fut = (pool.submit(hybrid.fuzz_host, case, host_idx,
                                defer_scores=True) if host_idx else None)
        of_fut = pool.submit(fuzz_overflow, case) if overflow_idx else None
        return (case, outs, struct_rows, struct_work, host_idx, host_fut,
                of_fut, scores_after)

    def finish(pend):
        """Overlay one launched case: device rows, struct rows, then host
        rows (their outcomes folded into the host scores here, in case
        order), then overflow rows; count the routed rows in the metrics.
        Returns (case, rows, the state to save after it)."""
        (case, outs, struct_rows, struct_work, host_idx, host_fut, of_fut,
         scores_after) = pend
        t = time.perf_counter()
        results: dict[int, bytes] = {}
        with trace.span("batch.drain", case=case):
            for idx, data, lens, _scores, _meta in outs:
                data_np, lens_np = data.cpu().numpy(), lens.cpu().numpy()
                for j, i in enumerate(idx.tolist()):
                    results[i] = data_np[j, : lens_np[j]].tobytes()
        # per-case host-tail ledger: {code: samples the host served}
        routed_codes: dict[str, int] = {}
        if struct_rows and struct == "device":
            (s_out, s_lens, s_applied), ev = struct_work
            out_np, lens_np = s_out.cpu().numpy(), s_lens.cpu().numpy()
            app_np = s_applied.cpu().numpy()
            if ev is not None:
                st["struct_ms"].append(ev[0].elapsed_time(ev[1]))
            for p, (i, ci) in enumerate(struct_rows):
                results[i] = out_np[p, : lens_np[p]].tobytes()
                metrics.GLOBAL.record_mutator(stm.STRUCT_CODES[ci],
                                              applied=int(app_np[p]) >= 0)
        t2 = time.perf_counter()
        st["device_s"] += t2 - t
        if struct_rows and struct == "host":
            struct_results = struct_work.result()
            for i, ci in struct_rows:
                results[i] = struct_results[i]
                code = stm.STRUCT_CODES[ci]
                metrics.GLOBAL.record_mutator(
                    code, applied=struct_results[i] != corpus[i])
                routed_codes[code] = routed_codes.get(code, 0) + 1
            # the parity path serves these rows on the host
            st["host_routed"] += len(struct_rows)
        # the overlapped next case's split already ran and saw host scores
        # through case-1; checkpoint that same pre-outcome state so a
        # resumed run's split(case+1) routes identically to this one
        host_pre = dict(hybrid.host_scores)
        if host_fut is not None:
            with trace.span("batch.host_wait", case=case):
                host_results, host_metas = host_fut.result()
            results.update(host_results)
            hybrid.apply_outcomes(host_metas)
            st["abandoned"] += len(host_idx) - len(host_results)
            for meta in host_metas:
                used = [v for t_, v in (e for e in meta
                                        if isinstance(e, tuple)
                                        and len(e) == 2)
                        if t_ == "used"]
                code = used[0] if used else "none"
                routed_codes[code] = routed_codes.get(code, 0) + 1
        if of_fut is not None:
            of_results, lost = of_fut.result()
            results.update(of_results)
            st["abandoned"] += lost
            routed_codes["overflow"] = (routed_codes.get("overflow", 0)
                                        + len(overflow_idx))
        metrics.GLOBAL.record_routed_total(batch)
        for code, n in sorted(routed_codes.items()):
            metrics.GLOBAL.record_host_routed(code, n)
        st["host_wait_s"] += time.perf_counter() - t2
        st["host_routed"] += len(host_idx)
        st["overflow"] += len(overflow_idx)
        return (case, [results.get(i, b"") for i in range(batch)],
                (scores_after, host_pre, dict(hybrid.host_scores)))

    every = max(1, int(checkpoint_every))

    def emit(done):
        """Yield one finished case, then (once its outputs are written)
        save the state after it when the cadence or the last case asks."""
        case, rows, (scores_after, host_pre, host_post) = done
        yield case, rows
        if state_path and ((case + 1 - start_case) % every == 0
                           or case + 1 == n_cases):
            t = time.perf_counter()
            save_state(state_path, seed, case + 1, scores_after.cpu().numpy(),
                       host_scores=host_pre, host_scores_post=host_post,
                       level=level)
            st["save_s"] += time.perf_counter() - t
            st["saves"] += 1

    pool = cf.ThreadPoolExecutor(max_workers=2)
    pending = None
    try:
        for case in range(start_case, n_cases):
            cur = launch(case)
            if resume_host_post is not None:
                # first resumed launch done: later splits build on the
                # post-outcome state, like the uninterrupted run's did
                for code, val in resume_host_post.items():
                    if code in hybrid.host_scores:
                        hybrid.host_scores[code] = val
                resume_host_post = None
            if pending is not None:
                yield from emit(finish(pending))
            pending = cur
        if pending is not None:
            yield from emit(finish(pending))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        hybrid.close()


def run_batch(opts: dict, batch: int = 1024, device=None, level=None) -> int:
    """The batch fuzzer. opts: seed (a, b, c), n (the total number of
    cases), paths, recursive (-r), corpus (seeds handed over in-process),
    corpus_dir (--corpus), mutations [(code, pri)] (None: the oracle's
    default set), output (-o, any form services/out.py takes),
    maxrunningtime (-T), device_capacity_max, state_path (--state),
    checkpoint_every, struct ("off", "host" or "device"; --struct), and
    optionally ssrf_host / ssrf_port, the reverse-connect endpoint baked
    into the shell-inject payloads, and _stats, a dict the run fills with
    its counts and times. ``level``
    picks the stream (None: ERLAMSA_PALLAS). Returns the process exit
    code."""
    dev = resolve_device(device)
    payloads.configure(opts.get("ssrf_host", "localhost"),
                       opts.get("ssrf_port", 51234))
    seeds = _load_corpus(opts.get("paths", ["-"]), opts.get("recursive", False),
                         direct=opts.get("corpus"),
                         store_dir=opts.get("corpus_dir"))
    if not seeds:
        print("no corpus", file=sys.stderr)
        return 1
    corpus = [seeds[i % len(seeds)] for i in range(batch)]
    if not any(device_priorities(opts.get("mutations"))):
        print("none of the selected mutations runs on the device; "
              f"device set: {','.join(DEVICE_CODES)}", file=sys.stderr)
        return 1
    stats = opts.get("_stats")
    stats = {} if stats is None else stats
    n_cases = opts.get("n", 1)
    writer = None
    t0 = time.perf_counter()
    total = 0
    for case, results in hybrid_cases(
            corpus, opts["seed"], opts.get("mutations"), n_cases,
            dev, level=level, budget=service_budget(opts),
            device_max=int(opts.get("device_capacity_max",
                                    CAPACITY_CLASSES[-1])),
            stats=stats, state_path=opts.get("state_path"),
            checkpoint_every=opts.get("checkpoint_every", 1),
            struct=str(opts.get("struct") or "off")):
        if writer is None:
            # made once a case is due, as the reference makes it after
            # the resume check: a finished run binds no socket
            writer = out.string_outputs(opts.get("output", "-"))[0] or (
                lambda _i, payload, _meta: sys.stdout.buffer.write(payload))
        with trace.span("batch.write", case=case):
            for i, payload in enumerate(results):
                writer(case * batch + i, payload, [])
        total += batch
    sys.stdout.flush()
    if opts.get("state_path") and stats["start_case"] >= n_cases:
        return 0
    dt = stats["dt"] = time.perf_counter() - t0
    state = (f", state saved {stats['saves']}x in {stats['save_s']:.3f}s"
             if opts.get("state_path") else "")
    if stats["struct"] != "off":
        state += (f", struct={stats['struct']} "
                  f"({stats['struct_resident']} rows resident)")
    print(f"# {total} samples on {dev} ({stats['host_routed']} host-routed, "
          f"{stats['overflow']} overflow, {stats['abandoned']} abandoned), "
          f"{dt:.2f}s, {total / max(dt, 1e-9):.0f} samples/s{state}",
          file=sys.stderr)
    return 0
