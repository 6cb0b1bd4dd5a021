"""Feedback-driven batch loop: store -> energy schedule -> buckets ->
device mutation -> feedback (erlamsa_tpu/corpus/runner.py, the
``--feedback --corpus DIR`` entry point), on the port's device path.

Per case:
  1. the energy scheduler draws `batch` seeds (weighted, counter-keyed)
  2. the assembler groups them into power-of-two length buckets
  3. each bucket rides one fuzz_batch call (device mutator set)
  4. outputs are hashed: a never-seen output hash bumps the source
     seed's energy (the cheap novelty signal standing in for coverage)
  5. the feedback bus is drained; monitor/proxy events promote the
     seeds that were in flight
  6. energies, the scheduler scores and the output hashes seen so far
     are checkpointed, so a resumed run schedules identically (the JAX
     package's runner saves no seen hashes: its resumed run departs
     from the uninterrupted one once an output hash recurs across the
     stop)

Execution pipelines (--pipeline, default async):

  sync   the serialized baseline: every bucket's outputs are copied to
         the host before the next bucket is launched, and hashing/writing
         happen inline between cases.
  async  bucket steps are launched without waiting on the device (CUDA
         launches queue on the stream), the score table stays on the
         device across buckets (gathered and updated there, never in
         place: a case's table is what its checkpoint saves while the
         next case is launched), bucket N+1's panel is assembled on the
         host while bucket N computes, and a drain worker thread copies
         completed steps out, hashes outputs and writes results while
         the main thread launches the next case. Every device operation,
         the drain's copies included, runs on the one current stream.

Determinism contract (the -s replay guarantee): every schedule draw is
keyed on (seed, case, TAG_SCHED), device keys on (seed, case, slot), and
energies evolve only from deterministic inputs applied at case
boundaries — so at a fixed seed, two runs produce byte-identical
schedules and outputs, and sync/async produce byte-identical streams
(the pipeline moves WHEN work happens, never WHAT is computed: hash
events apply in the same bucket-dispatch + slot order, and the drain
worker signals "events applied" before the next schedule draws).
The files equal the JAX package's at the same seed and ERLAMSA_PALLAS
stream, and the store and --state file are the JAX package's formats:
either package resumes the other's run. The port's state file adds the
seen output hashes (services/checkpoint.save_state), which the JAX
package's loader ignores.

Device-loss degradation: a device error anywhere in the pipeline — a
CUDA runtime failure, device memory exhausted, or an injected
``device.step`` fault (services/chaos.py); ops/pipeline.is_device_error —
flips the runner into a flagged DEGRADED mode: in-flight futures are
abandoned, un-finished cases are re-served by the host oracle engine
(deterministic per (seed, case, slot), though not byte-identical to the
device stream), and every DEVICE_PROBE_EVERY cases the runner probes the
device; a successful probe resumes the device pipeline. The transition
is visible as metrics events (device_lost / device_recovered) and the
``degraded`` flag in metrics snapshots. Any other error, a kernel that
fails to build among them, fails the run. A run that ends still degraded
returns EXIT_DEGRADED, not 0 (the JAX package returns 0): a CUDA error
raised by a faulty kernel of the port's own is sticky, fails every
probe, and would otherwise pass for a lost device.

Coverage feedback (--coverage): when a CoverageHub (services/
monitors.py) is wired in through opts["coverage_hub"], the runner takes
the case's buffered edge bitmaps off the hub at the case boundary, and
folds them through corpus/distill.CoverageIndex (ops/coverage.py torch
functions on the run's device, numpy oracles while degraded). A slot
with a map admits (energy + --adopt) only on genuinely-new edges
(``new_cov`` events) instead of output-hash novelty; slots without a map
keep the hash-novelty stand-in. The fold runs on the runner's or the
drain thread, never on a hub thread, so a fixed -s stays byte-identical.
A dead monitor plane degrades STICKILY to hash-novelty (coverage_lost
event, coverage-degraded flag): flickering coverage would make adoption
depend on reconnect timing. A degraded or coverage-off run is
byte-identical to the hash-novelty baseline. --distill retires, at the
end of the run, every seed whose edges the kept set covers
(corpus/distill.greedy_minimize).

Grammar seeding (--gen, opts["gen"]): before the first case the store
takes the samples of ONE batched grammar expansion (gen/engine.py
GenEngine on the run's device, origin "gen"), and stats["gen"] counts
them; an injected gen.expand fault or a lost device expands on the
keyed host twin instead, byte-identically.

Not ported yet: the corpus fleet (shards, fleet_nodes, spmd); each
raises a ValueError naming it.
"""

from __future__ import annotations

import hashlib
import queue
import sys
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..obs import trace
from ..services import chaos, logger, metrics, out
from . import feedback as fb
from .assembler import Bucket, bucket_capacity, materialize, plan_buckets
from .energy import EnergyScheduler
from .store import CorpusStore

PIPELINES = ("sync", "async")

# corpus memory layouts (--layout): buckets re-assembles and re-uploads
# pow2-padded panels per case; arena keeps seed bytes device-resident in
# fixed-size pages (corpus/arena.py) and addresses each case through a
# page table — ~zero padded waste, seeds cross to the device once
LAYOUTS = ("buckets", "arena")

# degraded mode probes the device for recovery every N cases
DEVICE_PROBE_EVERY = 4

# --adopt admits at most this many novel outputs per case
ADOPT_CAP = 64

# exit code of a run that ended in degraded mode: every file was written
# (the tail by the host oracle), but the device never came back, which
# is also what a fault in one of the port's own kernels looks like
EXIT_DEGRADED = 3

# options of the reference runner this port does not run yet
_NOT_PORTED = (("shards", "--shards (the corpus fleet)"),
               ("fleet_nodes", "--fleet-nodes (the corpus fleet)"),
               ("spmd", "--spmd (the corpus fleet)"))


def _out_hash(data: bytes) -> bytes:
    return hashlib.sha1(data).digest()[:12]


class _DrainWorker:
    """Orders completed cases behind the device: one thread consuming
    submitted cases FIFO, so hashing/writing of case N overlaps the main
    thread's schedule/assemble/dispatch of case N+1.

    The first exception raised by the process callback is captured and
    re-raised in the MAIN thread (from wait_done/close) — a dead drain
    must fail the run, not silently stop consuming."""

    def __init__(self, process, start_case: int, discard=None):
        self._process = process
        self._discard = discard  # best-effort cleanup for abandoned items
        self._q: queue.Queue = queue.Queue()
        self._cv = threading.Condition()
        self._done_case = start_case - 1
        self._abandoned = False
        self.error: BaseException | None = None
        self._t = threading.Thread(target=self._run, name="corpus-drain",
                                   daemon=True)
        self._t.start()

    @property
    def done_case(self) -> int:
        """Highest case whose events/writes have fully landed."""
        with self._cv:
            return self._done_case

    def submit(self, item):
        metrics.GLOBAL.record_drain_backlog(self._q.qsize() + 1)
        self._q.put(item)

    def mark_done(self, case: int):
        """Called by the process callback once the case's energy events
        are applied — the point after which the next schedule may draw."""
        with self._cv:
            self._done_case = case
            self._cv.notify_all()

    def wait_done(self, case: int):
        """Block until `case`'s events are applied (or the worker died)."""
        with self._cv:
            while (self._done_case < case and self.error is None
                   and not self._abandoned):
                self._cv.wait()
        if self.error is not None:
            raise self.error

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._abandoned:
                # flush the queue: its futures are poisoned, but settle
                # them best-effort so no device work trails the fallback
                if self._discard is not None:
                    self._discard(item)
                continue
            try:
                self._process(item)
            except BaseException as e:  # lint: broad-except-ok surfaced to main via _cv
                with self._cv:
                    self.error = e
                    self._cv.notify_all()
                return

    def abandon(self):
        """Detach on device loss: stop at the next queue item, swallow the
        (already-diagnosed) error, wake any waiter. The un-processed
        cases are the caller's to re-serve (done_case marks the last one
        whose effects landed)."""
        with self._cv:
            self._abandoned = True
            self._cv.notify_all()
        self._q.put(None)

    def close(self, join: bool = True):
        self._q.put(None)
        if join:
            self._t.join()
        if self.error is not None:
            raise self.error


def run_corpus_batch(opts: dict, batch: int = 1024, device=None,
                     level=None) -> int:
    """The --corpus DIR --feedback entry point. Runs on ``cuda`` unless
    ``device`` says otherwise; ``level`` picks the stream
    (ops/fused.pallas_level; None reads ERLAMSA_PALLAS). opts are the
    reference runner's: corpus_dir, seed, n, paths / recursive or corpus
    (seeds handed over in-process), mutations, output, pipeline, layout,
    arena_pages, arena_page, arena_classes, adopt, struct,
    feedback, feedback_bus, coverage, coverage_hub, distill, gen (a dict:
    grammar or compiled, label, n, fuzz), state_path, checkpoint_every,
    device_capacity_max, and _stats, a dict the run fills with its
    counts. Returns the process exit code."""
    from ..constants import CAPACITY_CLASSES
    from ..ops import prng
    from ..ops.buffers import scan_bound
    from ..ops.pipeline import (drain_futures, is_device_error,
                                make_class_fuzzer, step_async)
    from ..ops.registry import DEVICE_CODES, NUM_DEVICE_MUTATORS
    from ..ops.scheduler import init_scores
    from ..oracle.mutations import default_mutations
    from ..services.checkpoint import (load_corpus_energies,
                                       load_coverage_maps, load_seen_hashes,
                                       load_state, quarantine_mismatch,
                                       save_state)

    for key, what in _NOT_PORTED:
        if opts.get(key):
            raise ValueError(f"{what} is not yet ported to "
                             "erlamsa_tpu_torch")
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"

    pipeline = str(opts.get("pipeline") or "async")
    if pipeline not in PIPELINES:
        raise ValueError(f"pipeline must be one of {PIPELINES}, "
                         f"got {pipeline!r}")
    use_async = pipeline == "async"
    layout = str(opts.get("layout") or "buckets")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, "
                         f"got {layout!r}")
    use_arena = layout == "arena"
    # --adopt: novel outputs join the corpus as first-class seeds (capped
    # per case). The DECISION is layout-independent — first never-seen
    # hash wins, in slot order — so buckets and arena grow identical
    # stores at a fixed -s; the arena layout additionally adopts the
    # bytes device-side (DeviceArena.adopt_pending) so only hashes and
    # lengths cross to the host for adopted offspring.
    adopt_on = bool(opts.get("adopt"))

    store = CorpusStore(opts["corpus_dir"])
    # recovery fsck: a previous crash can leave corpus.json and seeds/
    # disagreeing (entries without files, orphaned/corrupt files) — heal
    # the store before the scheduler indexes into it
    fsck = store.fsck()
    if fsck["missing"] or fsck["corrupt"] or fsck["orphans"]:
        print(f"# corpus fsck: {fsck['ok']} ok, {fsck['missing']} missing, "
              f"{fsck['corrupt']} corrupt, {fsck['orphans']} orphaned",
              file=sys.stderr)
    direct = opts.get("corpus")
    if direct is not None:
        # in-process callers (chip_smoke, tests) hand seeds over directly
        # instead of staging files
        for s in direct:
            store.add(s, origin="direct")
    else:
        paths = opts.get("paths") or []
        paths = [p for p in paths if p != "-"]
        if paths:
            from ..oracle.gen import _expand_paths

            expanded = (_expand_paths(paths) if opts.get("recursive")
                        else paths)
            new, dup, skipped = store.add_paths(expanded)
            print(f"# corpus: {new} new, {dup} duplicate, "
                  f"{skipped} skipped -> {len(store)} seeds in store",
                  file=sys.stderr)
    gen_opts = opts.get("gen")
    gen_engine = None
    if gen_opts:
        # generate-then-mutate: seed the campaign from ONE batched
        # expansion of the compiled grammar on the run's device.
        # Generated rows enter the store like any other seed and the
        # gather→mutate→score loop takes over — zero per-case host
        # expansion on the hot path. Device loss (or an injected
        # gen.expand fault) degrades the expansion to the keyed host
        # twin per (case, slot), byte-identically, so the campaign is
        # the same either way.
        from ..gen import GenEngine, compile_grammar

        cg = gen_opts.get("compiled")
        if cg is None:
            cg = compile_grammar(gen_opts["grammar"],
                                 source=gen_opts.get("label", "--gen"))
        gen_engine = GenEngine(cg, opts["seed"],
                               fuzz=bool(gen_opts.get("fuzz")), device=dev)
        gen_n = int(gen_opts.get("n") or 64)
        payloads, gen_trunc = gen_engine.expand(case_idx=0, n=gen_n)
        # the store's index saved once for the panel, not once a seed
        gen_added = sum(fresh for _sid, fresh in store.add_many(
            [p for p in payloads if p], origin="gen"))
        print(f"# gen: {len(payloads)} samples from grammar "
              f"{cg.source} -> {gen_added} new seeds"
              f" ({gen_trunc} truncated)"
              f"{', host-degraded' if gen_engine.degraded else ''}",
              file=sys.stderr)
    if len(store) == 0:
        print("no corpus (store empty and no readable seeds)",
              file=sys.stderr)
        return 1

    selected = dict(opts.get("mutations") or default_mutations())
    pri = [max(selected.get(code, 0), 0) for code in DEVICE_CODES]
    if not any(pri):
        print("none of the selected mutations runs on the device; "
              f"device set: {','.join(DEVICE_CODES)}", file=sys.stderr)
        return 1

    device_max = int(opts.get("device_capacity_max", CAPACITY_CLASSES[-1]))
    sched = EnergyScheduler(store, opts["seed"])
    step = make_class_fuzzer(mutator_pri=pri, device=dev, level=level)
    base = prng.base_key(tuple(opts["seed"]), device=dev)
    scores = init_scores(prng.fold_in(base, 999), batch)
    bus = opts.get("feedback_bus", fb.GLOBAL)
    consume_feedback = bool(opts.get("feedback"))

    # the coverage plane: the hub buffers connect-back edge bitmaps off
    # the wire; the runner folds them at case boundaries (never from
    # monitor threads: the determinism contract) and gates per-slot
    # adoption/energy on genuinely-new edges. The ledger maps (case,
    # slot) back to the scheduled seed for the fold and for any monitor
    # that can name the sample that provoked a signal.
    hub = opts.get("coverage_hub")
    coverage_on = bool(opts.get("coverage")) and hub is not None
    distill_on = bool(opts.get("distill"))
    ledger = fb.SampleLedger()
    cov = None
    cov_live = False
    if coverage_on:
        from .distill import CoverageIndex

        cov = CoverageIndex(map_bytes=hub.map_bytes, use_device=True,
                            device=dev)
        cov_live = True

    arena = None
    trunc_cap = device_max  # truncation threshold (both layouts)

    def _seed_arena(tick):
        """Upload every stored seed once — after this, scheduling a seed
        costs a page-table row, not a host-to-device copy."""
        with trace.span("corpus.arena.seed", seeds=len(store), tick=tick):
            for sid in store.ids():
                arena.ensure(sid, store.get(sid), tick)
            arena.flush()

    if use_arena:
        from ..ops import paged
        from .arena import (RESERVED_PAGES, DeviceArena, fit_page_classes,
                            resolve_classes)

        # RAGGED rows over one physical page size: a small ascending set
        # of capacity classes, each with its own page table and step
        # shape (--arena-classes; "auto" derives the exact bucket
        # capacities of the stored seeds). The fused engine's streams
        # are a function of the row width, so arena==buckets
        # byte-identity holds exactly when every seed's class equals its
        # bucket capacity — the auto configuration.
        sizes = [len(store.get(sid)) for sid in store.ids()]
        if not sizes:
            print("no corpus seeds to page into the arena",
                  file=sys.stderr)
            return 1
        classes = resolve_classes(opts.get("arena_classes"), sizes,
                                  device_max)
        trunc_cap = classes[-1]
        page_opt = int(opts.get("arena_page") or paged.PAGE)
        # the page must divide every class width exactly — otherwise a
        # class's rows come up narrower than its capacity (shape
        # mismatch on any spill overlay)
        page = fit_page_classes(page_opt, classes)
        if page != page_opt:
            print(f"# arena: page size {page_opt} does not fit the "
                  f"capacity classes {classes}, using {page}",
                  file=sys.stderr)
        # max(1, ...) matches PageAllocator.pages_for: a zero-length
        # seed still occupies one page
        need = sum(max(1, -(-min(n, trunc_cap) // page)) for n in sizes)
        num_pages = int(opts.get("arena_pages")
                        or RESERVED_PAGES + max(64, 2 * need))
        num_pages = max(num_pages, RESERVED_PAGES + classes[0] // page)
        # class routing mirrors the bucket assembler's slack exactly: a
        # seed WANTS its bucket capacity and lands in the smallest class
        # that satisfies it (longer routes UP, never silently down)
        arena = DeviceArena(
            num_pages, page=page, classes=classes,
            classify=lambda n: bucket_capacity(n, device_max=device_max),
            device=dev,
        )
        _seed_arena(tick=-1)
        # store-admission hook: seeds added mid-run (faas/monitors,
        # adopted offspring) queue here and upload at the next case
        # boundary — unless device-side adoption already landed them
        store.listener = arena.enqueue

    n_cases = opts.get("n", 1)
    start_case = 0
    seen_hashes: set[bytes] = set()
    ckpt_every = max(1, int(opts.get("checkpoint_every", 1)))
    state_path = opts.get("state_path")
    if state_path:
        import os as _os

        if _os.path.exists(state_path):
            st = load_state(state_path, level=level)
            if st is None:
                print("# checkpoint unreadable, starting fresh",
                      file=sys.stderr)
            else:
                ck_seed, ck_case, ck_scores, _hs, _hsp = st
                cov_verdict, cov_snap = "absent", None
                if cov is not None:
                    # kind-stamped coverage fields: "absent" (a checkpoint
                    # without coverage) resumes with fresh empty coverage,
                    # "mismatch" (wrong kind/version/width) means the file
                    # belongs to a different configuration
                    cov_verdict, cov_snap = load_coverage_maps(
                        state_path, cov.map_bytes)
                if (ck_seed != tuple(opts["seed"])
                        or ck_scores.shape != (batch, NUM_DEVICE_MUTATORS)
                        or cov_verdict == "mismatch"):
                    # the mismatched file belongs to a DIFFERENT run:
                    # park it at .bak so that run can still resume from
                    # it, instead of burying it under this run's first
                    # save
                    quarantine_mismatch(state_path)
                    print("# checkpoint mismatch (seed/shape/coverage), "
                          "starting fresh (original kept as .bak)",
                          file=sys.stderr)
                else:
                    start_case = ck_case
                    scores = torch.as_tensor(ck_scores, dtype=torch.int32,
                                             device=dev)
                    energies = load_corpus_energies(state_path, level=level)
                    if energies:
                        store.restore_energies(energies)
                    # the novelty state: without it an output hash seen
                    # before the stop counts as new again, and the
                    # energies (so the schedules) part from the
                    # uninterrupted run's
                    seen_hashes |= load_seen_hashes(state_path,
                                                    level=level) or set()
                    if cov_snap is not None:
                        cov.restore(cov_snap)
                    print(f"# resumed at case {start_case} "
                          f"({len(energies or {})} seed energies restored)",
                          file=sys.stderr)
        if start_case >= n_cases:
            print(f"# run already complete ({start_case}/{n_cases} cases)",
                  file=sys.stderr)
            return 0

    # struct engine (--struct): the span-splice mutators as a routed
    # per-case overlay. A one-pass tokenizer runs at store ADMISSION
    # (seeds now, offspring when store.add fires the chained listener
    # below), the StructRouter picks a deterministic routed subset per
    # case (neutral device mass: the live score table stays on the
    # device), and the routed rows ride one extra struct step ('device')
    # or the numpy span-oracle ('host', the parity path). Routing is a
    # pure function of (seed, case, scheduled samples) and overlay order
    # is slot order, so sync and async write the same bytes.
    struct_mode = str(opts.get("struct") or "off")
    if struct_mode not in ("off", "host", "device"):
        raise ValueError(f"struct must be one of off/host/device, "
                         f"got {struct_mode!r}")
    struct_router = None
    span_cache = None
    from ..ops import registry as _registry
    from ..ops import structure as stm
    from ..ops.tree_mutators import struct_step

    host_base = prng.base_key(tuple(opts["seed"]))  # --struct host: CPU
    _struct_flag_before = _registry.struct_kernels_enabled()
    if struct_mode != "off":
        _registry.set_struct_kernels(True)
        span_cache = stm.SpanCache()
        struct_router = stm.StructRouter(opts["seed"], selected)
        # chain the admission listener (after the arena installed its
        # own): every seed that enters the store — initial corpus,
        # monitors, adopted offspring — gets its span table the moment
        # its bytes are known
        _prev_listener = store.listener

        def _struct_admit(sid, _prev=_prev_listener):
            span_cache.note(sid, store.get(sid))
            if _prev is not None:
                _prev(sid)

        store.listener = _struct_admit
        for sid in store.ids():
            span_cache.note(sid, store.get(sid))

    writer, _mt = out.string_outputs(opts.get("output", "-"))
    stats = opts.get("_stats")  # caller-owned dict for measured numbers
    bucket_stats: dict[int, dict] = {}
    # tallies the drain worker owns in async mode (main reads after join)
    tallies = {"truncated": 0, "total": 0, "new_hashes": 0,
               "bytes_uploaded": 0, "offspring": 0, "struct_routed": 0,
               "cov_maps": 0, "cov_new_edges": 0}
    # distinct (rows, capacity, scan_len) triples the step saw — the
    # compiled-program count of the JAX package, which the arena drives
    # to one per class
    step_shapes: set[tuple] = set()

    # sync mode keeps the score table on the host. One conversion for
    # the whole run — per bucket only that bucket's ROWS are gathered and
    # scattered, never the full [batch, M] table.
    if not use_async:
        scores = scores.cpu().numpy().copy()

    def _to_dev(a):
        return torch.as_tensor(a, device=dev)

    def _gather_scores(scores_in, gather):
        """The score rows of one bucket (a new tensor on the device)."""
        if use_async:
            return torch.index_select(scores_in, 0,
                                      _to_dev(gather.astype(np.int64)))
        return _to_dev(scores_in[gather])

    def _scatter_scores(scores_out, rows, fut, k):
        """The table with ``rows`` set to the step's first k score rows:
        on the device a NEW tensor (the previous case's table stays what
        its checkpoint saves), on the host in place (sync mode finishes
        each case before the next is launched)."""
        if use_async:
            return scores_out.index_put(
                (_to_dev(np.asarray(rows, np.int64)),), fut.scores[:k])
        scores_out[rows] = fut.scores[:k].cpu().numpy()
        return scores_out

    def _dispatch_arena(case, ids, samples, scores_in):
        """Arena layout's dispatch: adopt queued offspring and admit
        queued seeds, then build one page table PER CAPACITY CLASS and
        run one ragged step per class — each gather reads only its rows'
        live pages, no padding to the widest resident seed, no per-case
        seed re-upload. Spilled rows (arena full / injected arena.spill
        fault) are overlaid from host bytes, which costs an upload but
        never changes output bytes. Slot keying, row padding, score
        gather/scatter and scan bounds mirror the bucket path row for
        row, so arena==buckets byte-identity holds whenever class caps
        equal bucket caps."""
        t_a = time.perf_counter()
        with trace.span("corpus.assemble", case=case):
            if adopt_on:
                arena.adopt_pending(tick=case)
            arena.drain_pending(store.get, tick=case)
            arena.maybe_defrag()
            groups = arena.tables_for(ids, samples, tick=case)
        t_d = time.perf_counter()
        launched = []
        scores_out = scores_in
        dispatch_s = 0.0
        try:
            for g in groups:
                t_g = time.perf_counter()
                chaos.fault_point("device.step")
                k = int(g.rows.shape[0])
                kp = max(8, 1 << (k - 1).bit_length())
                # cyclic row padding, exactly like materialize(): pad
                # rows repeat real rows (shape-valid, outputs discarded)
                pad = np.arange(kp, dtype=np.int32) % k
                table_p = g.table[pad]
                lens_p = g.lens[pad]
                data = arena.gather(table_p)
                if g.spilled:
                    # pow2-padded overlay rows; padding repeats the first
                    # spilled row — the same bytes land twice
                    ks = len(g.spilled)
                    ksp = max(8, 1 << (ks - 1).bit_length())
                    rows_idx = np.asarray(
                        (g.spilled + [g.spilled[0]] * (ksp - ks))[:ksp],
                        np.int32)
                    panel = np.zeros((ksp, g.capacity), np.uint8)
                    for j, r in enumerate(g.spilled):
                        s = samples[int(g.rows[r])][:g.capacity]
                        panel[j, :len(s)] = np.frombuffer(s, np.uint8)
                    panel[ks:] = panel[0]
                    data[_to_dev(rows_idx.astype(np.int64))] = _to_dev(panel)
                    tallies["bytes_uploaded"] += (panel.nbytes
                                                  + rows_idx.nbytes)
                # keys derive from the SLOT position (0..batch-1), pad
                # rows get out-of-range indices — identical to the
                # bucket path's contract
                idx = np.concatenate([
                    g.rows, batch + np.arange(kp - k, dtype=np.int32)
                ]).astype(np.int32)
                sc_in = _gather_scores(scores_out, g.rows[pad])
                sl = scan_bound(int(g.lens.max()), g.capacity)
                tallies["bytes_uploaded"] += (table_p.nbytes
                                              + lens_p.nbytes + idx.nbytes)
                step_shapes.add((kp, g.capacity, sl))
                with trace.span("corpus.dispatch", case=case,
                                capacity=g.capacity, rows=k):
                    fut = step_async(step, base, case, idx, data,
                                     _to_dev(lens_p), sc_in, scan_len=sl)
                scores_out = _scatter_scores(scores_out, g.rows, fut, k)
                # shape-only placeholder panel: process_case never reads
                # bucket data (outputs come from the future)
                b = Bucket(capacity=g.capacity, slots=g.rows,
                           data=np.zeros((k, 0), np.uint8), lens=g.lens,
                           rows=k, padded_bytes_wasted=0)
                launched.append((b, fut))
                dispatch_s += time.perf_counter() - t_g
        except BaseException:  # lint: broad-except-ok re-raised after settling in-flight futures
            # a fault on class K's dispatch must not strand the earlier
            # classes' in-flight futures (mirrors the bucket path)
            drain_futures(fut for _b, fut in launched)
            raise
        metrics.GLOBAL.record_stage("assemble", t_d - t_a)
        metrics.GLOBAL.record_stage("dispatch", dispatch_s)
        return ids, launched, scores_out, dispatch_s

    def _dispatch_struct(case, ids, samples):
        """Route and launch this case's struct overlay: returns
        ([(slot, code_idx)], work) where work is the launched device
        (out, lens, applied) triple ('device') or an already-computed
        {slot: bytes} dict ('host'). Oversized samples (> trunc_cap)
        never struct-route — the bucket path truncates them and the span
        table describes the UNtruncated bytes."""
        if struct_router is None:
            return [], None
        struct_router.prepare(samples, span_cache, keys=ids)
        excl = np.asarray([len(s) > trunc_cap for s in samples], bool)
        codes = struct_router.route(case, excluded=excl)
        routed = [(slot, int(c)) for slot, c in enumerate(codes) if c >= 0]
        if not routed:
            return [], None
        tallies["struct_routed"] += len(routed)
        caps = np.asarray(
            [bucket_capacity(len(samples[slot]), device_max=trunc_cap)
             for slot, _ in routed], np.int32)
        if struct_mode == "host":
            res = {}
            for (slot, ci), cap in zip(routed, caps):
                nd, cnt = span_cache.get(ids[slot], samples[slot])
                key = stm.struct_sample_key(host_base, case, slot)
                res[slot] = stm.host_struct_fuzz(key, samples[slot], nd,
                                                 int(cnt), ci, int(cap))
            return routed, res
        # pow2-padded panel of just the routed rows (the scheduled set
        # changes every case, so the routed BYTES ride along); pad rows
        # carry code -1
        k = len(routed)
        kp = max(8, 1 << (k - 1).bit_length())
        width = int(caps.max())
        panel = np.zeros((kp, width), np.uint8)
        lens = np.zeros(kp, np.int32)
        nds = np.zeros((kp, stm.SPAN_NODES, 4), np.int32)
        cnts = np.zeros(kp, np.int32)
        caps_p = np.full(kp, width, np.int32)
        caps_p[:k] = caps
        slots_arr = np.concatenate([
            np.asarray([slot for slot, _ in routed], np.int32),
            batch + np.arange(kp - k, dtype=np.int32),
        ])
        cds = np.concatenate([
            np.asarray([c for _, c in routed], np.int32),
            np.full(kp - k, -1, np.int32),
        ])
        for p, (slot, _c) in enumerate(routed):
            raw = samples[slot]
            panel[p, :len(raw)] = np.frombuffer(raw, np.uint8)
            lens[p] = len(raw)
            nds[p], cnts[p] = span_cache.get(ids[slot], raw)
        # the reference's count of the struct engine's upload (the port
        # sends slots and codes of the live rows as one int64 table)
        tallies["bytes_uploaded"] += (panel.nbytes + lens.nbytes
                                      + nds.nbytes + cnts.nbytes
                                      + caps_p.nbytes + slots_arr.nbytes
                                      + cds.nbytes)
        with trace.span("corpus.struct_dispatch", case=case, rows=k):
            work = struct_step(base, case, slots_arr, _to_dev(panel),
                               _to_dev(lens), _to_dev(nds), _to_dev(cnts),
                               _to_dev(caps_p), cds)
        return routed, work

    def dispatch_case(case, scores_in):
        """Schedule, assemble and launch every bucket of one case.

        async: steps are launched without waiting on their results, scores
        gather/scatter on the device, and each bucket's panel is
        materialized while the previous bucket's step runs. sync: each
        bucket's scores come back to the host before the next is launched
        — the serialized baseline. Returns (ids, launched, scores_out,
        dispatch_s, struct_rows, struct_work)."""
        t_s = time.perf_counter()
        with trace.span("corpus.schedule", case=case):
            ids = sched.schedule(case, batch)
            # attribution ledger BEFORE launch: monitors and the
            # coverage fold resolve (case, slot) -> seed through it
            ledger.record(case, ids)
            samples = [store.get(sid) for sid in ids]
            plans = (None if use_arena
                     else plan_buckets(samples, device_max=device_max))
        metrics.GLOBAL.record_stage("schedule", time.perf_counter() - t_s)
        trunc = sum(len(s) > trunc_cap for s in samples)
        if trunc:
            tallies["truncated"] += trunc
            metrics.GLOBAL.record_truncated(trunc)
        # struct overlay is launched FIRST so its device work overlaps the
        # bucket/arena assembly below
        struct_rows, struct_work = _dispatch_struct(case, ids, samples)
        if use_arena:
            ids, launched, scores_out, dispatch_s = _dispatch_arena(
                case, ids, samples, scores_in)
            return (ids, launched, scores_out, dispatch_s, struct_rows,
                    struct_work)

        launched = []
        scores_out = scores_in
        assemble_s = dispatch_s = 0.0
        try:
            for plan in plans:
                t_a = time.perf_counter()
                with trace.span("corpus.assemble", case=case,
                                capacity=plan.capacity):
                    b = materialize(plan, samples)
                t_d = time.perf_counter()
                chaos.fault_point("device.step")
                # keys derive from the SLOT position (0..batch-1) so a
                # sample's stream is a pure function of (seed, case, slot)
                # no matter how the buckets partition the batch; pad rows get
                # out-of-range indices — their outputs are discarded
                idx = np.concatenate([
                    b.slots, batch + np.arange(b.pad_rows, dtype=np.int32)
                ]).astype(np.int32)
                gather = b.slots[np.arange(b.rows_padded) % b.rows]
                sc_in = _gather_scores(scores_out, gather)
                sl = scan_bound(int(b.lens[:b.rows].max()), b.capacity)
                tallies["bytes_uploaded"] += (b.data.nbytes + b.lens.nbytes
                                              + idx.nbytes)
                step_shapes.add((b.rows_padded, b.capacity, sl))
                with trace.span("corpus.dispatch", case=case,
                                capacity=b.capacity, rows=b.rows):
                    fut = step_async(step, base, case, idx,
                                     _to_dev(b.data), _to_dev(b.lens),
                                     sc_in, scan_len=sl)
                scores_out = _scatter_scores(scores_out, b.slots, fut,
                                             b.rows)
                launched.append((b, fut))
                t_e = time.perf_counter()
                assemble_s += t_d - t_a
                dispatch_s += t_e - t_d
        except BaseException:  # lint: broad-except-ok re-raised after settling in-flight futures
            # a fault on bucket K's dispatch must not strand buckets
            # 1..K-1's in-flight futures: settle them before the
            # device-loss path (or the caller) touches device state
            drain_futures(fut for _b, fut in launched)
            raise
        metrics.GLOBAL.record_stage("assemble", assemble_s)
        metrics.GLOBAL.record_stage("dispatch", dispatch_s)
        return ids, launched, scores_out, dispatch_s, struct_rows, struct_work

    class _CaseWork:
        __slots__ = ("case", "ids", "launched", "scores", "dispatch_s",
                     "struct_rows", "struct_work")

        def __init__(self, case, ids, launched, scores, dispatch_s,
                     struct_rows=(), struct_work=None):
            self.case = case
            self.ids = ids
            self.launched = launched
            self.scores = scores
            self.dispatch_s = dispatch_s
            self.struct_rows = struct_rows
            self.struct_work = struct_work

    drain: _DrainWorker | None = None

    def _host_scores(sc):
        return sc.cpu().numpy() if torch.is_tensor(sc) else np.asarray(sc)

    def finish_case(case, ids, results, ckpt_scores, device_seconds,
                    devsrc=None):
        """The order-dependent tail every case runs — hashing (slot walk
        0..batch-1, identical in sync/async/degraded), offspring
        adoption, energy events, bus drain, writes and checkpointing —
        shared by the device drain path and the degraded oracle path.

        `devsrc` maps slot -> (device output tensor, row) when the
        outputs are still on the device (arena layout): an adopted
        offspring then queues for DeviceArena.adopt_pending and its
        payload bytes are never uploaded again."""
        nonlocal cov_live
        # coverage pre-pass: pull this case's buffered bitmaps off the
        # hub and fold them (runner/drain thread, case boundary). Hub
        # death is STICKY — once lost, the rest of the run is pure
        # hash-novelty, so adoption never depends on reconnect timing.
        slot_gain: dict[int, int] = {}
        if cov is not None and cov_live:
            if not hub.alive():
                cov_live = False
                logger.log("warning", "corpus: coverage hub lost at case "
                           "%d — degrading to hash-novelty", case)
                metrics.GLOBAL.record_event("coverage_lost")
                metrics.GLOBAL.set_coverage_degraded(True)
            else:
                frames = hub.take(case)
                covered = [s for s in sorted(frames) if s < batch]
                pairs = [(ledger.resolve(case, s) or ids[s], frames[s])
                         for s in covered]
                t_f = time.perf_counter()
                try:
                    with trace.span("coverage.fold", case=case,
                                    maps=len(pairs)):
                        gains = cov.fold_case(pairs)
                except OSError as e:
                    # injected coverage.fold fault: the whole case is
                    # treated as uncovered — observable, never diverging
                    # from the hash-novelty baseline
                    logger.log("warning", "corpus: coverage fold failed "
                               "at case %d (%s) — case uncovered", case, e)
                    metrics.GLOBAL.record_coverage_frame("faulted")
                else:
                    if covered:
                        slot_gain = dict(zip(covered, gains))
                        new_edges = int(sum(gains))
                        metrics.GLOBAL.record_coverage_fold(
                            len(pairs), new_edges, cov.edges())
                        tallies["cov_maps"] += len(pairs)
                        tallies["cov_new_edges"] += new_edges
                finally:
                    metrics.GLOBAL.record_stage(
                        "coverage", time.perf_counter() - t_f)

        # novelty feedback: a slot WITH a coverage map admits on
        # genuinely-new edges (new_cov energy); a slot without one keeps
        # the hash-novelty stand-in byte for byte. seen_hashes is still
        # recorded for covered slots so a later degradation cannot
        # re-count their outputs as novel.
        t_h = time.perf_counter()
        case_bytes = 0
        case_adopted = 0
        with trace.span("corpus.hash", case=case):
            for slot in range(batch):
                payload = results.get(slot, b"")
                case_bytes += len(payload)
                h = _out_hash(payload)
                novel_hash = h not in seen_hashes
                if novel_hash:
                    seen_hashes.add(h)
                    tallies["new_hashes"] += 1
                if slot in slot_gain:
                    admit = slot_gain[slot] > 0
                    if admit:
                        store.apply_event(fb.Event("new_cov", ids[slot]))
                else:
                    admit = novel_hash
                    if admit:
                        store.apply_event(fb.Event("new_hash", ids[slot]))
                if admit and adopt_on and payload \
                        and case_adopted < ADOPT_CAP:
                    # the store decides (dedup by content hash);
                    # store.add fires the arena's listener, and the
                    # device path below turns that host upload into
                    # a no-op when the scatter wins
                    sid_new, added = store.add(payload,
                                               origin="offspring")
                    if added:
                        case_adopted += 1
                        tallies["offspring"] += 1
                        if devsrc is not None and slot in devsrc:
                            src, row = devsrc[slot]
                            arena.enqueue_adopt(sid_new, len(payload),
                                                src, row)
        tallies["total"] += len(results)
        metrics.GLOBAL.record_stage("hash", time.perf_counter() - t_h)
        metrics.GLOBAL.record_batch(len(results), case_bytes,
                                    device_seconds)
        metrics.GLOBAL.record_routed_total(len(results))

        # external feedback (monitors/proxy/faas) folds in at the case
        # boundary; anonymous events credit this case's seeds
        if consume_feedback:
            credit = sorted(set(ids))
            for ev in bus.drain():
                store.apply_event(ev, credit=credit)
                logger.log("decision", "corpus: %s event from %s -> "
                           "energy feedback", ev.kind, ev.source or "?")

        ckpt = state_path and ((case + 1 - start_case) % ckpt_every == 0
                               or case + 1 == n_cases)
        if not ckpt and drain is not None:
            # energies are final for this case and no checkpoint pins
            # this case's store state: unblock the next schedule NOW so
            # writes below overlap the next case's dispatch
            drain.mark_done(case)

        t_o = time.perf_counter()
        with trace.span("corpus.write", case=case):
            for slot in range(batch):
                payload = results.get(slot, b"")
                if writer is not None:
                    writer(case * batch + slot, payload, [])
                else:
                    sys.stdout.buffer.write(payload)
        metrics.GLOBAL.record_stage("write", time.perf_counter() - t_o)
        if stats is not None:
            stats.setdefault("finish_times", []).append(time.perf_counter())
        if ckpt:
            # writes land BEFORE the checkpoint marks the case done (a
            # resumed run must not skip a case whose outputs never hit
            # disk), and the checkpoint lands before the next schedule
            # records its hits (else resume would double-count them)
            save_state(state_path, opts["seed"], case + 1,
                       _host_scores(ckpt_scores),
                       corpus_energies=store.energies(), level=level,
                       seen_hashes=seen_hashes,
                       coverage=(cov.snapshot()
                                 if cov is not None else None))
            store.save()
            if drain is not None:
                drain.mark_done(case)

    def process_case(work: _CaseWork):
        """Copy one case's steps to the host, then finish_case's
        order-dependent tail (bucket dispatch order is fixed — identical
        in sync and async). Runs inline in sync mode, on the drain worker
        in async mode."""
        case, ids, launched = work.case, work.ids, work.launched
        results: dict[int, bytes] = {}
        # slot -> (device output tensor, row): the adoption source map.
        # Holding the output here keeps it alive until the next case's
        # adopt_pending() scatter.
        devsrc: dict[int, tuple] | None = (
            {} if (adopt_on and use_arena) else None)
        t_w = time.perf_counter()
        for b, fut in launched:
            with trace.span("corpus.drain", case=case, capacity=b.capacity):
                new_data, new_lens, _new_sc, meta = fut.result()
            for j, slot in enumerate(b.slots):
                results[int(slot)] = new_data[j, :new_lens[j]].tobytes()
                if devsrc is not None:
                    devsrc[int(slot)] = (fut.data, j)
            # per-mutator applied counters (registry rows, device side)
            applied = meta.applied[:b.rows].ravel()
            applied = applied[applied >= 0]
            if applied.size:
                counts = np.bincount(applied, minlength=len(DEVICE_CODES))
                for mi in np.nonzero(counts)[0]:
                    metrics.GLOBAL.record_mutator(
                        DEVICE_CODES[mi], applied=True, n=int(counts[mi])
                    )
            bs = bucket_stats.setdefault(
                b.capacity,
                {"batches": 0, "rows": 0, "pad_rows": 0,
                 "padded_bytes_wasted": 0},
            )
            bs["batches"] += 1
            bs["rows"] += b.rows
            bs["pad_rows"] += b.pad_rows
            bs["padded_bytes_wasted"] += b.padded_bytes_wasted
            metrics.GLOBAL.record_bucket(
                b.capacity, b.rows, b.pad_rows, b.padded_bytes_wasted
            )
        # struct overlay lands AFTER the device-set outputs (routed rows
        # rode the bucket step too; their device-set output is
        # replaced). Overlaid slots leave devsrc: their adopted offspring
        # go through the store listener's host upload, not the
        # device-set output (which holds the WRONG bytes for them).
        if work.struct_rows:
            if struct_mode == "device":
                s_out, s_lens, s_app = work.struct_work
                out_np = s_out.cpu().numpy()
                lens_np = s_lens.cpu().numpy()
                app_np = s_app.cpu().numpy()
                for p, (slot, ci) in enumerate(work.struct_rows):
                    results[slot] = bytes(out_np[p, :int(lens_np[p])])
                    if devsrc is not None:
                        devsrc.pop(slot, None)
                    metrics.GLOBAL.record_mutator(
                        stm.STRUCT_CODES[ci],
                        applied=int(app_np[p]) >= 0)
            else:
                for slot, ci in work.struct_rows:
                    payload = work.struct_work[slot]
                    results[slot] = payload
                    if devsrc is not None:
                        devsrc.pop(slot, None)
                    metrics.GLOBAL.record_mutator(
                        stm.STRUCT_CODES[ci],
                        applied=payload != store.get(ids[slot]))
        drain_wait_s = time.perf_counter() - t_w
        metrics.GLOBAL.record_stage("drain_wait", drain_wait_s)
        # dispatch + drain_wait bounds the device-batch turnaround
        metrics.GLOBAL.observe("batch_latency",
                               work.dispatch_s + drain_wait_s)
        finish_case(case, ids, results, work.scores,
                    work.dispatch_s + drain_wait_s, devsrc=devsrc)

    def _scores_to_host(sc):
        """Pull the score table off a possibly-dead device; if even the
        copy-out fails, degraded cases keep scheduling from a fresh
        zero table (energies, the feedback state that matters, live on
        the host store and survive regardless)."""
        try:
            return _host_scores(sc).copy()
        except Exception:  # lint: broad-except-ok device-lost coercion: zero scores are safe
            return np.zeros((batch, len(DEVICE_CODES)), np.int32)

    def _oracle_case(case, ids):
        """Host-oracle re-serve of one case: deterministic per
        (seed, case, slot) — availability at the cost of device-stream
        byte-identity (the degraded-mode trade)."""
        from ..oracle.engine import fuzz as oracle_fuzz

        a1, a2, a3 = opts["seed"]
        muta = opts.get("mutations") or default_mutations()
        results: dict[int, bytes] = {}
        t_w = time.perf_counter()
        with trace.span("corpus.oracle_fallback", case=case):
            for slot, sid in enumerate(ids):
                data = store.get(sid)[:device_max]
                results[slot] = oracle_fuzz(
                    data, seed=(a1 + case, a2 + slot, a3), mutations=muta,
                )
        metrics.GLOBAL.record_stage("oracle_fallback",
                                    time.perf_counter() - t_w)
        # the whole case host-routed (struct overlay included — degraded
        # mode trades the device stream for availability)
        metrics.GLOBAL.record_host_routed("degraded", len(ids))
        return results

    def _probe_device():
        """One tiny device op, waited on. The chaos fault point runs
        first so a still-armed persistent device.step spec keeps probes
        failing — recovery happens exactly when the (real or injected)
        fault clears."""
        chaos.fault_point("device.step")
        torch.zeros(8, device=dev).add_(1)
        if on_cuda:
            torch.cuda.synchronize(dev)

    def _discard_work(work):
        drain_futures(fut for _b, fut in work.launched)

    if use_async:
        drain = _DrainWorker(process_case, start_case,
                             discard=_discard_work)
    drain_floor = start_case  # first case the current drain may wait on
    device_mode = True
    degraded_from = None
    probe_at = 0

    t0 = time.perf_counter()
    try:
        case = start_case
        while case < n_cases:
            if device_mode:
                try:
                    if drain is not None and case > drain_floor:
                        # the -s contract's one serialization point: case
                        # N's energy events must land before schedule N+1
                        # draws
                        drain.wait_done(case - 1)
                    (ids, launched, scores, dispatch_s, s_rows,
                     s_work) = dispatch_case(case, scores)
                    if stats is not None:
                        stats.setdefault("schedules", []).append(list(ids))
                    work = _CaseWork(case, ids, launched, scores, dispatch_s,
                                     struct_rows=s_rows, struct_work=s_work)
                    if drain is not None:
                        drain.submit(work)
                    else:
                        process_case(work)
                    case += 1
                    if case == n_cases and drain is not None:
                        # inside the try: a device error surfacing only at
                        # the final drain still degrades and re-serves the
                        # tail instead of killing the run
                        drain.close()
                        drain = None
                except Exception as e:  # lint: broad-except-ok re-raised below unless is_device_error
                    if not is_device_error(e):
                        raise
                    # device lost: flag degraded, abandon in-flight work,
                    # rewind to the first case whose effects never landed
                    # (done_case tracks the drain's progress; its writes
                    # are host-side and complete per case)
                    redo_from = case
                    if drain is not None:
                        redo_from = min(case, drain.done_case + 1)
                        drain.abandon()
                        drain = None
                    logger.log("warning", "corpus: device lost at case %d "
                               "(%s) — host oracle serves from case %d",
                               case, e, redo_from)
                    metrics.GLOBAL.record_event("device_lost")
                    metrics.GLOBAL.set_degraded(True)
                    if cov is not None:
                        # fold on the numpy oracle while the device is
                        # out (bit-identical by the parity tests)
                        cov.use_device = False
                    scores = _scores_to_host(scores)
                    case = redo_from
                    degraded_from = case
                    device_mode = False
                    probe_at = case + DEVICE_PROBE_EVERY
            else:
                if case >= probe_at:
                    probe_at = case + DEVICE_PROBE_EVERY
                    try:
                        _probe_device()
                    except Exception:  # lint: broad-except-ok probe failure = device still down
                        pass  # still down; keep serving from the oracle
                    else:
                        logger.log("warning", "corpus: device recovered at "
                                   "case %d — resuming device pipeline",
                                   case)
                        metrics.GLOBAL.record_event("device_recovered")
                        metrics.GLOBAL.set_degraded(False)
                        if cov is not None:
                            cov.use_device = True
                        device_mode = True
                        if use_arena:
                            # the old arena tensor died with the device:
                            # rebuild empty and pay the seed upload once
                            arena.reset()
                            _seed_arena(tick=case)
                        if use_async:
                            scores = torch.as_tensor(scores, device=dev)
                            drain = _DrainWorker(process_case, case,
                                                 discard=_discard_work)
                            drain_floor = case
                        continue
                t_s = time.perf_counter()
                ids = sched.schedule(case, batch)
                ledger.record(case, ids)
                metrics.GLOBAL.record_stage("schedule",
                                            time.perf_counter() - t_s)
                if stats is not None:
                    stats.setdefault("schedules", []).append(list(ids))
                finish_case(case, ids, _oracle_case(case, ids), scores, 0.0)
                case += 1
    finally:
        if drain is not None:
            # abandon, not close: close re-raises the drain error and
            # would mask the exception already unwinding through here
            drain.abandon()
        # process-global flag: later runs in this process (tests, bench
        # stages) must see their own routing split
        _registry.set_struct_kernels(_struct_flag_before)

    # --distill: greedy set-cover over the per-seed coverage tensor —
    # retire every seed whose edge set is provably subsumed by the kept
    # set (afl-cmin analogue; corpus/distill.py pins the determinism and
    # the never-retire-uncovered rule)
    distilled = 0
    if cov is not None and distill_on:
        from .distill import greedy_minimize

        snap = cov.snapshot()
        keep, retired = greedy_minimize(snap["ids"], snap["maps"])
        distilled = store.retire_many(retired)
        if distilled:
            metrics.GLOBAL.record_distilled(distilled)
        print(f"# distill: {len(keep)} covering seeds keep "
              f"{cov.edges()} edges, {distilled} subsumed seeds retired",
              file=sys.stderr)
    store.save()
    dt = time.perf_counter() - t0
    metrics.GLOBAL.record_pipeline_wall(dt)
    total = tallies["total"]
    new_hashes = tallies["new_hashes"]
    if tallies["truncated"]:
        print(f"# {tallies['truncated']} scheduled samples exceeded the "
              f"device budget ({trunc_cap}B) and were truncated",
              file=sys.stderr)
    bytes_up = tallies["bytes_uploaded"] + (arena.bytes_uploaded
                                            if arena is not None else 0)
    if arena is not None:
        metrics.GLOBAL.record_arena(arena.stats())
    if stats is not None:
        stats.update(total=total, dt=dt, batch=batch,
                     buckets=bucket_stats, new_hashes=new_hashes,
                     pipeline=pipeline, layout=layout,
                     bytes_uploaded=bytes_up,
                     offspring=tallies["offspring"],
                     step_shapes=sorted(step_shapes),
                     struct=struct_mode,
                     struct_routed=tallies["struct_routed"],
                     store_stats=store.stats())
        if arena is not None:
            stats["arena"] = arena.stats()
        if gen_engine is not None:
            stats["gen"] = {
                "grammar": gen_engine.cg.source,
                "grammar_id": gen_engine.cg.grammar_id,
                "generated": gen_engine.expansions,
                "host_fallback": gen_engine.host_fallbacks,
                "degraded": gen_engine.degraded,
            }
        if cov is not None:
            stats["coverage"] = {
                "edges": cov.edges(), "folds": cov.folds,
                "maps": tallies["cov_maps"],
                "new_edges": tallies["cov_new_edges"],
                "degraded": not cov_live, "distilled": distilled,
                "hub": hub.stats(),
            }
    logger.log("info", "corpus backend (%s pipeline, %s layout): %d "
               "samples in %.2fs (%.0f samples/s), %d novel output hashes",
               pipeline, layout, total, dt, total / max(dt, 1e-9),
               new_hashes)
    waste = sum(b["padded_bytes_wasted"] for b in bucket_stats.values())
    rows = sum(b["rows"] for b in bucket_stats.values())
    adopt_note = ""
    if adopt_on:
        dev_adopted = arena.stats()["adopted"] if arena is not None else 0
        adopt_note = (f", {tallies['offspring']} offspring adopted "
                      f"({dev_adopted} device-side)")
    print(
        f"# {total} samples, {dt:.2f}s, {total / max(dt, 1e-9):.0f} "
        f"samples/s ({pipeline} pipeline, {layout} layout), "
        f"{new_hashes} novel hashes, {len(bucket_stats)} buckets, "
        f"{waste / max(rows, 1):.0f} padded bytes wasted/sample, "
        f"{bytes_up / max(total, 1):.0f} bytes uploaded/sample"
        f"{adopt_note}",
        file=sys.stderr,
    )
    if not device_mode:
        print(f"# device lost and not recovered: cases from "
              f"{degraded_from} on were served by the host oracle",
              file=sys.stderr)
        return EXIT_DEGRADED
    return 0
