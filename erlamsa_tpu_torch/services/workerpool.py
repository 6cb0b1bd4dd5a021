"""Case-parallel workers (-w N).

Reference: erlamsa_main:get_threading_mode + run_fuzzing_loop
(src/erlamsa_main.erl:89-108, 249-280): N cases split into per-worker
ranges plus a remainder; each worker runs the same loop with a seed drawn
from the parent stream (or the same seed with --workers-same-seed).
Processes (not threads) so oracle CPU work scales.

The workers are forked (multiprocessing's default start method on Linux
up to Python 3.13), and the parent has imported torch. Only the host
engine forks: the CLI reaches this module from ``--backend oracle``
alone, which never initialises CUDA, and a forked child of a process
that has must not touch the card. The same holds for ``-D``'s double
fork.
"""

from __future__ import annotations

import multiprocessing as mp

from ..utils.erlrand import ErlRand


def _worker_main(opts: dict, lo: int, hi: int, extra: int, wseed):
    from ..oracle.engine import Engine
    from ..utils.watchdog import CaseTimeout, run_with_timeout
    from . import out as outmod

    wopts = dict(opts)
    wopts["seed"] = wseed
    writer, _ = outmod.string_outputs(opts.get("output", "-"))
    eng = Engine(wopts)
    budget = opts.get("maxrunningtime") or 0

    def one_case(idx: int):
        try:
            data, meta = run_with_timeout(eng.run_case, budget, idx)
        except CaseTimeout:
            return  # abandoned like the reference's per-case kill
        if writer is not None and data:
            try:
                run_with_timeout(writer, budget, idx, data, meta)
            except (ConnectionError, CaseTimeout):
                pass

    for i in range(max(lo, 1), hi + 1):
        one_case(i)
    if extra:
        one_case(extra)


def split_ranges(n: int, workers: int) -> list[tuple[int, int, int]]:
    """[(lo, hi, extra_case)] per worker covering cases 1..n exactly:
    worker w owns [w*div, (w+1)*div - 1] and workers 0..rem additionally
    own case div*workers + w (get_threading_mode,
    src/erlamsa_main.erl:95-108)."""
    div = n // workers
    rem = n % workers
    out = []
    for w in range(workers):
        lo = w * div
        hi = (w + 1) * div - 1
        extra = div * workers + w if w <= rem else 0
        if w == 0:
            lo = 1
        if w == workers - 1:
            hi = min(hi, n)
        out.append((lo, hi, extra if extra and extra <= n else 0))
    return out


def run_workers(opts: dict, _writer) -> int:
    n = opts.get("n", 1)
    workers = opts.get("workers", 1)
    parent = ErlRand(opts["seed"])
    same_seed = opts.get("workers_same_seed", False)
    procs = []
    for lo, hi, extra in split_ranges(n, workers):
        wseed = (
            opts["seed"]
            if same_seed
            else (parent.erand(99999), parent.erand(99999), parent.erand(99999))
        )
        p = mp.Process(target=_worker_main, args=(opts, lo, hi, extra, wseed))
        p.start()
        procs.append(p)
    for p in procs:
        p.join()
    return 0
