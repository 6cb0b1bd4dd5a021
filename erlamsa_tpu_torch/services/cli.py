"""Command line of the port's batch fuzzer (the ``--backend tpu`` path of
erlamsa_tpu/services/cli.py): the full mutator set, device codes on the
card and host codes on the host oracle (or, with --struct, the
structured ones on the span-splice engine), any output sink of the
reference, and --state checkpoints in the JAX CLI's format. With
``--feedback --corpus DIR`` it runs the closed-loop corpus engine
(corpus/runner.py) instead, with its --pipeline, --layout, --arena-*
and --adopt options. With ``-H HOST:PORT`` it serves fuzzing as a
service over HTTP from the device engines (services/faas.py). With
``-i proto://...`` it runs the fuzzing MitM proxy (services/proxy.py),
its packets mutated on the card by the flush batcher. ``-e MODULE``
loads an external module (services/external.py) before any mode.

    python -m erlamsa_tpu_torch -s 1,2,3 -n 4 --batch 4096 seeds/*
    python -m erlamsa_tpu_torch -s 1,2,3 -n 100 --state run.npz -r seeds/
    python -m erlamsa_tpu_torch -s 1,2,3 -n 4 --struct device seeds/*
    python -m erlamsa_tpu_torch -s 1,2,3 -n 8 --feedback --corpus DIR \
        --layout arena --adopt seeds/*
    python -m erlamsa_tpu_torch -s 1,2,3 -H 127.0.0.1:17771
    python -m erlamsa_tpu_torch -s 1,2,3 -i tcp://8080:127.0.0.1:80 -P 1.0,1.0
"""

from __future__ import annotations

import argparse
import json
import os

from .. import resolve_device
from ..oracle.mutations import default_mutations
from ..oracle.patterns import default_patterns
from . import chaos, logger, metrics
from .batchrunner import run_batch


def _parse_seed(s: str) -> tuple[int, int, int]:
    parts = [int(x) for x in s.split(",")]
    if len(parts) != 3:
        raise SystemExit(f"erlamsa_tpu_torch: seed must be three "
                         f"comma-separated integers, got {s!r}")
    return (parts[0], parts[1], parts[2])


def _urandom_seed() -> tuple[int, int, int]:
    def word() -> int:
        b = os.urandom(2)
        return b[1] + (b[0] << 8)

    return (word(), word(), word())


class UnknownAction(ValueError):
    """A mutation, pattern or generator name that is not in the set."""


def read_actions(spec: str | None, defaults, what: str
                 ) -> list[tuple[str, int]]:
    """'name=pri,name,...' -> [(name, pri)] over ``defaults``
    (erlamsa_tpu/services/cli.py:_parse_actions): no spec gives the whole
    default set and a bare name takes its default priority. An unknown
    name raises UnknownAction naming ``what``, a bad priority ValueError:
    a server answers either as an error and goes on serving."""
    if spec in (None, "", "default"):
        return list(defaults)
    known = dict(defaults)
    out = []
    for item in spec.split(","):
        if not item:
            continue
        name, eq, pri = item.partition("=")
        out.append((name, int(pri) if eq else known.get(name, 1)))
    bad = [n for n, _ in out if n not in known]
    if bad:
        raise UnknownAction(f"unknown {what} name(s): {bad}")
    return out


def parse_actions(spec: str | None, defaults, what: str
                  ) -> list[tuple[str, int]]:
    """read_actions for the command line: an unknown name exits with one
    line."""
    try:
        return read_actions(spec, defaults, what)
    except UnknownAction as e:
        raise SystemExit(f"erlamsa_tpu_torch: {e}") from None


def parse_mutations(spec: str | None) -> list[tuple[str, int]]:
    """-m / erlamsa-mutations over the oracle's default mutations."""
    return parse_actions(spec, default_mutations(), "mutation")


def parse_patterns(spec: str | None) -> list[tuple[str, int]]:
    """-p / erlamsa-patterns over the oracle's default patterns."""
    return parse_actions(spec, default_patterns(), "pattern")


def _serve(args, opts: dict, device) -> int:
    """-H: the FaaS server on the device engines (the JAX CLI's -H with
    --backend tpu), options in ``opts`` as erlamsa_tpu/services/cli.py
    puts them; -T reaches the oracle escape through service_budget."""
    from .faas import serve

    host, _, port = args.httpsvc.rpartition(":")
    opts["cmanager_store"] = args.cmanager_store
    opts["serving"] = args.serving
    if args.serving_slots is not None:
        opts["slots"] = args.serving_slots
    if args.capacity is not None:
        opts["capacity"] = args.capacity
    opts["queue_cap"] = args.queue_cap
    opts["tenant_rate"] = args.tenant_rate
    opts["tenant_burst"] = args.tenant_burst
    return serve(host or "0.0.0.0", int(port), opts, backend="tpu",
                 batch=args.batch, device=device)


def _load_external(name: str, opts: dict) -> None:
    """-e: the module's custom mutations and post hook go into ``opts``
    as erlamsa_tpu/services/cli.py puts them; a module that does not load
    exits with one line."""
    from .external import load_external

    try:
        ext = load_external(name)
        gen = ext.generator() if ext else None
    except (ImportError, ValueError) as e:
        raise SystemExit(f"erlamsa_tpu_torch: -e {name}: {e}") from None
    if ext:
        opts["external_module"] = ext
        if gen is not None:
            opts["external_generator"] = gen
        post = ext.post()
        if post is not None:
            opts["post"] = post


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m erlamsa_tpu_torch",
        description="Batch mutation fuzzer (PyTorch/CUDA port).")
    p.add_argument("paths", nargs="*", help="seed files (stdin if none)")
    p.add_argument("-s", "--seed", default=None, help="random seed a,b,c")
    p.add_argument("-n", "--count", type=int, default=1,
                   help="number of cases")
    p.add_argument("-m", "--mutations", default=None,
                   help="mutators 'name[=pri],...' (default: all 41 at their "
                        "default priorities)")
    p.add_argument("-T", "--maxrunningtime", type=float, default=None,
                   help="per-case budget in seconds of host-routed work "
                        "(default 30); a case past it is abandoned")
    p.add_argument("--device-capacity-max", type=int, default=None,
                   metavar="BYTES",
                   help="largest capacity class run on the device; bigger "
                        "samples overflow to the host oracle")
    p.add_argument("-o", "--output", default="-",
                   help="output: '-' (stdout), a file pattern (%%n = sample "
                        "index), tcp://host:port, tcp://:port (listen), "
                        "udp://..., http://..., tls://, exec://cmdline, "
                        "ip://, serial://, can://, canisotp://, cansockd://, "
                        "cansockd_isotp:// (services/out.py)")
    p.add_argument("-r", "--recursive", action="store_true",
                   help="walk directories among the seed paths")
    p.add_argument("--corpus", default=None, metavar="DIR",
                   help="persistent seed store directory: input seeds are "
                        "content-hash-deduped into DIR and the run draws "
                        "from the store (corpus/store.py)")
    p.add_argument("--state", default=None, metavar="FILE",
                   help="checkpoint file (.npz) to stop and resume the run; "
                        "the JAX CLI's format, so either package resumes "
                        "the other's at the same ERLAMSA_PALLAS")
    p.add_argument("--checkpoint-every", type=int, default=1, metavar="N",
                   help="--state save cadence in cases (fsync per save; "
                        "a crash re-runs at most N-1 deterministic cases)")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write the final metrics snapshot as JSON to FILE")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="deterministic fault injection spec, e.g. "
                        "'checkpoint.save:x1' (services/chaos.py; "
                        "ERLAMSA_FAULTS is the env equivalent, --chaos wins)")
    p.add_argument("--struct", choices=["off", "host", "device"],
                   default="off",
                   help="structured-format engine (ops/structure.py): "
                        "route the span-splice mutators (tr2 td ts1 tr "
                        "ts2 js sgm b64 uri) through the one-pass span "
                        "tokenizer instead of the host oracle tail. "
                        "'device' runs them on the card "
                        "(ops/tree_mutators.py); zip is then the only "
                        "host-routed code; 'host' is the byte-identical "
                        "numpy parity path; 'off' (default) keeps the "
                        "legacy hybrid routing")
    p.add_argument("--struct-kernels", action="store_true",
                   help="shorthand for --struct device")
    p.add_argument("--feedback", action="store_true",
                   help="feedback-driven corpus engine (requires --corpus): "
                        "AFL-style energy scheduling over the store, "
                        "length-bucketed device batches, monitor/proxy "
                        "events promote seeds")
    p.add_argument("--pipeline", choices=["sync", "async"], default="async",
                   help="corpus execution pipeline: async (default) "
                        "overlaps host assembly, device mutation and "
                        "output drain; sync is the serialized baseline. "
                        "Outputs are byte-identical at a fixed -s")
    p.add_argument("--layout", choices=["buckets", "arena"],
                   default="buckets",
                   help="corpus memory layout: buckets (default) "
                        "re-uploads pow2-padded panels per case; arena "
                        "keeps seeds device-resident in fixed-size pages "
                        "addressed through a page table — ~zero padded "
                        "waste, each seed crosses to the device once "
                        "(corpus/arena.py)")
    p.add_argument("--arena-pages", type=int, default=None, metavar="N",
                   help="arena page count (default: 2x the pages the "
                        "store needs, min 64 — eviction/spill handle "
                        "overflow)")
    p.add_argument("--arena-page", type=int, default=None, metavar="BYTES",
                   help="arena page size in bytes (default 256; must "
                        "divide the run's working width)")
    p.add_argument("--arena-classes", default=None, metavar="SPEC",
                   help="arena capacity classes: comma-separated byte "
                        "widths (e.g. '256,4096,65536') or 'auto' "
                        "(default) to derive them from the stored seed "
                        "sizes. Each seed rides the smallest class that "
                        "holds it whole — short seeds stop paying the "
                        "widest row's gather/compute (corpus/arena.py)")
    p.add_argument("--adopt", action="store_true",
                   help="device-resident offspring adoption: interesting "
                        "offspring scatter straight from the step's "
                        "output buffer into free arena pages of the "
                        "right class, so only content hashes and "
                        "lengths cross to the host (requires --layout "
                        "arena; outputs stay byte-identical at a fixed -s)")
    p.add_argument("-H", "--httpsvc", default=None, metavar="HOST:PORT",
                   help="serve fuzzing as a service over HTTP at HOST:PORT "
                        "(/erlamsa/erlamsa_esi:fuzz, :json, :manage and "
                        "GET /metrics) from the device engines")
    p.add_argument("--serving", choices=["continuous", "flush"],
                   default="continuous",
                   help="-H device engine: continuous (default) admits "
                        "requests into a slot array at step granularity "
                        "(services/serving.py); flush keeps the "
                        "deadline-flushed batcher of --batch rows. A "
                        "request id's bytes are the same in both at a "
                        "fixed -s")
    p.add_argument("--serving-slots", type=int, default=None, metavar="N",
                   help="continuous-engine slot count (device rows per "
                        "step; default 64)")
    p.add_argument("--capacity", type=int, default=None, metavar="BYTES",
                   help="serving and -i proxy working width in bytes "
                        "(default 16384); longer requests and packets "
                        "overflow to the host oracle")
    p.add_argument("--queue-cap", type=int, default=1024, metavar="N",
                   help="-H admission backlog bound: requests beyond it "
                        "shed with HTTP 429 + Retry-After (0 = unbounded)")
    p.add_argument("--tenant-rate", type=float, default=0.0, metavar="R",
                   help="per-tenant admission quota in requests/s (token "
                        "bucket; 0 = no quotas)")
    p.add_argument("--tenant-burst", type=float, default=None, metavar="B",
                   help="per-tenant burst allowance (default 2x rate)")
    p.add_argument("--cmanager-store", default=None, metavar="PATH",
                   help="persist -H tokens and sessions to a JSON file "
                        "(the reference keeps them in mnesia)")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve Prometheus text exposition on PORT/metrics "
                        "(-H also serves GET /metrics without it)")
    p.add_argument("-i", "--proxy", default=None,
                   help="fuzzing proxy spec proto://lport:rhost:rport "
                        "(tcp, udp, http, http2, tls; connect://lport::; "
                        "serial://dev1@baud:dev2@baud); packets mutate on "
                        "the device batcher (256 rows x 16384 B, 20 ms "
                        "deadline), longer ones on the host oracle")
    p.add_argument("-P", "--proxy-prob", default="0.1,0.1",
                   help="proxy fuzzing probabilities c->s,s->c")
    p.add_argument("-k", "--bypass", type=int, default=0,
                   help="pass through the first K proxy packets unfuzzed")
    p.add_argument("--ascent", type=float, default=0.0,
                   help="proxy probability ascent coefficient")
    p.add_argument("--certfile", default=None, help="TLS cert for tls:// proxy")
    p.add_argument("--keyfile", default=None, help="TLS key for tls:// proxy")
    p.add_argument("-e", "--external", default=None,
                   help="python module with capabilities() (custom "
                        "mutations and a post hook for the host oracle)")
    p.add_argument("--batch", type=int, default=1024,
                   help="batch size (and the -H flush engine's rows)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    if args.feedback and not args.corpus:
        raise SystemExit("erlamsa-tpu: --feedback requires --corpus DIR")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    seed = _parse_seed(args.seed) if args.seed else _urandom_seed()
    # fault injection arms before the run, keyed on the seed's first
    # component: the same spec and -s fire the same faults
    try:
        if args.chaos:
            chaos.configure(args.chaos, seed=seed[0])
        else:
            chaos.configure_from_env(seed=seed[0])
    except ValueError as e:
        raise SystemExit(f"erlamsa_tpu_torch: {e}")
    opts = {
        "paths": args.paths or ["-"],
        "n": args.count,
        "seed": seed,
        "mutations": parse_mutations(args.mutations),
        "output": args.output,
        "maxrunningtime": args.maxrunningtime,
        "recursive": args.recursive,
        "corpus_dir": args.corpus,
        "state_path": args.state,
        "checkpoint_every": args.checkpoint_every,
        "struct": "device" if args.struct_kernels else args.struct,
        "feedback": args.feedback,
        "pipeline": args.pipeline,
        "layout": args.layout,
        "arena_pages": args.arena_pages,
        "arena_page": args.arena_page,
        "arena_classes": args.arena_classes,
        "adopt": args.adopt,
        "certfile": args.certfile,
        "keyfile": args.keyfile,
        **({"device_capacity_max": args.device_capacity_max}
           if args.device_capacity_max is not None else {}),
    }
    # the external module loads before the service modes, so -e applies
    # to the proxy's oracle escape too
    if args.external:
        _load_external(args.external, opts)
    if args.metrics_port:
        from ..obs import prom

        prom.serve_metrics(args.metrics_port)
    try:
        if args.httpsvc:
            return _serve(args, opts, device)
        if args.proxy:
            from .proxy import FuzzProxy

            width = {} if args.capacity is None else {
                "capacity": args.capacity}
            return FuzzProxy(args.proxy, args.proxy_prob, opts,
                             bypass=args.bypass, ascent=args.ascent,
                             device=device, **width).start(block=True)
        if args.feedback:
            # the closed loop: energy-scheduled store draws, bucketed
            # device batches, bus events promoting seeds
            from ..corpus.runner import run_corpus_batch

            return run_corpus_batch(opts, batch=args.batch, device=device)
        return run_batch(opts, batch=args.batch, device=device)
    finally:
        if args.metrics_out:
            try:
                with open(args.metrics_out, "w") as f:
                    json.dump(metrics.GLOBAL.snapshot(), f, indent=2,
                              default=str)
            except OSError as e:
                logger.log("warning", "cli: metrics snapshot to %s "
                           "failed: %s", args.metrics_out, e)
        logger.GLOBAL.flush()
