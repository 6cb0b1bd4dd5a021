"""Command line of the port (erlamsa_tpu/services/cli.py, flag for flag
where the port runs the mode). ``--backend tpu`` (the port's default:
its entry points run on the card unless asked otherwise) is the batch
fuzzer: the full mutator set, device codes on the card and host codes on
the host oracle (or, with --struct, the structured ones on the
span-splice engine), any output sink of the reference, and --state
checkpoints in the JAX CLI's format. ``--backend oracle`` (the JAX CLI's
default) runs the sequential host engine (oracle/engine.py) and touches
no CUDA: stdin or seed files to stdout or any sink, -p/-g/-b/--skip/
--sleep/--maxfails/-S, -M meta files, ``-w N`` worker processes
(services/workerpool.py) and --corpus stores, byte for byte the JAX
CLI's at a fixed -s. With ``--feedback --corpus DIR`` it runs the
closed-loop corpus engine (corpus/runner.py) on the card, with its
--pipeline, --layout, --arena-* and --adopt options, and with
``--coverage`` the connect-back coverage hub (services/monitors.py)
gating adoption on new edges, ``--distill`` retiring subsumed seeds at
the end. With ``-H HOST:PORT`` it serves fuzzing as a service over HTTP
(services/faas.py); with ``-i proto://...`` it runs the fuzzing MitM
proxy (services/proxy.py); both take --backend. ``--gen GRAMMAR[:N]``
compiles a grammar (gen/): with --feedback its samples, expanded on the
card, seed the store; with --backend oracle it fills the genfuz
generator slot; ``--gfcomms PORT`` serves it per TCP packet, sequential
or (``--gfcomms-batched``) through the expander on the card. ``-e
MODULE`` loads an external module (services/external.py) before any
mode, ``--monitor``
starts the monitor plane, ``-L``/``--list-findings`` write and read the
findings store, and ``--trace``/``--xprof``/``--flight-dir`` arm the
observability side channel (obs/), which never changes a byte.

    echo 'Hello erlamsa!' | python -m erlamsa_tpu_torch --backend oracle \
        -s 1,2,3
    python -m erlamsa_tpu_torch --backend oracle -s 1,2,3 -w 2 -n 8 \
        -o 'out/%n' seeds/*
    python -m erlamsa_tpu_torch -s 1,2,3 -n 4 --batch 4096 seeds/*
    python -m erlamsa_tpu_torch -s 1,2,3 -n 100 --state run.npz -r seeds/
    python -m erlamsa_tpu_torch -s 1,2,3 -n 4 --struct device seeds/*
    python -m erlamsa_tpu_torch -s 1,2,3 -n 8 --feedback --corpus DIR \
        --layout arena --adopt --coverage --coverage-port 7000 --distill \
        seeds/*
    python -m erlamsa_tpu_torch -s 1,2,3 -n 1 --trace t.json --xprof prof/ \
        seeds/*
    python -m erlamsa_tpu_torch -s 1,2,3 -H 127.0.0.1:17771
    python -m erlamsa_tpu_torch -s 1,2,3 -i tcp://8080:127.0.0.1:80 -P 1.0,1.0
    python -m erlamsa_tpu_torch -s 1,2,3 -n 8 --gen demo-tlv:4096 \
        --feedback --corpus DIR
    python -m erlamsa_tpu_torch --backend oracle -s 1,2,3 -g genfuz \
        --gen demo-http -n 4
    python -m erlamsa_tpu_torch -s 1,2,3 --gen demo-lines --gfcomms 7000 \
        --gfcomms-batched
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import resolve_device
from ..oracle.gen import default_generators
from ..oracle.mutations import default_mutations
from ..oracle.patterns import default_patterns
from ..utils.erlrand import gen_urandom_seed, parse_seed
from . import chaos, logger, metrics, out


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


def _show_list() -> None:
    """-l / --list introspection (show_list, src/erlamsa_cmdparse.erl:
    147-178), the JAX CLI's text."""
    from ..ops.registry import DEVICE_CODES
    from ..oracle.gen import GENERATOR_INFO
    from ..oracle.patterns import patterns_table

    descs = {
        "sgm": "SGML tree mutations", "js": "JSON tree mutations",
        "uw": "try to make a code point too wide",
        "ui": "insert funny unicode",
        "ab": "enhance silly issues in ASCII string data handling",
        "ad": "play with delimeters in ASCII string data",
        "tr2": "duplicate a node", "td": "delete a node",
        "num": "try to modify a textual number",
        "ts1": "swap one node with another one",
        "tr": "repeat a path of the parse tree",
        "ts2": "swap two nodes pairwise",
        "bd": "drop a byte", "bei": "increment a byte by one",
        "bed": "decrement a byte by one", "bf": "flip one bit",
        "bi": "insert a byte", "ber": "swap a byte with random one",
        "br": "repeat a byte", "sp": "permute a sequence of bytes",
        "sr": "repeat a sequence of bytes", "sd": "delete a sequence of bytes",
        "snand": "NAND/OR/XOR random bytes from block",
        "srnd": "replace random bytes from block with random values",
        "ld": "delete a line", "lds": "delete many lines",
        "lr2": "duplicate a line", "lri": "copy a line closeby",
        "lr": "repeat a line", "ls": "swap two lines",
        "lp": "swap order of lines", "lis": "insert a line from elsewhere",
        "lrs": "replace a line with one from elsewhere",
        "ft": "jump to a similar position in block",
        "fn": "likely clone data between similar positions",
        "fo": "fuse previously seen data elsewhere",
        "len": "predicted length mutation",
        "b64": "try mutate base64-encoded block",
        "uri": "try mutate URI to cause SSRF", "zip": "ZIP path traversal",
        "nil": "no mutation will occur (debugging purposes)",
    }
    print("Mutations (-m)   [* = also runs on TPU backend]")
    for name, pri in default_mutations():
        star = "*" if name in DEVICE_CODES else " "
        print(f"  {star} {name:6s} pri={pri:<3d} {descs.get(name, '')}")
    print("\nPatterns (-p)")
    for pri, _fn, name, desc in patterns_table():
        print(f"    {name:6s} pri={pri:<3d} {desc}")
    print("\nGenerators (-g)")
    for name, pri, desc in GENERATOR_INFO:
        print(f"    {name:6s} pri={pri:<6d} {desc}")


def _serve(args, opts: dict, device) -> int:
    """-H: the FaaS server on the device engines (``--backend tpu``) or
    the host oracle (``--backend oracle``, no device), options in
    ``opts`` as erlamsa_tpu/services/cli.py puts them; -T reaches the
    oracle escape through service_budget."""
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
    return serve(host or "0.0.0.0", int(port), opts, backend=args.backend,
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m erlamsa_tpu_torch",
        description="General-purpose mutation fuzzer (PyTorch/CUDA port; "
                    "erlamsa-compatible CLI).")
    p.add_argument("paths", nargs="*", help="seed files (stdin if none)")
    p.add_argument("-s", "--seed", default=None,
                   help="random seed a,b,c, or source:PATH (6 bytes of "
                        "external entropy)")
    p.add_argument("-n", "--count", default="1",
                   help="number of cases, or 'inf'")
    p.add_argument("-m", "--mutations", default=None,
                   help="mutators 'name[=pri],...' (default: all 41 at their "
                        "default priorities)")
    p.add_argument("-p", "--patterns", default="default",
                   help="mutation patterns 'name[=pri],...' (host engine)")
    p.add_argument("-g", "--generators", default="default",
                   help="sample generators 'name[=pri],...' (host engine)")
    p.add_argument("-b", "--blockscale", type=float, default=1.0,
                   help="host engine: scale of the stdin/file block sizes")
    p.add_argument("-w", "--workers", type=int, default=1,
                   help="host engine: cases split over N worker processes "
                        "(each with a seed drawn from -s)")
    p.add_argument("--workers-same-seed", action="store_true",
                   help="all workers use the run seed instead of derived "
                        "seeds")
    p.add_argument("--skip", type=int, default=0,
                   help="host engine: skip the first N cases")
    p.add_argument("--sleep", type=int, default=0,
                   help="host engine: ms between cases")
    p.add_argument("--maxfails", type=int, default=10,
                   help="host engine: output failures tolerated in a row")
    p.add_argument("-S", "--sequence-muta", action="store_true",
                   help="host engine: mutate each case from the previous "
                        "case's output")
    p.add_argument("-M", "--meta", default=None,
                   help="host engine: write each case's metadata to path")
    p.add_argument("-T", "--maxrunningtime", type=float, default=None,
                   help="per-case budget in seconds of host-routed work "
                        "(default 30 on the device paths, unlimited on the "
                        "host engine); a case past it is abandoned")
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
    p.add_argument("-l", "--list", action="store_true",
                   help="list mutations, patterns and generators")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-L", "--logger", default=None,
                   help="log spec: stdout|stderr|file=path|sqlite=path "
                        "(sqlite is the queryable findings store; see "
                        "--list-findings)")
    p.add_argument("--list-findings", default=None, metavar="DB",
                   help="print findings recorded in a '-L sqlite=DB' "
                        "store from any past run, then exit")
    p.add_argument("-d", "--debug", action="store_true",
                   help="start the periodic profiler")
    p.add_argument("-D", "--detach", action="store_true",
                   help="daemonize (fork to background)")
    p.add_argument("--monitor", action="append", default=[],
                   help="+name:params / !name:off (cm, probe, exec, r2, lc, "
                        "lxi, cdb; services/monitors.py)")
    p.add_argument("--backend", choices=["oracle", "tpu"], default="tpu",
                   help="tpu (default) = the batched device engine on the "
                        "card; oracle = the sequential host engine, no "
                        "device")
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
    p.add_argument("--coverage", action="store_true",
                   help="edge-coverage feedback (requires --feedback): "
                        "listen for connect-back edge bitmaps "
                        "(services/monitors.py CoverageHub), fold them "
                        "into per-seed coverage tensors on the card "
                        "(ops/coverage.py) and gate adoption/energy on "
                        "genuinely-new edges instead of output-hash "
                        "novelty; a dead monitor plane degrades the run "
                        "to hash-novelty, byte-identical to --coverage "
                        "off at a fixed -s")
    p.add_argument("--coverage-port", type=int, default=None, metavar="PORT",
                   help="coverage hub listen port (default: ephemeral, "
                        "logged at startup)")
    p.add_argument("--distill", action="store_true",
                   help="end-of-run corpus distillation (requires "
                        "--coverage): greedy set-cover keeps the "
                        "smallest seed set whose union covers every "
                        "observed edge and retires the provably-"
                        "subsumed rest (corpus/distill.py)")
    p.add_argument("--shards", type=int, default=None, metavar="N",
                   help="the sharded corpus fleet: not yet ported")
    p.add_argument("--spmd", action="store_true",
                   help="the single-program fleet: not yet ported")
    p.add_argument("--fleet-nodes", default=None, metavar="HOST:PORT,...",
                   help="the cross-host fleet: not yet ported")
    p.add_argument("-H", "--httpsvc", default=None, metavar="HOST:PORT",
                   help="serve fuzzing as a service over HTTP at HOST:PORT "
                        "(/erlamsa/erlamsa_esi:fuzz, :json, :manage and "
                        "GET /metrics) from the device engines, or the "
                        "host oracle with --backend oracle")
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
    p.add_argument("-i", "--proxy", default=None,
                   help="fuzzing proxy spec proto://lport:rhost:rport "
                        "(tcp, udp, http, http2, tls; connect://lport::; "
                        "serial://dev1@baud:dev2@baud); packets mutate on "
                        "the device batcher (256 rows x 16384 B, 20 ms "
                        "deadline), longer ones (and all of them with "
                        "--backend oracle) on the host oracle")
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
                   help="torch device of the device paths (default cuda; "
                        "'cpu' for the plain path)")
    gen = p.add_argument_group(
        "grammar generation (gen/; generate-then-mutate)")
    gen.add_argument("--gen", default=None, metavar="GRAMMAR[:N]",
                     help="compile GRAMMAR (a builtin name or an "
                          "s-expression DSL file; see README "
                          "'Generation-based fuzzing') for expansion on "
                          "the card. With --feedback, seed the campaign "
                          "with N generated samples (default 64) from one "
                          "batched expander call — device loss degrades to "
                          "the keyed host oracle byte-identically (chaos "
                          "site gen.expand). Without --feedback the "
                          "grammar feeds the oracle engine's genfuz "
                          "generator slot (--backend oracle). Spec errors "
                          "are hard errors")
    gen.add_argument("--gfcomms", type=int, default=None, metavar="PORT",
                     help="serve grammar-generated data per TCP packet "
                          "(services/gfcomms.py; requires --gen). -s "
                          "seeds the stream and is logged at startup, so "
                          "a fixed seed replays byte-identically")
    gen.add_argument("--gfcomms-batched", action="store_true",
                     help="gfcomms drains a connection's pending packets "
                          "through ONE expander call on the card; "
                          "responses are keyed by (connection, packet "
                          "index), so the single-connection replay "
                          "contract holds regardless of how packets were "
                          "batched")
    obs = p.add_argument_group(
        "observability (obs/; a side channel — outputs at a fixed -s are "
        "byte-identical with tracing on or off)")
    obs.add_argument("--trace", default=None, metavar="FILE",
                     help="write a Chrome-trace-event JSON of pipeline "
                          "spans to FILE (load in Perfetto or "
                          "chrome://tracing)")
    obs.add_argument("--xprof", default=None, metavar="DIR",
                     help="also run torch.profiler (CPU, and CUDA on the "
                          "card) into DIR, each span a record_function, "
                          "lining host spans up with the device's kernels")
    obs.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                     help="serve Prometheus text exposition on PORT/metrics "
                          "(-H also serves GET /metrics without it)")
    obs.add_argument("--flight-dir", default=None, metavar="DIR",
                     help="flight recorder dump directory: the ring of "
                          "recent spans/events is written here as JSONL "
                          "on device loss, breaker-open, supervisor "
                          "give-up, or SIGUSR2")
    obs.add_argument("--log-format", choices=["text", "json"],
                     default="text",
                     help="json: one object per log line with "
                          "level/ts/component/span_id, correlating logs "
                          "with traces and flight dumps")
    return p


def _logger_spec(spec: str, verbose: int) -> dict:
    """-L 'stdout,file=path,...' -> logger.configure's sink spec."""
    sinks = {}
    for part in spec.split(","):
        if part in ("stdout", "stderr"):
            sinks[part] = "debug" if verbose else "info"
        elif part.startswith("file="):
            sinks["file"] = (part[5:], "debug")
        elif part.startswith("sqlite="):
            # findings-and-worse only: every row is an individually
            # fsync'd commit, so info/debug lines stay on stream sinks
            sinks["sqlite"] = (part[7:], "finding")
    return sinks


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    fleet_mode = args.shards is not None or args.fleet_nodes or args.spmd
    if args.distill and not args.coverage:
        raise SystemExit("erlamsa-tpu: --distill requires --coverage "
                         "(set-cover needs the per-seed coverage tensor)")
    if args.coverage and not args.feedback:
        raise SystemExit("erlamsa-tpu: --coverage requires --feedback "
                         "(coverage gates the feedback runner's adoption)")
    if args.distill and fleet_mode:
        raise SystemExit(
            "erlamsa-tpu: --distill is single-device only (set-cover "
            "runs over the runner's end-of-run tensor): drop --shards/"
            "--fleet-nodes/--spmd to distill, or drop --distill to run "
            "the fleet with coverage")
    gen_opts = _gen_opts(args)
    if args.gen and fleet_mode:
        # hard error, not a silent ignore: generation is single-device
        # first (one panel seeds one store before the campaign starts)
        raise SystemExit(
            "erlamsa-tpu: --gen is single-device only for now: drop "
            "--shards/--fleet-nodes/--spmd to run generate-then-mutate, "
            "or drop --gen to run the fleet")
    if args.gfcomms is not None and not args.gen:
        raise SystemExit("erlamsa-tpu: --gfcomms requires --gen GRAMMAR "
                         "(the grammar to serve)")
    if args.gfcomms_batched and args.gfcomms is None:
        raise SystemExit("erlamsa-tpu: --gfcomms-batched requires "
                         "--gfcomms PORT")
    if fleet_mode:
        raise SystemExit("erlamsa_tpu_torch: --shards/--fleet-nodes/--spmd "
                         "(the corpus fleet) is not yet ported")

    if args.list:
        _show_list()
        return 0

    if args.list_findings:
        try:
            rows = logger.query_log(args.list_findings, level="finding",
                                    limit=None)
        except (FileNotFoundError, ValueError) as e:
            raise SystemExit(f"erlamsa-tpu: {e}")
        for _id, ts, _level, message in rows:
            print(f"{ts}\t{message}")
        print(f"# {len(rows)} finding(s)", file=sys.stderr)
        return 0

    if args.feedback and not args.corpus:
        raise SystemExit("erlamsa-tpu: --feedback requires --corpus DIR")
    # the card is resolved only where a device path runs: the host engine
    # (--backend oracle, outside --feedback) and sequential --gfcomms
    # touch no CUDA
    device = None
    if args.feedback or args.gfcomms_batched or (
            args.backend == "tpu" and args.gfcomms is None):
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(str(e))

    if args.log_format != "text":
        # before any sink logs a line, so every record is structured
        logger.GLOBAL.set_format(args.log_format)
    if args.logger:
        logger.GLOBAL.configure(_logger_spec(args.logger, args.verbose))

    try:
        seed = (parse_seed(args.seed, allow_source=True) if args.seed
                else gen_urandom_seed())
    except ValueError as e:
        raise SystemExit(f"erlamsa-tpu: {e}")
    with open("./last_seed.txt", "w") as f:  # erlamsa_main.erl:135
        f.write(repr(seed))

    # fault injection arms before the run, keyed on the seed's first
    # component: the same spec and -s fire the same faults
    try:
        if args.chaos:
            chaos.configure(args.chaos, seed=seed[0])
        else:
            chaos.configure_from_env(seed=seed[0])
    except ValueError as e:
        raise SystemExit(f"erlamsa_tpu_torch: {e}")

    # observability arms before engines and services for the same reason
    from ..obs import flight, trace

    if args.flight_dir:
        flight.configure(args.flight_dir)
    if args.trace or args.xprof:
        # the campaign trace id is seed-derived (no wall clock, no
        # entropy), as in the JAX CLI
        trace.configure(path=args.trace, xprof=args.xprof,
                        trace_id="c%08x" % (seed[0] & 0xFFFFFFFF),
                        xprof_cuda=device is not None
                        and device.type == "cuda")
    if args.metrics_port:
        from ..obs import prom

        prom.serve_metrics(args.metrics_port)

    def _finish():
        # idempotent: trace.export() is a no-op without --trace/--xprof,
        # and the atexit hook armed in trace.configure backstops the
        # service modes
        trace.export()
        if args.metrics_out:
            try:
                with open(args.metrics_out, "w") as f:
                    json.dump(metrics.GLOBAL.snapshot(), f, indent=2,
                              default=str)
            except OSError as e:
                logger.log("warning", "cli: metrics snapshot to %s "
                           "failed: %s", args.metrics_out, e)
        logger.GLOBAL.flush()

    n = 2**62 if args.count == "inf" else int(args.count)
    opts = {
        "paths": args.paths or ["-"],
        "n": n,
        "seed": seed,
        "mutations": parse_mutations(args.mutations),
        "patterns": parse_patterns(args.patterns),
        "generators": parse_actions(args.generators, default_generators(),
                                    "generator"),
        "blockscale": args.blockscale,
        "skip": args.skip,
        "sleep": args.sleep,
        "maxfails": args.maxfails,
        # None = unset: engines treat it as unlimited, service modes as 30s
        "maxrunningtime": args.maxrunningtime,
        "sequence_muta": args.sequence_muta,
        "recursive": args.recursive,
        "checkpoint_every": args.checkpoint_every,
        **({"device_capacity_max": args.device_capacity_max}
           if args.device_capacity_max is not None else {}),
        "workers": args.workers,
        "workers_same_seed": args.workers_same_seed,
        "corpus_dir": args.corpus,
        "feedback": args.feedback,
        "pipeline": args.pipeline,
        "layout": args.layout,
        "arena_pages": args.arena_pages,
        "arena_page": args.arena_page,
        "arena_classes": args.arena_classes,
        "adopt": args.adopt,
        "coverage": args.coverage,
        "distill": args.distill,
        "struct": "device" if args.struct_kernels else args.struct,
        "output": args.output,
        "verbose": args.verbose,
        "meta_path": args.meta,
        "certfile": args.certfile,
        "keyfile": args.keyfile,
        "state_path": args.state,
        # --gen: the runner seeds from the compiled grammar; the oracle
        # engine's genfuz slot picks up the raw grammar (sequential path)
        **({"gen": gen_opts, "gen_grammar": gen_opts["grammar"]}
           if gen_opts else {}),
    }

    if args.detach:
        import os

        # classic double-fork detach (the reference re-execs a -detached
        # escript, src/erlamsa.erl:9-13 + erlamsa_daemon), from the host
        # engine only: resolving the card has initialised CUDA, which a
        # forked child must not use
        if device is not None:
            raise SystemExit("erlamsa_tpu_torch: -D detaches the host "
                             "engine only (--backend oracle, no "
                             "--feedback)")
        if os.fork() > 0:
            return 0
        os.setsid()
        if os.fork() > 0:
            os._exit(0)

    # the external module and the profiler load before the service modes,
    # so -e and -d apply to the proxy's oracle escape too
    if args.external:
        _load_external(args.external, opts)
    if args.debug:
        metrics.Profiler().start()

    try:
        if args.httpsvc:
            return _serve(args, opts, device)
        if args.proxy:
            from .proxy import FuzzProxy

            width = {} if args.capacity is None else {
                "capacity": args.capacity}
            return FuzzProxy(args.proxy, args.proxy_prob, opts,
                             backend=args.backend, bypass=args.bypass,
                             ascent=args.ascent, device=device,
                             **width).start(block=True)
        if args.gfcomms is not None:
            return _gfcomms(args, gen_opts, seed, device)
        if args.monitor:
            from .monitors import start_monitors

            start_monitors(args.monitor)
        if args.feedback:
            return _run_feedback(args, opts, device)
        if args.backend == "tpu":
            from .batchrunner import run_batch

            return run_batch(opts, batch=args.batch, device=device)
        if args.corpus:
            _store_paths(args, opts)
        return _run_oracle(opts)
    finally:
        # findings from the last cases must reach durable sinks (sqlite,
        # file), and the trace must land, before the process dies
        _finish()


def _gen_opts(args) -> dict | None:
    """--gen GRAMMAR[:N] -> the runner's ``gen`` options (the grammar, its
    compiled tables, its label and the sample count), or None. Spec
    errors exit with one line, as in the JAX CLI."""
    if not args.gen:
        return None
    # hard errors by design: a typo'd grammar must abort the run with
    # a pointer at the DSL doc, never start an unseeded campaign
    spec, _, n_part = args.gen.partition(":")
    try:
        gen_count = int(n_part) if n_part else 64
    except ValueError:
        raise SystemExit(f"erlamsa-tpu: --gen {args.gen!r}: sample "
                         f"count {n_part!r} is not an integer") from None
    if gen_count < 1:
        raise SystemExit(f"erlamsa-tpu: --gen {args.gen!r}: sample "
                         f"count must be >= 1")
    from ..gen import GenSpecError, compile_grammar, load_grammar

    try:
        grammar, label = load_grammar(spec)
        compiled = compile_grammar(grammar, source=label)
    except GenSpecError as e:
        raise SystemExit(
            f"erlamsa-tpu: --gen: {e} (grammar DSL reference: "
            f"README.md, 'Generation-based fuzzing')") from None
    return {"grammar": grammar, "compiled": compiled, "label": label,
            "n": gen_count}


def _gfcomms(args, gen_opts: dict, seed, device) -> int:
    """--gfcomms PORT: the grammar service, sequential (the ErlRand
    stream) or, with --gfcomms-batched, on a GenEngine on the card."""
    from .gfcomms import GfComms

    engine = None
    if args.gfcomms_batched:
        from ..gen import GenEngine

        # fuzz=True: the batched service replaces the sequential
        # fuzz_grammar path, so leaves mutate at the 1/depth rate
        engine = GenEngine(gen_opts["compiled"], seed, fuzz=True,
                           device=device)
    return GfComms(args.gfcomms, grammar=gen_opts["grammar"], seed=seed,
                   engine=engine).serve(block=True)


def _run_feedback(args, opts: dict, device) -> int:
    """--feedback: the closed loop (energy-scheduled store draws,
    bucketed device batches, bus events promoting seeds); with
    --coverage the hub binds before the runner builds anything, so an
    instrumented target can connect back the moment the campaign
    starts, and it stops however the run ends."""
    from ..corpus.runner import run_corpus_batch

    cov_hub = None
    if args.coverage:
        from .monitors import CoverageHub

        cov_hub = CoverageHub(port=args.coverage_port or 0).start()
        opts["coverage_hub"] = cov_hub
    try:
        return run_corpus_batch(opts, batch=args.batch, device=device)
    finally:
        if cov_hub is not None:
            cov_hub.stop()
            cov_hub.join(timeout=5)


def _store_paths(args, opts: dict) -> None:
    """--backend oracle --corpus DIR: dedup the inputs into the store and
    run the host engine over the store's seed files (the store IS
    files)."""
    from ..corpus.store import CorpusStore

    store = CorpusStore(args.corpus)
    in_paths = [p for p in opts["paths"] if p != "-"]
    if in_paths:
        from ..oracle.gen import _expand_paths

        expanded = _expand_paths(in_paths) if args.recursive else in_paths
        new, dup, skipped = store.add_paths(expanded)
        print(f"# corpus: {new} new, {dup} duplicate, {skipped} "
              f"skipped -> {len(store)} seeds", file=sys.stderr)
    if len(store) == 0:
        raise SystemExit("erlamsa-tpu: --corpus store is empty and no "
                         "readable seeds were given")
    opts["paths"] = store.seed_paths()
    opts["recursive"] = False


def _run_oracle(opts: dict) -> int:
    """The host engine (erlamsa_tpu/services/cli.py:_run_oracle): -w N
    with a per-worker sink through services/workerpool.py, else one
    Engine writing each case (and its metadata with -M)."""
    from ..oracle.engine import Engine

    workers = opts.get("workers", 1)
    output = opts.get("output", "-")
    if workers > 1 and output not in ("-", "return", "stdout", "stderr"):
        # workers create their own writers: binding sockets here too would
        # clash with theirs (e.g. tcp:// listen mode)
        from .workerpool import run_workers

        return run_workers(opts, None)

    writer, _maxtime = out.string_outputs(output)
    meta_fd = open(opts["meta_path"], "w") if opts.get("meta_path") else None

    def writing(case_idx, data, meta):
        if writer is not None:
            writer(case_idx, data, meta)
        if meta_fd:
            meta_fd.write(f"{case_idx}\t{meta!r}\n")

    eng = Engine(opts)
    if writer is None:
        # return mode: Engine collects, the CLI prints the results
        for rdata in eng.run():
            sys.stdout.buffer.write(rdata)
        sys.stdout.buffer.flush()
    else:
        eng.run(writing)
    if meta_fd:
        meta_fd.close()
    return 0
