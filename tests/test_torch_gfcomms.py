"""The port's grammar entry points against the JAX package's, on the
CPU, tolerance 0: the gfcomms service in both modes (services/gfcomms.py),
the CLI's --gen/--gfcomms/--gfcomms-batched errors, --gen through the
oracle's genfuz slot and through a feedback campaign (``--gen demo-tlv:16
--feedback``, its --metrics-out/--trace files read by obs/report.py), an
-e module offering grammar(), the exploit tool over the proxy's log
lines, and a fresh interpreter importing the new modules without jax.

No JAX expander is compiled here: the batched service is held against
the JAX keyed twin (models/genfuzz.generate_keyed), whose bytes the JAX
package's own tests pin to its expander.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import types

import pytest

from erlamsa_tpu.gen import compile as Jc
from erlamsa_tpu.models import genfuzz as Jg
from erlamsa_tpu.obs import report as Jreport
from erlamsa_tpu.ops import grammar as Jgk
from erlamsa_tpu.ops import prng as Jprng
from erlamsa_tpu.services import cli as Jcli
from erlamsa_tpu.services import exploit as Jexploit
from erlamsa_tpu.services import external as Jext
from erlamsa_tpu.services import gfcomms as Jgf
from erlamsa_tpu.services import logger as Jlog
from erlamsa_tpu.utils import erlrand as Jerl
from erlamsa_tpu_torch.gen import compile as Tc
from erlamsa_tpu_torch.gen.engine import GenEngine
from erlamsa_tpu_torch.obs import report as Treport
from erlamsa_tpu_torch.obs import trace as Ttrace
from erlamsa_tpu_torch.services import cli as Tcli
from erlamsa_tpu_torch.services import exploit as Texploit
from erlamsa_tpu_torch.services import external as Text
from erlamsa_tpu_torch.services import gfcomms as Tgf
from erlamsa_tpu_torch.services import logger as Tlog
from erlamsa_tpu_torch.services import metrics as Tm
from erlamsa_tpu_torch.utils import erlrand as Terl
from test_grammar_kernels import KITCHEN_SINK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = (17, 18, 19)
WAIT = 5  # a reply's wait, as the JAX package's gfcomms tests give it
# never an empty answer (a sizer always emits its field), so every
# packet gets a reply to wait for
SEQ_GRAMMAR = [("static", b"ab"), ("loop", [("range", 97, 122)], 5),
               ("sizer", "u8", [("rbinary", 3)])]


def _twin(case, slots, grammar=KITCHEN_SINK):
    """The JAX keyed twin's fuzzed payloads of (case, slot)."""
    cg = Jc.compile_grammar(grammar)
    out = []
    for s in slots:
        key = Jgk.gen_sample_key(Jprng.base_key(SEED), cg.grammar_id, case,
                                 s)
        row, n, _tr = Jg.generate_keyed(cg, key, fuzz=True)
        out.append(row[:n])
    return out


def _connect(srv):
    cli = socket.create_connection(("127.0.0.1", srv._srv.getsockname()[1]),
                                   timeout=WAIT)
    cli.settimeout(WAIT)
    return cli


def _recv_exactly(cli, n):
    got = b""
    while len(got) < n:
        chunk = cli.recv(65536)
        assert chunk, f"connection closed after {len(got)} of {n} bytes"
        got += chunk
    return got


def _session(srv, packets):
    """One connection, lockstep: a reply for each packet."""
    srv.serve(block=False)
    try:
        with _connect(srv) as cli:
            out = []
            for p in packets:
                cli.sendall(p)
                out.append(cli.recv(65536))
    finally:
        srv.stop()
    return out


def test_gfcomms_sequential_equals_jax():
    """Sequential mode at a fixed seed: the JAX server's replies, the
    same on a second run, and the seed logged at start-up."""
    lines = []
    sink = lines.append
    Tlog.GLOBAL.add_sink("debug", sink)
    try:
        runs = [_session(Tgf.GfComms(0, grammar=SEQ_GRAMMAR, seed=(9, 9, 9)),
                         [b"x"] * 5) for _ in range(2)]
        Tlog.GLOBAL.flush()
    finally:
        Tlog.GLOBAL.remove_sink(sink)
    want = _session(Jgf.GfComms(0, grammar=SEQ_GRAMMAR, seed=(9, 9, 9)),
                    [b"x"] * 5)
    assert runs[0] == runs[1] == want
    assert any("seed 9,9,9" in ln and "sequential" in ln for ln in lines)
    assert Tgf.GfComms(0, grammar=SEQ_GRAMMAR).seed is not None


def test_gfcomms_batched_equals_jax():
    """Batched mode on the CPU expander: a TCP connection in lockstep,
    then a connection whose six pending packets one drain answers with
    one expander call (a SOCK_SEQPACKET pair keeps them apart), then
    five connections at once, their packets grouped across connections
    by the batcher: reply i of connection c is the JAX keyed twin's
    (c, i) whatever the grouping."""
    eng = GenEngine(Tc.compile_grammar(KITCHEN_SINK), SEED, fuzz=True,
                    device="cpu")
    groups = []
    real = eng.expand

    def expand(case, n=None, slots=None):
        groups.append((list(case), list(slots)))
        return real(case, n=n, slots=slots)

    eng.expand = expand
    srv = Tgf.GfComms(0, seed=SEED, engine=eng)
    lockstep = _session(srv, [b"ping"] * 4)
    assert lockstep == _twin(0, range(4))

    mine, theirs = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
    with mine:
        mine.settimeout(WAIT)
        for _ in range(6):
            mine.sendall(b"p")
        handler = threading.Thread(
            target=Tgf.GfComms(0, seed=SEED, engine=eng)._handle_batched,
            args=(theirs, None, 1))
        handler.start()
        got = [mine.recv(65536) for _ in range(6)]
        mine.sendall(b"q")
        got.append(mine.recv(65536))
    handler.join(timeout=30)
    assert not handler.is_alive()
    assert got == _twin(1, range(7))
    assert groups[-2:] == [([1] * 6, list(range(6))), ([1], [6])]

    barrier = threading.Barrier(5)
    replies = {}

    def client(k):
        with _connect(srv) as c:
            barrier.wait(timeout=WAIT)
            mine = []
            for _ in range(3):
                c.sendall(b"x")
                mine.append(c.recv(65536))
            replies[k] = mine

    srv = Tgf.GfComms(0, seed=SEED, engine=eng).serve(block=False)
    try:
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(5)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=60)
    finally:
        srv.stop()
    assert sorted(replies) == list(range(5))
    want = {tuple(_twin(c, range(3))): c for c in range(5)}
    assert sorted(want[tuple(r)] for r in replies.values()) == list(range(5))
    assert eng.expansions == 26 and not eng.degraded


def test_gfcomms_cold_first_packet():
    """A batched server whose engine never expanded answers its first
    packet within the reply wait, with the right bytes: the engine is
    warmed before the listener binds (the JAX server compiles its
    expander on that packet), and the warm-up counts no expansion."""
    eng = GenEngine(Tc.compile_grammar(Tc.BUILTIN_GRAMMARS["demo-lines"]),
                    SEED, fuzz=True, device="cpu")
    srv = Tgf.GfComms(0, seed=SEED, engine=eng)
    assert eng._fn is None
    replies = _session(srv, [b"ping"])
    assert replies == _twin(0, [0], Tc.BUILTIN_GRAMMARS["demo-lines"])
    assert eng.expansions == 1


@pytest.mark.parametrize("argv", [
    ["--gen", "no-such-grammar", "-n", "1"],
    ["--gen", "demo-tlv:zap", "-n", "1"],
    ["--gen", "demo-tlv:0", "-n", "1"],
    ["--gen", "(pick)", "-n", "1"],
    ["--gen", "demo-tlv", "--fleet-nodes", "h:1", "-n", "1"],
    ["--gen", "demo-tlv", "--shards", "2", "-n", "1"],
    ["--gen", "demo-tlv", "--spmd", "-n", "1"],
    ["--gfcomms-batched", "-n", "1"],
    ["--gfcomms", "0", "-n", "1"],
    ["--gfcomms", "0", "--gfcomms-batched", "-n", "1"],
], ids=["unknown", "count-nan", "count-0", "spec", "fleet-nodes", "shards",
        "spmd", "batched-alone", "gfcomms-alone", "gfcomms-no-gen"])
def test_cli_errors_equal_jax(argv, tmp_path, monkeypatch):
    """Each refusal is the JAX CLI's one line."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as je:
        Jcli.main(argv)
    with pytest.raises(SystemExit) as te:
        Tcli.main(argv)
    assert str(te.value) == str(je.value)
    assert "\n" not in str(te.value) and str(te.value)


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(Tm, "GLOBAL", Tm.Counters())
    monkeypatch.setattr(Jlog, "GLOBAL", Jlog.Logger())
    monkeypatch.setattr(Tlog, "GLOBAL", Tlog.Logger())
    yield
    Ttrace.configure(None)


def test_oracle_genfuz_slot_equals_jax(tmp_path, monkeypatch, capfdbinary,
                                       fresh):
    """--gen GRAMMAR -g genfuz through the host engine: the JAX CLI's
    bytes (its default backend is the oracle)."""
    out = {}
    for pkg, main, extra in (("jax", Jcli.main, []),
                             ("port", Tcli.main, ["--backend", "oracle"])):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        capfdbinary.readouterr()
        assert main(["--gen", "demo-http", "-g", "genfuz", "-s", "1,2,3",
                     "-n", "4", *extra]) == 0
        out[pkg] = capfdbinary.readouterr().out
    assert out["port"] == out["jax"] and out["port"].count(b"\r\n") >= 4


def test_gen_campaign_cli_and_report_equal_jax(tmp_path, monkeypatch,
                                               capsys, fresh):
    """``--gen demo-tlv:16 --feedback --corpus DIR`` through the port's
    CLI on the CPU seeds the store from the grammar (the ``# gen:``
    line, origin "gen", stats in --metrics-out), and the JAX report tool
    and the port's render the same text and JSON from its --metrics-out
    and --trace files, with a non-empty stage ledger."""
    from erlamsa_tpu_torch.corpus.store import CorpusStore

    monkeypatch.chdir(tmp_path)
    m, t = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    os.makedirs(tmp_path / "out")
    rc = Tcli.main(["-s", "1,2,3", "-n", "2", "--batch", "8", "--gen",
                    "demo-tlv:16", "--feedback", "--corpus",
                    str(tmp_path / "store"), "--device", "cpu", "-o",
                    str(tmp_path / "out" / "%n"), "--metrics-out", m,
                    "--trace", t])
    err = capsys.readouterr().err
    assert rc == 0
    assert "# gen: 16 samples from grammar demo-tlv -> " in err
    store = CorpusStore(str(tmp_path / "store"))
    assert len(store) > 0 and len(os.listdir(tmp_path / "out")) == 16
    with open(m) as f:
        snap = json.load(f)
    assert snap["gen"]["expansions"] == 16
    assert snap["gen"]["host_fallback"] == 0
    texts = {}
    for pkg, mod in (("jax", Jreport), ("port", Treport)):
        capsys.readouterr()
        out_json = str(tmp_path / f"{pkg}.json")
        assert mod.main(["--metrics", m, "--trace", t, "--json",
                         out_json]) == 0
        with open(out_json) as f:
            texts[pkg] = (capsys.readouterr().out, f.read())
    assert texts["port"] == texts["jax"]
    report = json.loads(texts["port"][1])
    assert report["stages"]["ledger"] and report["gen"]["expansions"] == 16
    assert "-- stage ledger" in texts["port"][0]


def test_report_flight_and_errors_equal_jax(tmp_path, capsys):
    """A flight dump alone (JSONL), no artifact at all and an unreadable
    one: the JAX tool's text, JSON and exit codes."""
    dump = tmp_path / "f.jsonl"
    entries = [{"type": "meta", "reason": "test"},
               {"kind": "gen_panel", "samples": 4},
               {"type": "span", "name": "gen.expand", "node": "w1"},
               {"type": "event"}]
    dump.write_text("\n".join(json.dumps(e) for e in entries) + "\n")
    for argv in (["--flight", str(dump)],
                 ["--metrics", str(tmp_path / "missing.json")]):
        capsys.readouterr()
        rc_j = Jreport.main(argv)
        want = capsys.readouterr()
        rc_t = Treport.main(argv)
        got = capsys.readouterr()
        assert (rc_t, got.out) == (rc_j, want.out)
    assert (Treport.render_text(Treport.build_report())
            == Jreport.render_text(Jreport.build_report()))
    fed = {"nodes": {"w1": {"counters": {"samples": 5}, "stages": {"a": 1}}},
           "ingests": {"w1": 3}}
    assert (Treport.build_report(federation_snap=fed)
            == Jreport.build_report(federation_snap=fed))
    for mod in (Jreport, Treport):
        with pytest.raises(SystemExit):
            mod.main([])


def test_external_grammar_module_equals_jax(monkeypatch):
    """-e MODULE offering grammar(): its genfuz generator gives the JAX
    package's samples (the urandom seed fixed in both), and the CLI's
    loader puts it in the run's options."""
    mod = types.ModuleType("torch_gf_external")
    mod.capabilities = lambda: set()
    mod.grammar = lambda: Tc.parse_grammar(Tc.BUILTIN_GRAMMARS["demo-tlv"])
    monkeypatch.setitem(sys.modules, "torch_gf_external", mod)
    monkeypatch.setattr(Jerl, "gen_urandom_seed", lambda: (5, 6, 7))
    monkeypatch.setattr(Terl, "gen_urandom_seed", lambda: (5, 6, 7))
    jgen = Jext.load_external("torch_gf_external").generator()
    tgen = Text.load_external("torch_gf_external").generator()
    for _ in range(4):
        assert tgen() == jgen()
    opts = {}
    Tcli._load_external("torch_gf_external", opts)
    assert opts["external_generator"]()[1] == ("generator", "genfuz")


def test_exploit_equals_jax(tmp_path, capsys):
    """The replay script from the port proxy's log lines (repr and hex
    payloads, both directions) is the JAX tool's, byte for byte; so are
    its answers to a log with no packets and to missing arguments."""
    lines = []
    log = Tlog.Logger()
    log.add_sink("debug", lines.append)
    for i, (d, data, render) in enumerate([
            ("c->s", b"GET / HTTP/1.0\r\n\r\n", "str"),
            ("s->c", b"\x00\xff'\"quote", "str"),
            ("c->s", bytes(range(40)), "hex")]):
        log.log_data("info", "proxy fuzzed packet %d (%s)", (i, d), data,
                     render)
    log.log("info", "unrelated line")
    log.flush()
    path = tmp_path / "proxy.log"
    path.write_text("\n".join(lines) + "\n")
    empty = tmp_path / "empty.log"
    empty.write_text("nothing here\n")
    for argv in ([str(path), "{out}", "10.0.0.1", "8080"],
                 [str(empty), "{out}"], ["only-one"]):
        res = {}
        for pkg, mod in (("jax", Jexploit), ("port", Texploit)):
            out = tmp_path / f"{pkg}.py"
            capsys.readouterr()
            rc = mod.main([a.replace("{out}", str(out)) for a in argv])
            text = out.read_text() if out.exists() else None
            res[pkg] = (rc, text, capsys.readouterr().out.replace(
                str(out), "OUT"))
            if out.exists():
                out.unlink()
        assert res["port"] == res["jax"]
    assert len(Texploit.parse_log(lines)) == 3


def test_new_modules_import_no_jax():
    """The grammar modules, the offline tools and the CLI import, compile
    a grammar and expand it on the CPU in a fresh interpreter with
    neither jax nor erlamsa_tpu in sys.modules."""
    code = (
        "import sys\n"
        "import erlamsa_tpu_torch.gen, erlamsa_tpu_torch.gen.engine\n"
        "import erlamsa_tpu_torch.ops.grammar, erlamsa_tpu_torch.models.genfuzz\n"
        "import erlamsa_tpu_torch.services.gfcomms\n"
        "import erlamsa_tpu_torch.services.exploit\n"
        "import erlamsa_tpu_torch.obs.report, erlamsa_tpu_torch.services.cli\n"
        "from erlamsa_tpu_torch.gen import GenEngine, compile_grammar\n"
        "eng = GenEngine(compile_grammar('(rbinary 3)'), (1, 2, 3), "
        "device='cpu')\n"
        "assert [len(p) for p in eng.expand(0, n=2)[0]] == [3, 3]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'erlamsa_tpu' or "
        "m.startswith('erlamsa_tpu.'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_store_add_many_equals_adds(tmp_path):
    """CorpusStore.add_many (the gen seeding's one index save a panel)
    leaves the store of one add per seed: ids, order, origins and the
    saved index."""
    from erlamsa_tpu_torch.corpus.store import CorpusStore

    datas = [b"one", b"", b"two", b"one", b"three"]
    one = CorpusStore(str(tmp_path / "one"))
    want = [one.add(d, origin="gen") for d in datas]
    many = CorpusStore(str(tmp_path / "many"))
    assert many.add_many(datas, origin="gen") == want
    # reloaded from the saved index
    one, many = (CorpusStore(str(tmp_path / d)) for d in ("one", "many"))
    assert many.ids() == one.ids()
    assert [many.meta(s) for s in many.ids()] == [one.meta(s)
                                                  for s in one.ids()]
