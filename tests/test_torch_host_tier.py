"""The port CLI's host tier against the JAX CLI, in-process on the CPU,
tolerance 0: ``python -m erlamsa_tpu_torch --backend oracle`` writes the
bytes of ``python -m erlamsa_tpu`` (whose default backend is the oracle)
on stdout and in files, for BASELINE.json configs[0], -p/-g/-b/--skip/-S,
-M meta files, -w N workers, a source: seed and --corpus; -l, -n inf,
last_seed.txt, -L sqlite= with --list-findings, the coverage options'
one-line errors, --trace/--xprof/--flight-dir, and the monitor plane's
crash triage and watchdogs (as tests/test_coverage.py holds the JAX
package's). The host tier touches no CUDA."""

import io
import json
import os
import sys
import time

import pytest
import torch

from erlamsa_tpu.services import cli as Jcli
from erlamsa_tpu.services import logger as Jlog
from erlamsa_tpu.services import monitors as Jmon
from erlamsa_tpu.services.workerpool import split_ranges as j_split_ranges
from erlamsa_tpu_torch.corpus import feedback as Tfb
from erlamsa_tpu_torch.obs import trace as Ttrace
from erlamsa_tpu_torch.services import cli as Tcli
from erlamsa_tpu_torch.services import logger as Tlog
from erlamsa_tpu_torch.services import metrics as Tm
from erlamsa_tpu_torch.services import monitors as Tmon
from erlamsa_tpu_torch.services.workerpool import split_ranges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELLO = b"Hello erlamsa!\n"  # BASELINE.json configs[0]'s stdin
SEEDS = {"s1": b"seed one 123\nline two 45\n<a href='x'>t</a>\n",
         "s2": b"\x00\x01binary\xff\xfe 99 " * 8}


@pytest.fixture
def host(tmp_path, monkeypatch, capfdbinary):
    """run(argv, stdin) -> (rc, stdout bytes, {file: bytes}, last_seed)
    for each CLI, each in a directory of its own holding the seed files;
    the port's run adds --backend oracle. Loggers are fresh per run."""
    for name, data in SEEDS.items():
        (tmp_path / name).write_bytes(data)

    def run(argv, stdin=HELLO):
        got = {}
        for pkg, main in (("jax", Jcli.main), ("port", Tcli.main)):
            d = tmp_path / pkg
            d.mkdir(exist_ok=True)
            monkeypatch.chdir(d)
            monkeypatch.setattr(sys, "stdin",
                                io.TextIOWrapper(io.BytesIO(stdin)))
            monkeypatch.setattr(Jlog, "GLOBAL", Jlog.Logger())
            monkeypatch.setattr(Tlog, "GLOBAL", Tlog.Logger())
            args = [a.replace("{seeds}", str(tmp_path)) for a in argv]
            if pkg == "port":
                args += ["--backend", "oracle"]
            capfdbinary.readouterr()
            rc = main(args)
            out = capfdbinary.readouterr().out
            files = {}
            for root, _dirs, names in os.walk(d):
                for f in names:
                    if f != "last_seed.txt":
                        p = os.path.join(root, f)
                        files[os.path.relpath(p, d)] = open(p, "rb").read()
            got[pkg] = (rc, out, files,
                        (d / "last_seed.txt").read_text())
        return got

    return run


def test_configs0_stdout_equals_jax(host):
    """echo 'Hello erlamsa!' | erlamsa --seed 1,2,3 (BASELINE.json
    configs[0]): the same bytes on stdout, the same last_seed.txt."""
    got = host(["--seed", "1,2,3"])
    assert got["port"] == got["jax"]
    rc, out, files, last = got["port"]
    assert rc == 0 and out and out != HELLO and last == "(1, 2, 3)"


@pytest.mark.parametrize("extra", [["-p", "od"], ["-p", "nd=3,bu"],
                                   ["-g", "random"], ["-b", "2"],
                                   ["--skip", "2"], ["-S"],
                                   ["-m", "bf,num=5", "--maxfails", "3"]],
                         ids=["p-od", "p-pri", "g-random", "b2", "skip2",
                              "S", "m"])
def test_host_options_equal_jax(host, extra):
    """-n 5 over seed files with each host option: the same stdout."""
    got = host(["-s", "7,8,9", "-n", "5", *extra, "{seeds}/s1",
                "{seeds}/s2"])
    assert got["port"] == got["jax"]
    assert got["port"][1]


def test_meta_and_file_outputs_equal_jax(host):
    """-M writes the JAX CLI's metadata lines; -o %n writes its files."""
    got = host(["-s", "3,1,4", "-n", "4", "-M", "meta.txt", "-o", "o-%n",
                "{seeds}/s1"])
    assert got["port"] == got["jax"]
    files = got["port"][2]
    assert files["meta.txt"].count(b"\n") == 4
    assert sum(f.startswith("o-") for f in files) >= 3


def cli_procs(tmp_path, argv):
    """Each CLI in a fresh process (the port's with --backend oracle) in
    a directory of its own: -w forks its workers, which a test process
    running threads must not do. Returns {pkg: {file: bytes}}."""
    import subprocess

    got = {}
    for pkg, mod in (("jax", "erlamsa_tpu"), ("port", "erlamsa_tpu_torch")):
        d = tmp_path / pkg
        (d / "w").mkdir(parents=True)
        args = [a.replace("{seeds}", str(tmp_path)) for a in argv]
        if pkg == "port":
            args += ["--backend", "oracle"]
        r = subprocess.run([sys.executable, "-m", mod, *args], cwd=d,
                           capture_output=True, timeout=120,
                           env=dict(os.environ, PYTHONPATH=REPO,
                                    JAX_PLATFORMS="cpu"))
        assert r.returncode == 0, r.stderr[-2000:]
        got[pkg] = {f: (d / "w" / f).read_bytes()
                    for f in os.listdir(d / "w")}
    return got


@pytest.mark.parametrize("same_seed", [False, True],
                         ids=["derived", "same-seed"])
def test_workers_equal_jax(tmp_path, same_seed):
    """-w 2 -n 7 -o DIR/%n: two worker processes with seeds drawn from -s
    (or the run seed itself) write the JAX CLI's files."""
    for name, data in SEEDS.items():
        (tmp_path / name).write_bytes(data)
    got = cli_procs(tmp_path, ["-s", "5,5,5", "-w", "2", "-n", "7", "-o",
                               "w/%n", *(["--workers-same-seed"]
                                         if same_seed else []),
                               "{seeds}/s1", "{seeds}/s2"])
    assert got["port"] == got["jax"] and len(got["port"]) >= 5
    for n in range(1, 30):
        for w in range(1, 6):
            assert split_ranges(n, w) == j_split_ranges(n, w)


def test_source_seed_and_corpus_equal_jax(host, tmp_path):
    """A source: seed (6 bytes of external entropy) and a --corpus store
    the host engine runs over: the same seed, store and bytes."""
    (tmp_path / "entropy").write_bytes(bytes([1, 2, 3, 4, 5, 6, 7]))
    got = host(["-s", f"source:{tmp_path}/entropy", "-n", "3",
                "--corpus", "store", "{seeds}/s1", "{seeds}/s2"])
    assert got["port"] == got["jax"]
    assert got["port"][3] == repr((0x0102, 0x0304, 0x0506))
    assert any(f.startswith("store") for f in got["port"][2])


def test_list_and_count_parsing_equal_jax(capsys, monkeypatch, tmp_path):
    """-l prints the JAX CLI's text; -n inf is 2**62 cases in both."""
    assert Jcli.main(["-l"]) == 0
    want = capsys.readouterr().out
    assert Tcli.main(["-l"]) == 0
    assert capsys.readouterr().out == want
    assert "Mutations (-m)" in want and "Generators (-g)" in want
    seen = {}
    monkeypatch.setattr(Jcli, "_run_oracle",
                        lambda o: seen.setdefault("jax", o) and 0)
    monkeypatch.setattr(Tcli, "_run_oracle",
                        lambda o: seen.setdefault("port", o) and 0)
    monkeypatch.chdir(tmp_path)
    Jcli.main(["-n", "inf", "-s", "1,2,3"])
    Tcli.main(["-n", "inf", "-s", "1,2,3", "--backend", "oracle"])
    assert seen["port"]["n"] == seen["jax"]["n"] == 2**62
    for key in ("seed", "mutations", "patterns", "generators", "blockscale",
                "skip", "sleep", "maxfails", "sequence_muta", "paths",
                "workers", "workers_same_seed", "meta_path", "output"):
        assert seen["port"][key] == seen["jax"][key], key


def test_list_findings_reads_either_store(tmp_path, monkeypatch, capfd):
    """A -L sqlite= store written through each package's CLI and logger:
    --list-findings of either CLI prints the same rows for it."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "s").write_bytes(b"abc")
    dbs = {}
    for pkg, main, log in (("jax", Jcli.main, Jlog), ("port", Tcli.main,
                                                       Tlog)):
        db = str(tmp_path / f"{pkg}.db")
        monkeypatch.setattr(log, "GLOBAL", log.Logger())
        args = ["-s", "1,2,3", "-L", f"sqlite={db}", "-o", "o-%n", "s"]
        assert main(args + (["--backend", "oracle"] if pkg == "port"
                            else [])) == 0
        log.log("finding", "exec target died with signal %d on case %d",
                11, 1)
        log.log("info", "not a finding")
        log.GLOBAL.flush()
        dbs[pkg] = db
    capfd.readouterr()
    for db in dbs.values():
        assert Jcli.main(["--list-findings", db]) == 0
        want = capfd.readouterr()
        assert Tcli.main(["--list-findings", db]) == 0
        got = capfd.readouterr()
        assert (got.out, got.err) == (want.out, want.err)
        assert "signal 11 on case 1" in got.out
        assert got.err.strip() == "# 1 finding(s)"
    with pytest.raises(SystemExit, match="no findings store"):
        Tcli.main(["--list-findings", str(tmp_path / "missing.db")])


@pytest.mark.parametrize("argv", [
    ["--distill"], ["--coverage"], ["--coverage", "--distill"],
    ["--feedback", "--coverage", "--distill", "--shards", "2"],
    ["--feedback", "--coverage", "--distill", "--spmd"]],
    ids=["distill", "coverage", "both", "shards", "spmd"])
def test_coverage_cli_errors_equal_jax(argv):
    """The JAX CLI's one-line errors for --distill without --coverage,
    --coverage without --feedback and --distill with the fleet."""
    with pytest.raises(SystemExit) as want:
        Jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        Tcli.main(argv)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("erlamsa-tpu: --")
    assert "\n" not in str(got.value)


def test_host_tier_touches_no_cuda(tmp_path, monkeypatch, capfdbinary):
    """--backend oracle (with -H's and -i's backend passed through) never
    resolves a device; --backend tpu without a card fails loudly."""
    monkeypatch.chdir(tmp_path)

    def no_device(*_a, **_k):
        raise AssertionError("the host tier resolved a device")

    monkeypatch.setattr(Tcli, "resolve_device", no_device)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(HELLO)))
    assert Tcli.main(["--backend", "oracle", "-s", "1,2,3"]) == 0
    seen = {}
    from erlamsa_tpu_torch.services import faas, proxy

    monkeypatch.setattr(faas, "serve", lambda *a, **k: seen.update(
        serve=(k["backend"], k["device"])) or 0)

    class FakeProxy:
        def __init__(self, *a, **k):
            seen["proxy"] = (k["backend"], k["device"])

        def start(self, block):
            return 0

    monkeypatch.setattr(proxy, "FuzzProxy", FakeProxy)
    assert Tcli.main(["--backend", "oracle", "-H", "127.0.0.1:1"]) == 0
    assert Tcli.main(["--backend", "oracle", "-i", "tcp://1:h:2"]) == 0
    assert seen == {"serve": ("oracle", None), "proxy": ("oracle", None)}
    assert not torch.cuda.is_initialized()
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    # -D forks, so it detaches the host engine only
    with pytest.raises(SystemExit, match="-D detaches the host engine"):
        Tcli.main(["-s", "1,2,3", "-D", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            Tcli.main(["-s", "1,2,3", "--backend", "tpu"])


def test_trace_and_flight_dir_change_no_byte(host, tmp_path):
    """--trace FILE, --xprof DIR and --flight-dir DIR on the host engine:
    the same stdout as without them; the trace is Chrome-trace JSON with
    the seed-derived trace id, and the profiler's trace lands in DIR."""
    from erlamsa_tpu.obs import flight as Jflight
    from erlamsa_tpu.obs import trace as Jtrace
    from erlamsa_tpu_torch.obs import flight as Tflight

    plain = host(["-s", "9,9,9", "-n", "3", "{seeds}/s1"])["port"]
    try:
        got = host(["-s", "9,9,9", "-n", "3", "--trace", "t.json",
                    "--xprof", "xp", "--flight-dir", "fl",
                    "{seeds}/s1"])
    finally:
        for mod in (Ttrace, Jtrace, Tflight, Jflight):
            mod.configure(None)
    assert got["port"][1] == plain[1] == got["jax"][1]
    doc = json.loads(got["port"][2]["t.json"])
    assert doc["otherData"]["trace_id"] == "c%08x" % 9
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert "oracle.case" in names, names
    prof = [f for f in got["port"][2] if f.startswith("xp" + os.sep)]
    assert len(prof) == 1
    events = json.loads(got["port"][2][prof[0]])["traceEvents"]
    assert "oracle.case" in {e.get("name") for e in events}


# ---- the monitor plane ---------------------------------------------------

def _wait(pred, timeout=15.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.01)
    return True


def test_crash_triage_equals_jax():
    """The same triage keys and first-seen verdicts, in the same order,
    for backtraces, deeper frames, other signals and plain noise."""
    bt = (b"#0 0x0004 in foo (a.c:1)\n#1 0x0008 in bar (a.c:9)\n"
          b"#2 0x000c in baz (a.c:12)")
    seq = [(11, bt), (11, bt + b"\n#3 0x0010 in deeper (a.c:44)"), (6, bt),
           (11, b"#0 0x00c0 in other (b.c:2)"),
           (11, b"plain stderr noise\nmore noise"), (11, None),
           (11, b"  at com.example.Main.run(Main.java:12)\n")]
    t, j = Tmon.CrashTriage(), Jmon.CrashTriage()
    assert [t.observe(s, o) for s, o in seq] == [j.observe(s, o)
                                                 for s, o in seq]
    assert t.dups == j.dups == 1


def test_run_after_spawn_failure_and_hang(monkeypatch):
    """after=exec: a spawn failure is counted and logged, a hung action
    is killed by the watchdog — as in the JAX package."""
    monkeypatch.setattr(Tm, "GLOBAL", Tm.Counters())
    Tmon._run_after({"after": "/nonexistent/definitely-missing-binary-xyz"})
    assert Tm.GLOBAL.snapshot()["monitors"] == {"spawn_failed": 1}
    Tmon._run_after({"after": "sleep 30", "after_timeout": 0.3})
    assert _wait(lambda: Tm.GLOBAL.snapshot()["monitors"]
                 .get("hang_killed", 0) == 1)
    assert Tm.GLOBAL.snapshot()["monitors"]["after_spawned"] == 1


def test_exec_monitor_hang_watchdog_and_cli(monkeypatch, tmp_path):
    """The exec monitor kills a hung target and publishes a hang finding;
    --monitor specs parse and start as the JAX package's do."""
    monkeypatch.setattr(Tm, "GLOBAL", Tm.Counters())
    Tfb.GLOBAL.drain()
    mon = Tmon.ExecMonitor({"app": "sleep 30", "timeout": 0.3,
                            "delay": 60}).start()
    try:
        assert _wait(lambda: any(e.kind == "finding" and e.detail == "hang"
                                 and e.source == "monitor:exec"
                                 for e in Tfb.GLOBAL.drain()))
    finally:
        mon.stop()
        mon.join(timeout=10)
    assert Tm.GLOBAL.snapshot()["monitors"]["hang_killed"] >= 1
    for spec in ("+exec:app=sleep 1,timeout=2", "!cm:off", "probe:port=80",
                 "+lxi:host=h,lvalue=0.1,uvalue=2"):
        assert (Tmon.parse_monitor_spec(spec)
                == Jmon.parse_monitor_spec(spec))
    assert sorted(Tmon.MONITORS) == sorted(Jmon.MONITORS)
    started = {}
    real_start = Tmon.start_monitors
    monkeypatch.setattr(Tmon, "start_monitors",
                        lambda specs: started.setdefault("specs", specs))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(HELLO)))
    assert Tcli.main(["--backend", "oracle", "-s", "1,2,3", "--monitor",
                      "+exec:app=true", "--monitor", "!cm:off"]) == 0
    assert started["specs"] == ["+exec:app=true", "!cm:off"]
    # an unknown monitor is logged and skipped, a disabled one not started
    assert real_start(["+nosuch:x=1", "!cm:off"]) == []


def test_chip_smoke_digests_are_the_jax_clis(host, tmp_path):
    """chip_smoke.py phase 11 (d) holds the card machine's runs to two
    md5 constants: configs[0]'s stdout and the files of -w 2 -n 8 -o
    DIR/%n over a file of the same line. Both are the JAX CLI's (and the
    port's) here."""
    import hashlib

    import chip_smoke

    got = host(["-s", "1,2,3"], stdin=chip_smoke.HOST_LINE)
    for pkg in ("jax", "port"):
        assert (hashlib.md5(got[pkg][1]).hexdigest()
                == chip_smoke.HOST_CONFIGS0_MD5)
    (tmp_path / "hello").write_bytes(chip_smoke.HOST_LINE)
    cli_procs(tmp_path / "w2", ["-s", "1,2,3", "-w", "2", "-n", "8", "-o",
                                "w/%n", str(tmp_path / "hello")])
    for pkg in ("jax", "port"):
        assert (chip_smoke.files_md5(str(tmp_path / "w2" / pkg / "w"))
                == chip_smoke.HOST_WORKERS_MD5)


def test_xprof_alone_writes_the_profile(tmp_path, monkeypatch):
    """--xprof DIR without --trace: the port's export stops the profiler
    and writes its trace into DIR. The JAX CLI's export returns before it
    stops jax.profiler when no --trace path is set, so its DIR stays
    empty (a fault of the reference, kept there)."""
    import subprocess

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(HELLO)))
    try:
        assert Tcli.main(["--backend", "oracle", "-s", "1,2,3", "--xprof",
                          "xp"]) == 0
    finally:
        Ttrace.configure(None)
    assert len(os.listdir(tmp_path / "xp")) == 1
    r = subprocess.run([sys.executable, "-m", "erlamsa_tpu", "-s", "1,2,3",
                        "--xprof", "jxp"], input=HELLO, cwd=tmp_path,
                       capture_output=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO,
                                JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert not any(files for _r, _d, files in os.walk(tmp_path / "jxp"))
