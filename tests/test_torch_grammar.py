"""The port's grammar generation (erlamsa_tpu_torch/gen, ops/grammar.py,
models/genfuzz.py) against the JAX package's, on the CPU, tolerance 0.

The compiler's tables and ``grammar_id`` equal erlamsa_tpu/gen/compile.py's
for the builtins, the reference tests' KITCHEN_SINK (every node kind,
nested) and wider grammars, and its spec errors are the JAX package's
word for word. The sequential ErlRand path (generate, fuzz_grammar) and
the keyed host twin (generate_keyed) give the JAX bytes. The torch
expander equals JAX make_expand on KITCHEN_SINK with fuzz off and on
(one JAX compile per mode, shared by the module) and the JAX keyed twin
everywhere else, truncation included. GenEngine degrades to the keyed
twin under the gen.expand chaos site byte for byte and recovers after
PROBE_EVERY expansions.
"""

import numpy as np
import pytest

from erlamsa_tpu.gen import compile as Jc
from erlamsa_tpu.gen import engine as Jeng
from erlamsa_tpu.models import genfuzz as Jg
from erlamsa_tpu.ops import grammar as Jgk
from erlamsa_tpu.ops import prng as Jprng
from erlamsa_tpu.services import chaos as Jchaos
from erlamsa_tpu.utils.erlrand import ErlRand as JRand
from erlamsa_tpu_torch.gen import compile as Tc
from erlamsa_tpu_torch.gen.engine import PROBE_EVERY, GenEngine
from erlamsa_tpu_torch.models import genfuzz as Tg
from erlamsa_tpu_torch.obs import flight as Tflight
from erlamsa_tpu_torch.ops import grammar as Tgk
from erlamsa_tpu_torch.ops import prng as Tprng
from erlamsa_tpu_torch.services import chaos as Tchaos
from erlamsa_tpu_torch.services import metrics as Tm
from erlamsa_tpu_torch.utils.erlrand import ErlRand as TRand
from test_grammar_kernels import KITCHEN_SINK

SEED = (17, 18, 19)
# grammars beyond the builtins: a panel 7808 B wide (the chip smoke's),
# sizers nested in loops in sizers, and little-endian fields
WIDE = "(loop 64 (sizer u16be (rbinary 120)))"
DEEP = ('(loop 3 (sizer u8 (loop 3 (sizer u32be (pick (rbyte) '
        '(static "ab") (range 1 3))))))')
LITTLE = '(sizer u16le (loop 5 (rbinary 7))) (sizer u32le (static "zz"))'
# draws over spans past 65536, where randint's multiplier wraps in uint32
HEAVY = ('(loop 3 (pick_pref (70000 (rbyte)) (100000 (static "x")) '
         '(3 (range 0 255))))')
GRAMMARS = {**Tc.BUILTIN_GRAMMARS, "sink": KITCHEN_SINK, "wide": WIDE,
            "deep": DEEP, "little": LITTLE, "heavy": HEAVY}
BAD_SPECS = ["", "(static", "(static 3)", "(nosuch 1)", "(range 300 400)",
             "(range 9 2)", "(sizer u24 (rbyte))", "(pick)",
             "(pick_pref (0 (rbyte)))", "(pick_pref (-2 (rbyte)))",
             "(loop 0 (rbyte))", "(rbinary -1)", "42", '(static "a\\q")',
             '(static "a\\xZZ")', '(static "unterminated', "(pick (rbyte)))",
             "(rbinary 2000)", "(block" + " (rbyte)" * 600 + ")"]


def _jkey(cg, case, slot):
    return Jgk.gen_sample_key(Jprng.base_key(SEED), cg.grammar_id, case,
                              slot)


def _tkey(cg, case, slot):
    return Tgk.gen_sample_key(Tprng.base_key(SEED), cg.grammar_id, case,
                              slot)


def _rows(panel, lens, trunc):
    """(padded row bytes, length, truncated) per sample."""
    return [(bytes(np.asarray(panel[i], np.uint8)), int(lens[i]),
             bool(trunc[i])) for i in range(len(lens))]


@pytest.fixture(scope="module")
def jax_sink():
    """JAX make_expand for KITCHEN_SINK, fuzz off and on: the module's
    only JAX compiles (one a mode)."""
    cg = Jc.compile_grammar(KITCHEN_SINK, source="sink")
    return cg, {fuzz: Jgk.make_expand(cg, fuzz=fuzz)
                for fuzz in (False, True)}


@pytest.mark.parametrize("name", sorted(GRAMMARS))
@pytest.mark.parametrize("width", [None, 24])
def test_tables_equal_jax(name, width):
    """prod, children, cweights, pool, every bound and the zlib
    grammar_id equal the JAX compiler's."""
    j = Jc.compile_grammar(GRAMMARS[name], width=width, source=name)
    t = Tc.compile_grammar(GRAMMARS[name], width=width, source=name)
    for field in ("prod", "children", "cweights", "pool"):
        a, b = getattr(j, field), getattr(t, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("root", "width", "emit", "stack", "max_steps", "max_recs",
                  "max_child", "depth", "fuzz_prob", "grammar_id", "source"):
        assert getattr(j, field) == getattr(t, field), field


@pytest.mark.parametrize("bad", BAD_SPECS, ids=[
    f"spec{i}" for i in range(len(BAD_SPECS))])
def test_spec_errors_equal_jax(bad):
    """Every DSL and bounds error is a GenSpecError with the JAX
    compiler's message."""
    with pytest.raises(Jc.GenSpecError) as je:
        Jc.compile_grammar(bad)
    with pytest.raises(Tc.GenSpecError) as te:
        Tc.compile_grammar(bad)
    assert str(te.value) == str(je.value)


def test_load_grammar_equal_jax(tmp_path):
    """Builtins, DSL files (labelled by base name) and the errors for a
    missing name and a bad file, as the JAX loader gives them."""
    good = tmp_path / "g.gf"
    good.write_text('(static "xy")\n(rbyte) ; comment\n(range 1 2)')
    bad = tmp_path / "bad.gf"
    bad.write_text("(pick)")
    for spec in ("demo-tlv", "demo-http", str(good)):
        assert Tc.load_grammar(spec) == Jc.load_grammar(spec)
    for spec in ("no-such-grammar", str(bad)):
        with pytest.raises(Jc.GenSpecError) as je:
            Jc.load_grammar(spec)
        with pytest.raises(Tc.GenSpecError) as te:
            Tc.load_grammar(spec)
        assert str(te.value) == str(je.value)


TUPLE_GRAMMAR = [
    ("static", b"HDR"), ("range", 48, 57), ("rbyte",), ("rword",),
    ("rdword",), ("rddword",), ("rbinary", 5),
    ("pick", [[("static", b"a")], [("range", 65, 70)], b"raw"]),
    ("pick_pref", [(3, [("static", b"x")]), (1, [("rbinary", 2)])]),
    ("loop", [("sizer", "u16le", [("rbinary", 3)])], 4),
    ("sizer", "u32be", ("block", [("static", b"body"),
                                  ("session_get", "k", b"dflt")])),
    ("sizer", "u8", [("loop", [("range", 1, 9)], 6)]),
]


@pytest.mark.parametrize("fuzz", [False, True])
def test_sequential_generate_equal_jax(fuzz):
    """generate / fuzz_grammar on the ErlRand stream, for seeds drawn
    with numpy, over a tuple grammar of every node kind and the DSL
    grammars: the JAX bytes, and the streams end in the same state."""
    rng = np.random.default_rng(12)
    grammars = [TUPLE_GRAMMAR] + [Tc.parse_grammar(GRAMMARS[n])
                                  for n in ("sink", "demo-tlv", "deep")]
    for g in grammars:
        assert Tg._flatten_depth(g) == Jg._flatten_depth(g)
        for _ in range(6):
            seed = tuple(int(x) for x in rng.integers(1, 30000, 3))
            jr, tr = JRand(seed), TRand(seed)
            session = {"k": b"sess"}
            for _ in range(3):
                if fuzz:
                    want = Jg.fuzz_grammar(jr, g, dict(session))
                    got = Tg.fuzz_grammar(tr, g, dict(session))
                else:
                    want = Jg.generate(jr, g, dict(session))
                    got = Tg.generate(tr, g, dict(session))
                assert got == want
            assert tr.getstate() == jr.getstate()


def test_external_generator_equal_jax():
    """make_external_generator: the genfuz slot's samples and meta."""
    g = Tc.parse_grammar(GRAMMARS["demo-http"])
    jgen = Jg.make_external_generator(g, seed=(3, 4, 5))
    tgen = Tg.make_external_generator(g, seed=(3, 4, 5))
    for _ in range(5):
        assert tgen() == jgen()


@pytest.mark.parametrize("name", ["demo-http", "demo-tlv", "demo-lines",
                                  "sink", "deep", "little", "heavy"])
@pytest.mark.parametrize("fuzz", [False, True])
def test_keyed_twin_equal_jax(name, fuzz):
    """generate_keyed (the port's: its own numpy threefry) == the JAX
    package's: full padded rows, lengths and truncation flags, at the
    default width and at 24 bytes (truncating)."""
    for width in (None, 24):
        j = Jc.compile_grammar(GRAMMARS[name], width=width)
        t = Tc.compile_grammar(GRAMMARS[name], width=width)
        for slot in range(4):
            want = Jg.generate_keyed(j, _jkey(j, 3, slot), fuzz=fuzz)
            assert Tg.generate_keyed(t, _tkey(t, 3, slot), fuzz=fuzz) == want


@pytest.mark.parametrize("fuzz", [False, True])
def test_expander_equal_jax_expander(jax_sink, fuzz):
    """The torch expander == JAX make_expand on KITCHEN_SINK (every node
    kind, nested), cases 0 and 2, 24 slots; with fuzz the loop blow-ups
    truncate some rows."""
    jcg, fns = jax_sink
    t = Tc.compile_grammar(KITCHEN_SINK, source="sink")
    expand = Tgk.make_expand(t, fuzz=fuzz)
    slots = np.arange(24)
    rows = []
    for case in (0, 2):
        want = _rows(*fns[fuzz](Jprng.base_key(SEED), case, slots))
        got = _rows(*expand(Tprng.base_key(SEED), case, slots))
        assert got == want
        assert expand.steps <= t.max_steps
        rows += got
    if fuzz:
        assert any(tr for _r, _n, tr in rows), "no row truncated"


@pytest.mark.parametrize("name,width,fuzz", [
    (name, width, fuzz)
    for name, width in (("demo-http", 24), ("demo-tlv", None),
                        ("demo-lines", 24), ("deep", None), ("little", 24),
                        ("heavy", None))
    for fuzz in (False, True)] + [("wide", None, False)])
def test_expander_equal_jax_twin(name, width, fuzz):
    """The torch expander == the JAX keyed twin, row for row, over every
    builtin and the nested, little-endian and wide grammars, truncating
    widths included (the wide grammar's fuzzed loops run every one of
    its 1352 steps: it is held fuzzed on the card instead)."""
    j = Jc.compile_grammar(GRAMMARS[name], width=width)
    t = Tc.compile_grammar(GRAMMARS[name], width=width)
    slots = [0, 1, 2, 5] if name == "wide" else list(range(8))
    got = _rows(*Tgk.make_expand(t, fuzz=fuzz)(Tprng.base_key(SEED), 1,
                                              slots))
    want = [Jg.generate_keyed(j, _jkey(j, 1, s), fuzz=fuzz) for s in slots]
    assert got == want
    if width == 24:
        assert any(tr for _r, _n, tr in got)


def test_expander_grouping_independent():
    """One batched call == per-sample calls == calls over other
    groupings: a row depends on its (case, slot) alone."""
    t = Tc.compile_grammar(GRAMMARS["demo-tlv"])
    expand = Tgk.make_expand(t, fuzz=True)
    base = Tprng.base_key(SEED)
    whole = _rows(*expand(base, 4, np.arange(10)))
    singles = [_rows(*expand(base, 4, [s]))[0] for s in range(10)]
    parts = _rows(*expand(base, 4, [7, 8, 9])) + _rows(*expand(base, 4,
                                                               [0, 1]))
    assert whole == singles
    assert parts == whole[7:] + whole[:2]


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(Tm, "GLOBAL", Tm.Counters())
    Tchaos.configure(None)
    yield
    Tchaos.configure(None)


def test_engine_equals_jax_expander(jax_sink, fresh):
    """GenEngine on the CPU: the JAX expander's payloads (rows cut to
    their lengths) and truncated counts, counted in the gen metrics and
    noted in the flight ring."""
    jcg, fns = jax_sink
    eng = GenEngine(Tc.compile_grammar(KITCHEN_SINK, source="sink"), SEED,
                    fuzz=True, device="cpu")
    panel, lens, trunc = fns[True](Jprng.base_key(SEED), 5, np.arange(12))
    payloads, ntrunc = eng.expand(5, n=12)
    assert payloads == [bytes(np.asarray(panel[i])[:int(lens[i])])
                        for i in range(12)]
    assert ntrunc == int(np.asarray(trunc).sum())
    gen = Tm.GLOBAL.snapshot()["gen"]
    assert gen["expansions"] == 12 and gen["host_fallback"] == 0
    assert gen["bytes"] == sum(map(len, payloads))
    note = [n for n in list(Tflight.GLOBAL._ring)
            if n.get("kind") == "gen_panel"][-1]
    assert note["samples"] == 12 and note["grammar"] == "sink"
    assert note["host"] is False


def test_engine_fault_degrades_byte_identically_then_recovers(fresh):
    """An injected gen.expand fault degrades the engine to the keyed twin
    with the clean engine's bytes; the PROBE_EVERY cadence re-probes the
    device and clears the degraded flag, as the JAX engine does."""
    t = Tc.compile_grammar(GRAMMARS["demo-tlv"], source="demo-tlv")
    j = Jc.compile_grammar(GRAMMARS["demo-tlv"], source="demo-tlv")
    cases = range(PROBE_EVERY + 2)
    clean = GenEngine(t, SEED, fuzz=True, device="cpu")
    want = [clean.expand(c, n=3)[0] for c in cases]
    jeng = Jeng.GenEngine(j, SEED, fuzz=True)
    Jchaos.configure("gen.expand:*", seed=5)
    try:  # the JAX engine on its keyed twin throughout: no compile
        assert [jeng.expand(c, n=3)[0] for c in cases] == want
    finally:
        Jchaos.configure(None)

    eng = GenEngine(t, SEED, fuzz=True, device="cpu")
    Tchaos.configure("gen.expand:x1", seed=5)
    degraded = []
    got = []
    for c in cases:
        got.append(eng.expand(c, n=3)[0])
        degraded.append(eng.degraded)
    assert got == want
    assert eng.host_fallbacks == 3 * PROBE_EVERY
    assert degraded == [True] * PROBE_EVERY + [False, False]
    gen = Tm.GLOBAL.snapshot()["gen"]
    assert gen["host_fallback"] == 3 * PROBE_EVERY and gen["degraded"] == 0


def test_engine_non_device_error_propagates(fresh, monkeypatch):
    """A host bug in the expander fails the expansion instead of
    degrading quietly."""
    eng = GenEngine(Tc.compile_grammar(GRAMMARS["demo-tlv"]), SEED,
                    device="cpu")

    def broken(*a):
        raise ValueError("bug")

    monkeypatch.setattr(eng, "_device_expand", broken)
    with pytest.raises(ValueError, match="bug"):
        eng.expand(0, n=2)
    assert not eng.degraded and eng.host_fallbacks == 0


def test_keyed_twin_draw_blocks():
    """The twin's draws, computed in blocks, equal the port's torch
    prng draw by draw (rand over several spans, uniform, rand_log),
    across block boundaries."""
    key = _tkey(Tc.compile_grammar(GRAMMARS["demo-tlv"]), 0, 9)
    d = Tg._KeyedDraws(key.tolist())
    for j in (0, 1, 255, 256, 257, 700):
        dk = Tprng.fold_in(key, j)
        for n in (1, 3, 256, 1000, 65536, 2**31 - 1):
            assert d.rand(j, n) == int(Tprng.rand(dk, n))
        u = float(Tprng.uniform_f32(dk))
        assert d.uniform_below(j, np.float32(u)) is False
        assert d.uniform_below(j, np.float32(np.nextafter(
            np.float32(u), np.float32(1)))) is True
        assert d.rand_log(j, 6) == int(Tprng.rand_log(dk, 6))
    assert d.bytes(250, 12) == bytes(
        int(Tprng.rand(Tprng.fold_in(key, 250 + t), 256)) for t in range(12))
