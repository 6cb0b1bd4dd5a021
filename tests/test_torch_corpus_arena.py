"""The port's feedback runner with offspring adoption, arena spills, the
struct overlay and its CLI, against the JAX package on the CPU.

The corpora are tests/test_arena.py's one-class seeds (six lengths, all
in the 256 class) and tests/test_struct_kernels.py's documents (also
256), so the file shares one JAX compile. --adopt: the JAX runner's
buckets layout is the reference (made once);
the port's arena (offspring scattered on the device from the step's
output) and buckets layouts write its files and grow its store, seed for
seed. Injected arena.spill faults move seeds to the host overlay without
changing a byte. --struct device over tests/test_struct_kernels.py's
documents writes the JAX runner's files in both layouts, and --struct
host does too. ``python -m erlamsa_tpu_torch --feedback --corpus DIR
--layout arena`` writes the JAX CLI's files.
"""

import os

import pytest

from erlamsa_tpu.services import cli as Jcli
from erlamsa_tpu.services import metrics as Jm
from erlamsa_tpu_torch.corpus.store import CorpusStore
from erlamsa_tpu_torch.services import cli as Tcli
from erlamsa_tpu_torch.services import metrics as Tm
from test_arena import _ONE_CLASS_SEEDS
from test_struct_kernels import B64_DOC, JSON_DOC, PLAIN, SGML_DOC, URI_DOC
from test_torch_corpus_runner import run
from torch_harness import batch_env, read_outputs

STRUCT_SEEDS = [JSON_DOC, SGML_DOC, B64_DOC, URI_DOC, PLAIN]
SEEDS = {"corpus": _ONE_CLASS_SEEDS}


@pytest.fixture
def env(monkeypatch):
    batch_env(monkeypatch, None)
    monkeypatch.setattr(Jm, "GLOBAL", Jm.Counters())
    monkeypatch.setattr(Tm, "GLOBAL", Tm.Counters())


_REF = {}


def _reference(key, tmp_path_factory, **extra):
    """One JAX run per key, made once for the file."""
    if key not in _REF:
        root = str(tmp_path_factory.mktemp("ref_" + key))
        st, files, _en = run("jax", root, "ref", **dict(SEEDS, **extra))
        _REF[key] = (st, files, CorpusStore(os.path.join(root, "ref-store")))
    return _REF[key]


@pytest.fixture
def adopt_ref(env, tmp_path_factory):
    return _reference("adopt", tmp_path_factory, adopt=True)


@pytest.mark.parametrize("layout", ["arena", "buckets"])
def test_adopt_equals_jax_buckets_adopt(tmp_path, adopt_ref, layout):
    """Offspring adoption grows the JAX package's store (the same seed
    ids in the same order) and writes its files; in the arena every
    offspring after the seeding is scattered on the device, so one
    upload chunk ever crossed to the device."""
    st_j, files_j, store_j = adopt_ref
    st, files, _en = run("port", str(tmp_path), "p", adopt=True,
                         layout=layout, **SEEDS)
    store = CorpusStore(str(tmp_path / "p-store"))
    assert files == files_j
    assert st["offspring"] == st_j["offspring"] > 0
    assert store.ids() == store_j.ids()
    assert store.energies() == store_j.energies()
    if layout == "arena":
        ar = st["arena"]
        assert ar["adopted"] > 0 and ar["adopt_faults"] == 0
        assert ar["uploads"] == 1


def test_adopt_arena_stats_equal_jax(tmp_path, env):
    """The arena's counters with --adopt (adopted, adopt_skips, the
    per-class blocks) equal the JAX arena's on the same run."""
    st_j, files_j, _ = run("jax", str(tmp_path), "j", adopt=True,
                           layout="arena", **SEEDS)
    st, files, _ = run("port", str(tmp_path), "p", adopt=True,
                       layout="arena", **SEEDS)
    assert files == files_j
    assert st["arena"] == st_j["arena"]


def test_spill_faults_leave_files_unchanged(tmp_path, env,
                                            tmp_path_factory):
    """arena.spill:x4 sends four seeds to the host overlay: the files
    equal the JAX package's buckets run, and the arena counts the four
    spills as the JAX arena does."""
    _st_b, files_b, _s = _reference("plain", tmp_path_factory)
    st, files, _en = run("port", str(tmp_path), "p", layout="arena",
                         chaos_spec="arena.spill:x4", **SEEDS)
    st_j, files_j, _en = run("jax", str(tmp_path), "j", layout="arena",
                             chaos_spec="arena.spill:x4", **SEEDS)
    assert files == files_b == files_j
    assert st["arena"]["spills"] == st_j["arena"]["spills"] == 4
    assert st["bytes_uploaded"] == st_j["bytes_uploaded"]


@pytest.fixture
def struct_ref(env, tmp_path_factory):
    return _reference("struct", tmp_path_factory, struct="device",
                      corpus=STRUCT_SEEDS)


@pytest.mark.parametrize("mode,layout", [("device", "buckets"),
                                         ("device", "arena"),
                                         ("host", "buckets")])
def test_struct_overlay_equals_jax(tmp_path, struct_ref, mode, layout):
    """--feedback --struct device|host writes the JAX package's files with
    --struct device; the routed rows are counted alike, and the device
    mode counts the reference's upload bytes (the host mode uploads no
    struct panel)."""
    st_j, files_j, _s = struct_ref
    st, files, _en = run("port", str(tmp_path), "p", corpus=STRUCT_SEEDS,
                         struct=mode, layout=layout)
    assert files == files_j
    assert st["struct_routed"] == st_j["struct_routed"] > 0
    assert st["struct"] == mode
    if (mode, layout) == ("device", "buckets"):
        assert st["bytes_uploaded"] == st_j["bytes_uploaded"]


def test_cli_equals_jax_cli(tmp_path, env, monkeypatch):
    """python -m erlamsa_tpu_torch --feedback --corpus DIR --layout arena
    writes the files of python -m erlamsa_tpu --feedback --corpus DIR
    --layout arena over the same seed files."""
    monkeypatch.chdir(tmp_path)  # the JAX CLI writes ./last_seed.txt
    seed_files = []
    for i, s in enumerate(_ONE_CLASS_SEEDS):
        p = tmp_path / f"seed-{i}"
        p.write_bytes(s)
        seed_files.append(str(p))
    common = ["--feedback", "--layout", "arena", "-s", "4,5,6", "-n", "2",
              "--batch", "8"]
    assert Jcli.main(common + ["--corpus", str(tmp_path / "js"), "-o",
                               str(tmp_path / "j-%n")] + seed_files) == 0
    assert Tcli.main(common + ["--corpus", str(tmp_path / "ts"), "-o",
                               str(tmp_path / "t-%n"), "--device", "cpu"]
                     + seed_files) == 0
    ref = read_outputs(str(tmp_path), "j-")
    got = read_outputs(str(tmp_path), "t-")
    assert len(ref) == 16
    assert list(got.values()) == list(ref.values())
    assert (CorpusStore(str(tmp_path / "ts")).ids()
            == CorpusStore(str(tmp_path / "js")).ids())


def test_cli_feedback_requires_corpus(capsys):
    with pytest.raises(SystemExit) as e:
        Tcli.main(["--feedback", "--device", "cpu"])
    assert str(e.value) == "erlamsa-tpu: --feedback requires --corpus DIR"


def test_not_ported_options_raise(tmp_path):
    from erlamsa_tpu_torch.corpus.runner import run_corpus_batch

    for key in ("shards", "fleet_nodes", "spmd"):
        with pytest.raises(ValueError, match="not yet ported"):
            run_corpus_batch({"corpus_dir": str(tmp_path), key: 2},
                             batch=8, device="cpu")
