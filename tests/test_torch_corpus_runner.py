"""The port's feedback runner (erlamsa_tpu_torch/corpus/runner.py,
``--feedback --corpus DIR``) against the JAX package's, end to end on the
CPU.

tests/test_arena.py's mixed-length corpus over two capacity classes (256
and 1024 B), batch 8, 3 cases, seed (4, 5, 6), the default mutator set in
the default stream. The JAX runner's buckets/async run is the reference,
made once: the port's run in every pipeline and layout writes its files,
draws its schedules and leaves its store energies; so does a port run
stopped after case 1 and resumed from --state, and the port resuming the
JAX package's own checkpoint and store. An injected device.step fault
degrades both packages at the same case and recovers them at the same
probe, with the same files and events.
"""

import os
import shutil

import numpy as np
import pytest

from erlamsa_tpu.corpus.feedback import FeedbackBus as JBus
from erlamsa_tpu.corpus.runner import run_corpus_batch as jax_run
from erlamsa_tpu.services import chaos as Jchaos
from erlamsa_tpu.services import metrics as Jm
from erlamsa_tpu_torch.corpus.feedback import FeedbackBus as TBus
from erlamsa_tpu_torch.corpus.runner import run_corpus_batch as port_run
from erlamsa_tpu_torch.corpus.store import CorpusStore
from erlamsa_tpu_torch.services import chaos as Tchaos
from erlamsa_tpu_torch.services import metrics as Tm
from test_arena import _TWO_CLASS_SEEDS
from torch_harness import batch_env

SEED = (4, 5, 6)
BATCH, CASES = 8, 3


@pytest.fixture
def env(monkeypatch):
    batch_env(monkeypatch, None)
    monkeypatch.setattr(Jm, "GLOBAL", Jm.Counters())
    monkeypatch.setattr(Tm, "GLOBAL", Tm.Counters())


def run(pkg, root, tag, n=CASES, chaos_spec=None, rc_want=0, **extra):
    """One feedback run of ``pkg`` ("jax" or "port") with its store and
    files under root/tag, which must return ``rc_want``; returns (stats,
    files, store energies)."""
    outdir = os.path.join(root, tag)
    os.makedirs(outdir, exist_ok=True)
    stats = {}
    opts = {"corpus_dir": os.path.join(root, tag + "-store"),
            "corpus": _TWO_CLASS_SEEDS, "feedback": True,
            "feedback_bus": (JBus if pkg == "jax" else TBus)(),
            "seed": SEED, "n": n, "_stats": stats, "pipeline": "async",
            "layout": "buckets",
            "output": os.path.join(outdir, "out-%n.bin")}
    opts.update(extra)
    chaos = Jchaos if pkg == "jax" else Tchaos
    chaos.configure(chaos_spec, seed=13)
    try:
        rc = (jax_run(opts, batch=BATCH) if pkg == "jax"
              else port_run(opts, batch=BATCH, device="cpu"))
    finally:
        chaos.configure(None)
    assert rc == rc_want
    files = [open(os.path.join(outdir, f"out-{i}.bin"), "rb").read()
             for i in range(n * BATCH)]
    return stats, files, CorpusStore(opts["corpus_dir"]).energies()


_REF = {}


@pytest.fixture
def reference(env, tmp_path_factory):
    """The JAX package's buckets/async run, made once."""
    if not _REF:
        root = str(tmp_path_factory.mktemp("corpus_ref"))
        _REF["run"] = run("jax", root, "ref")
    return _REF["run"]


def test_buckets_async_equals_jax(tmp_path, reference):
    """Files, schedules, novelty, step shapes, bucket stats, bytes
    uploaded and the final store energies equal the JAX package's."""
    st_j, files_j, en_j = reference
    st, files, en = run("port", str(tmp_path), "p")
    assert files == files_j
    assert sum(f not in _TWO_CLASS_SEEDS for f in files) > 0
    for key in ("schedules", "new_hashes", "step_shapes", "buckets",
                "bytes_uploaded", "offspring", "total"):
        assert st[key] == st_j[key], key
    assert [w for _, w, _ in st["step_shapes"]] == [256, 1024]
    assert en == en_j


@pytest.mark.parametrize("pipeline,layout", [("sync", "buckets"),
                                             ("async", "arena"),
                                             ("sync", "arena")])
def test_pipelines_and_layouts_equal_jax(tmp_path, reference, pipeline,
                                         layout):
    """sync == async and arena == buckets: the JAX reference's files,
    schedules and energies; the arena pages each seed in once at its
    bucket width, so it wastes no padding and uploads less."""
    st_j, files_j, en_j = reference
    st, files, en = run("port", str(tmp_path), "p", pipeline=pipeline,
                        layout=layout)
    assert files == files_j
    assert st["schedules"] == st_j["schedules"]
    assert st["new_hashes"] == st_j["new_hashes"]
    assert en == en_j
    assert st["pipeline"] == pipeline and st["layout"] == layout
    if layout == "arena":
        assert st["step_shapes"] == st_j["step_shapes"]
        assert all(b["padded_bytes_wasted"] == 0
                   for b in st["buckets"].values())
        assert st["bytes_uploaded"] < st_j["bytes_uploaded"]
        assert st["arena"]["uploads"] == 1 and st["arena"]["spills"] == 0
        assert set(st["arena"]["classes"]) == {"256", "1024"}


def test_arena_stats_equal_jax(tmp_path, env):
    """The arena's stats() dict after a whole run equals the JAX
    package's, and so do the bytes uploaded."""
    st_j, files_j, _ = run("jax", str(tmp_path), "j", layout="arena")
    st, files, _ = run("port", str(tmp_path), "p", layout="arena")
    assert files == files_j
    assert st["arena"] == st_j["arena"]
    assert st["bytes_uploaded"] == st_j["bytes_uploaded"]


@pytest.mark.parametrize("layout", ["buckets", "arena"])
def test_resumed_run_equals_straight_jax(tmp_path, reference, layout):
    """A port run (async) stopped after case 1 and resumed from --state
    writes the straight run's files and ends with its energies: the
    checkpoint of case 1 holds case 1's scores, though case 2 was being
    launched while it was saved."""
    _st_j, files_j, en_j = reference
    state = str(tmp_path / "run.npz")
    run("port", str(tmp_path), "p", n=1, state_path=state, layout=layout)
    st, files, en = run("port", str(tmp_path), "p", state_path=state,
                        layout=layout)
    assert files == files_j
    assert len(st["schedules"]) == CASES - 1
    assert en == en_j


def test_port_resumes_jax_checkpoint_and_store(tmp_path, reference):
    """The JAX package's checkpoint and store after case 1, resumed by the
    port, give the straight JAX run's files and energies."""
    _st_j, files_j, en_j = reference
    root = str(tmp_path)
    state = os.path.join(root, "run.npz")
    run("jax", root, "j", n=1, state_path=state)
    shutil.copytree(os.path.join(root, "j-store"), os.path.join(root,
                                                                "p-store"))
    shutil.copytree(os.path.join(root, "j"), os.path.join(root, "p"))
    st, files, en = run("port", root, "p", state_path=state)
    assert files == files_j
    assert len(st["schedules"]) == CASES - 1
    assert en == en_j


def test_device_fault_degrades_and_recovers_like_jax(tmp_path, env):
    """device.step:x1 fails case 0's first dispatch in both packages: the
    host oracle serves cases 0-3, the probe at case 4 recovers the device
    path. Files, schedules, events and the degraded flag agree."""
    n = 6
    st_j, files_j, en_j = run("jax", str(tmp_path), "j", n=n,
                              chaos_spec="device.step:x1")
    st, files, en = run("port", str(tmp_path), "p", n=n,
                        chaos_spec="device.step:x1")
    assert files == files_j
    assert st["schedules"] == st_j["schedules"]
    assert en == en_j
    res_j = Jm.GLOBAL.snapshot()["resilience"]
    res = Tm.GLOBAL.snapshot()["resilience"]
    for key in ("device_lost", "device_recovered"):
        assert res["events"].get(key) == res_j["events"].get(key) == 1
    assert res["degraded"] == res_j["degraded"] == 0
    assert (Tm.GLOBAL.snapshot()["host_routed"]
            == Jm.GLOBAL.snapshot()["host_routed"])
    # cases 4 and 5 ran on the device again
    assert st["total"] == n * BATCH
    assert sum(b["rows"] for b in st["buckets"].values()) == 2 * BATCH
    assert np.sum([b["rows"] for b in st_j["buckets"].values()]) == 2 * BATCH


def test_device_never_recovered_fails_the_run(tmp_path, env):
    """device.step:* keeps every dispatch and probe failing, as the sticky
    CUDA error of a faulty kernel would. Both packages serve every case
    from the host oracle and write the same files; the JAX runner
    returns 0, the port's returns EXIT_DEGRADED, so a kernel fault does
    not pass for a quiet fallback."""
    from erlamsa_tpu_torch.corpus.runner import EXIT_DEGRADED

    n = 2
    st_j, files_j, en_j = run("jax", str(tmp_path), "j", n=n,
                              chaos_spec="device.step:*")
    st, files, en = run("port", str(tmp_path), "p", n=n,
                        chaos_spec="device.step:*", rc_want=EXIT_DEGRADED)
    assert EXIT_DEGRADED != 0
    assert files == files_j and en == en_j
    assert Tm.GLOBAL.snapshot()["resilience"]["degraded"] == 1
    assert not st["buckets"]  # no case ran on the device


#: one-to-three-byte seeds whose outputs repeat across cases: at seed
#: (4, 5, 6), batch 8, an output hash of case 0 recurs after case 1
DUP_SEEDS = [b"a", b"b", b"ab", b"xxx"]


def test_resume_keeps_seen_hashes(tmp_path, env):
    """A run stopped after case 1 and resumed must judge novelty as the
    uninterrupted run did. The JAX runner's checkpoint holds no seen
    hashes, so its resumed run counts a recurring hash as new again and
    departs from its straight run; the port's checkpoint carries them
    (the `seen` field), so its resumed run writes the straight run's
    files."""
    root = str(tmp_path)
    _st, straight, _en = run("jax", root, "j", corpus=DUP_SEEDS)
    for pkg in ("jax", "port"):
        state = os.path.join(root, pkg + ".npz")
        run(pkg, root, pkg + "-r", n=1, corpus=DUP_SEEDS, state_path=state)
        _st, files, _en = run(pkg, root, pkg + "-r", corpus=DUP_SEEDS,
                              state_path=state)
        if pkg == "jax":
            assert files != straight  # the reference's fault, kept there
        else:
            assert files == straight


# --- coverage feedback and distillation (--coverage --distill) -----------

#: connect-back frames of the coverage triangle, one per (case, slot):
#: a few slots light new edges, the rest send an empty map or repeat an
#: earlier one (a stand-in for an instrumented target)
def _coverage_frames(map_bytes, cases=CASES, batch=BATCH, seed=7):
    rng = np.random.default_rng(seed)
    sent, frames = [], []
    for case in range(cases):
        for slot in range(batch):
            kind = rng.integers(0, 4)
            if kind == 0 or not sent:
                m = np.zeros(map_bytes, np.uint8)
                lit = rng.integers(0, map_bytes, rng.integers(1, 6))
                m[lit] = rng.integers(1, 256, lit.size, dtype=np.uint8)
                blob = m.tobytes()
            elif kind == 1:
                blob = sent[rng.integers(0, len(sent))]
            else:
                blob = bytes(map_bytes)
            sent.append(blob)
            frames.append((case, slot, blob))
    return frames


def _loaded_hub(pkg, frames, chaos_spec=None):
    """``pkg``'s CoverageHub with every frame of ``frames`` buffered (or,
    under ``chaos_spec``, the hub dead of its ingest faults), sent over
    the loopback with ``pkg``'s frame codec."""
    import socket
    import time
    import zlib

    if pkg == "jax":
        from erlamsa_tpu.services.dist import _pack_frame
        from erlamsa_tpu.services.monitors import CoverageHub
    else:
        from erlamsa_tpu_torch.services.dist import _pack_frame
        from erlamsa_tpu_torch.services.monitors import CoverageHub
    chaos = Jchaos if pkg == "jax" else Tchaos
    chaos.configure(chaos_spec, seed=13)
    hub = CoverageHub(port=0).start()
    try:
        with socket.create_connection((hub.host, hub.port), timeout=5) as s:
            for case, slot, blob in frames:
                s.sendall(_pack_frame({"op": "cov", "case": case,
                                       "slot": slot, "epoch": 0,
                                       "crc": zlib.crc32(blob)}, blob))
        t0 = time.monotonic()
        while (hub.alive() if chaos_spec
               else hub.pending_frames() < len(frames)):
            assert time.monotonic() - t0 < 15, hub.stats()
            time.sleep(0.01)
    finally:
        chaos.configure(None)
    return hub


def _retired(root, tag):
    d = os.path.join(root, tag + "-store", "retired")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_coverage_distill_equals_jax(tmp_path, reference, capfd):
    """--coverage --distill --adopt with the same pre-buffered frames: the
    port's runner, in both pipelines and both layouts, writes the JAX
    runner's files, stats["coverage"] (the hub's frame counts included),
    offspring and `# distill:` line, and retires the same seeds; the
    gate changed the campaign."""
    root = str(tmp_path)
    _st_ref, files_ref, _en = reference
    frames = _coverage_frames(1024)
    got = {}
    for pkg, pipeline, layout in (("jax", "async", "buckets"),
                                  ("port", "async", "buckets"),
                                  ("port", "sync", "buckets"),
                                  ("port", "async", "arena"),
                                  ("port", "sync", "arena")):
        tag = f"{pkg}-{pipeline}-{layout}"
        hub = _loaded_hub(pkg, frames)
        try:
            capfd.readouterr()
            st, files, en = run(pkg, root, tag, adopt=True, coverage=True,
                                coverage_hub=hub, distill=True,
                                pipeline=pipeline, layout=layout)
            said = [ln for ln in capfd.readouterr().err.splitlines()
                    if ln.startswith("# distill:")]
        finally:
            hub.stop()
            hub.join(timeout=10)
        got[tag] = (st, files, en, said, _retired(root, tag))
    st_j, files_j, en_j, said_j, ret_j = got.pop("jax-async-buckets")
    for tag, (st, files, en, said, ret) in got.items():
        assert files == files_j and en == en_j, tag
        assert st["coverage"] == st_j["coverage"], tag
        assert st["offspring"] == st_j["offspring"], tag
        assert st["schedules"] == st_j["schedules"], tag
        assert said == said_j and len(said) == 1, tag
        assert ret == ret_j and ret, tag
    cov = st_j["coverage"]
    assert cov["folds"] == CASES and cov["maps"] == CASES * BATCH
    assert cov["new_edges"] > 0 and not cov["degraded"]
    assert cov["distilled"] == len(ret_j)
    assert files_j != files_ref


def test_coverage_hub_death_equals_hash_novelty(tmp_path, env):
    """A hub killed by monitor.ingest faults before the run: the port's
    --coverage run degrades (stickily) and writes the hash-novelty
    baseline's files and energies; a --coverage run with no hub wired in
    is the baseline too."""
    root = str(tmp_path)
    st_a, files_a, en_a = run("port", root, "base", adopt=True)
    hub = _loaded_hub("port", _coverage_frames(1024)[:6],
                      chaos_spec="monitor.ingest:*")
    try:
        assert not hub.alive() and hub.stats()["faulted"] >= 4
        st_c, files_c, en_c = run("port", root, "deg", adopt=True,
                                  coverage=True, coverage_hub=hub)
    finally:
        hub.stop()
        hub.join(timeout=10)
    assert files_c == files_a and en_c == en_a
    assert st_c["offspring"] == st_a["offspring"]
    assert st_c["coverage"]["degraded"] and st_c["coverage"]["folds"] == 0
    assert Tm.GLOBAL.snapshot()["resilience"]["events"]["coverage_lost"] == 1
    _st, files_n, _en = run("port", root, "nohub", adopt=True, coverage=True)
    assert files_n == files_a


def test_gen_seeded_campaign_equals_jax(tmp_path, reference):
    """``--gen demo-tlv:16`` seeding a feedback campaign beside the
    two-class seeds: the JAX runner's ``# gen:`` line, store (ids, bytes,
    origin), stats["gen"], files and energies. The JAX runner expands on
    its jitted expander, the port's on its torch expander on the CPU."""
    from erlamsa_tpu.gen.compile import BUILTIN_GRAMMARS

    gen = {"grammar": BUILTIN_GRAMMARS["demo-tlv"], "label": "demo-tlv",
           "n": 16}
    got = {}
    for pkg in ("jax", "port"):
        st, files, en = run(pkg, str(tmp_path), pkg, n=1, gen=dict(gen))
        store = CorpusStore(str(tmp_path / f"{pkg}-store"))
        seeds = {sid: (store.get(sid), store.meta(sid)["origin"])
                 for sid in store.ids()}
        got[pkg] = (st["gen"], files, en, seeds)
    assert got["port"] == got["jax"]
    gen_stats, _files, _en, seeds = got["port"]
    assert gen_stats == {"grammar": "demo-tlv",
                         "grammar_id": gen_stats["grammar_id"],
                         "generated": 16, "host_fallback": 0,
                         "degraded": False}
    assert sum(origin == "gen" for _b, origin in seeds.values()) > 0
