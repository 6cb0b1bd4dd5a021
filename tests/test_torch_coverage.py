"""The port's coverage plane against the JAX package's, on the CPU,
tolerance 0: ops/coverage.py's torch functions against erlamsa_tpu/ops/
coverage.py's and both packages' numpy twins (int32 gains, uint8 maps,
bit for bit), corpus/distill.py's CoverageIndex and greedy set-cover,
the checkpoint's coverage fields across the packages, the frame codec
and the CoverageHub's frame dispositions, torn streams and breaker death
(as tests/test_coverage.py holds the JAX package's)."""

import os
import socket
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from erlamsa_tpu.corpus import distill as Jdistill
from erlamsa_tpu.ops import coverage as Jcov
from erlamsa_tpu.services import dist as Jdist
from erlamsa_tpu.services import monitors as Jmon
from erlamsa_tpu_torch.corpus import distill as Tdistill
from erlamsa_tpu_torch.corpus.store import CorpusStore
from erlamsa_tpu_torch.ops import coverage as Tcov
from erlamsa_tpu_torch.services import chaos as Tchaos
from erlamsa_tpu_torch.services import dist as Tdist
from erlamsa_tpu_torch.services import monitors as Tmon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(pred, timeout=15.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.01)
    return True


def _maps(rng, n, width, density):
    """uint8[n, width] maps whose bits are set with probability
    ``density`` (0, 1/256, 1/2 or 1)."""
    bits = rng.random((n, width * 8)) < density
    return np.packbits(bits, axis=-1)


# ---- ops/coverage: torch == JAX == numpy ---------------------------------

@pytest.mark.parametrize("n,width", [(1, 16), (2, 64), (7, 128), (33, 1024)])
@pytest.mark.parametrize("density", [0.0, 1 / 256, 0.5, 1.0])
def test_coverage_ops_equal_jax_and_numpy(n, width, density):
    rng = np.random.default_rng(n * 1000 + width + int(density * 256))
    maps = _maps(rng, n, width, density)
    acc = _maps(rng, 1, width, density / 2)[0]
    pc = Tcov.popcount(torch.from_numpy(maps))
    assert pc.dtype == torch.int32
    np.testing.assert_array_equal(pc.numpy(), np.asarray(Jcov.popcount(maps)))
    np.testing.assert_array_equal(pc.numpy(), Tcov.popcount_np(maps))
    fold = Tcov.fold_maps(torch.from_numpy(acc), torch.from_numpy(maps))
    assert fold.dtype == torch.uint8
    np.testing.assert_array_equal(fold.numpy(),
                                  np.asarray(Jcov.fold_maps(acc, maps)))
    np.testing.assert_array_equal(fold.numpy(), Tcov.fold_maps_np(acc, maps))
    g, a = Tcov.batch_gains(torch.from_numpy(acc), torch.from_numpy(maps))
    assert g.dtype == torch.int32 and a.dtype == torch.uint8
    gj, aj = Jcov.batch_gains(acc, maps)
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(a.numpy(), np.asarray(aj))
    gn, an = Tcov.batch_gains_np(acc, maps)
    np.testing.assert_array_equal(g.numpy(), gn)
    np.testing.assert_array_equal(a.numpy(), an)
    for ours, theirs in ((Tcov.batch_gains_np(acc, maps),
                          Jcov.batch_gains_np(acc, maps)),):
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(Tcov.popcount_np(maps),
                                  Jcov.popcount_np(maps))


def test_batch_gains_sequential_semantics():
    """A map that only repeats a lower slot's edges gains zero; the
    accumulated edges never count again."""
    m = np.zeros(8, np.uint8)
    m[0] = 0xF0
    g, a = Tcov.batch_gains(torch.zeros(8, dtype=torch.uint8),
                            torch.from_numpy(np.stack([m, m, m])))
    assert g.tolist() == [4, 0, 0]
    g2, _ = Tcov.batch_gains(a, torch.from_numpy(m[None]))
    assert g2.tolist() == [0]
    # no maps: nothing gained, the accumulator unchanged
    g0, a0 = Tcov.batch_gains(a, torch.zeros((0, 8), dtype=torch.uint8))
    assert g0.shape == (0,) and torch.equal(a0, a)
    assert torch.equal(Tcov.fold_maps(a, torch.zeros((0, 8),
                                                     dtype=torch.uint8)), a)


# ---- CoverageIndex --------------------------------------------------------

def test_coverage_index_equals_jax():
    """The port's index folding on the device path (the CPU here) and on
    the host path gives the JAX index's gains, maps and per-seed
    tensor."""
    rng = np.random.default_rng(5)
    pairs = [(f"s{i % 3}", rng.integers(0, 256, 16, dtype=np.uint8)
              .tobytes()) for i in range(6)]
    jax_idx = Jdistill.CoverageIndex(map_bytes=16, use_device=True)
    host = Tdistill.CoverageIndex(map_bytes=16, use_device=False)
    dev = Tdistill.CoverageIndex(map_bytes=16, use_device=True,
                                 device="cpu")
    for chunk in (pairs[:3], pairs[3:], []):
        want = jax_idx.fold_case(list(chunk))
        assert host.fold_case(list(chunk)) == want
        assert dev.fold_case(list(chunk)) == want
    for idx in (host, dev):
        np.testing.assert_array_equal(idx.global_map, jax_idx.global_map)
        assert idx.edges() == jax_idx.edges() and idx.folds == 2
        assert list(idx.per_seed) == list(jax_idx.per_seed)
        for sid in idx.per_seed:
            np.testing.assert_array_equal(idx.per_seed[sid],
                                          jax_idx.per_seed[sid])
    other = Tdistill.CoverageIndex(map_bytes=16)
    other.restore(dev.snapshot())
    assert list(other.per_seed) == ["s0", "s1", "s2"]
    assert other.edges() == dev.edges()
    with pytest.raises(ValueError):
        dev.fold_case([("x", bytes(4))])


def test_fold_case_chaos_fault_raises_oserror():
    idx = Tdistill.CoverageIndex(map_bytes=8, use_device=True, device="cpu")
    Tchaos.configure("coverage.fold:x1", seed=2)
    try:
        with pytest.raises(OSError):
            idx.fold_case([("a", bytes(8))])
        assert idx.fold_case([("a", b"\xff" + bytes(7))]) == [8]
    finally:
        Tchaos.configure(None)


def test_device_index_defaults_to_the_card():
    """use_device without a device folds on cuda, and so refuses where
    there is no card rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    idx = Tdistill.CoverageIndex(map_bytes=8, use_device=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        idx.fold_case([("a", bytes(8))])


# ---- greedy set-cover distillation ---------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_greedy_minimize_equals_jax(seed):
    """Random tensors drawn from a small pool of rows (so gains tie and
    rows repeat), with empty rows and subsets: the lazy greedy keeps and
    retires what the JAX function does."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n, width = int(rng.integers(1, 60)), int(rng.integers(1, 9))
        pool = _maps(rng, max(1, n // 3), width,
                     float(rng.choice([0.05, 0.2, 0.6])))
        maps = pool[rng.integers(0, len(pool), n)]
        for i in range(n):
            pick = rng.integers(0, 4)
            if pick == 0:
                maps[i] = 0  # no evidence: never retired
            elif pick == 1:
                maps[i] &= _maps(rng, 1, width, 0.5)[0]  # a subset
        ids = [f"seed{i}" for i in range(n)]
        assert (Tdistill.greedy_minimize(ids, maps)
                == Jdistill.greedy_minimize(ids, maps))


def test_greedy_minimize_edges():
    assert Tdistill.greedy_minimize([], np.zeros((0, 8), np.uint8)) == ([],
                                                                       [])
    with pytest.raises(ValueError):
        Tdistill.greedy_minimize(["a"], np.zeros((2, 8), np.uint8))
    maps = np.zeros((3, 4), np.uint8)
    maps[0] = (255, 255, 0, 0)
    maps[1] = (255, 0, 0, 0)
    maps[2] = (15, 15, 0, 0)
    assert Tdistill.greedy_minimize(["big", "s1", "s2"], maps) == (
        ["big"], ["s1", "s2"])
    maps = np.tile(np.asarray([1, 2, 3, 4], np.uint8), (2, 1))
    assert Tdistill.greedy_minimize(["first", "second"], maps) == (
        ["first"], ["second"])


def test_store_retire_removes_seed(tmp_path):
    store = CorpusStore(str(tmp_path / "c"))
    sid, _ = store.add(b"retire me", origin="direct")
    keep_id, _ = store.add(b"keeper", origin="direct")
    assert store.retire(sid) and not store.retire(sid)
    reopened = CorpusStore(str(tmp_path / "c"))
    assert sid not in reopened.ids() and keep_id in reopened.ids()
    assert os.listdir(tmp_path / "c" / "retired") == [sid]
    # retire_many: one save for many ids, the stores one-by-one retires
    # leave
    seeds = [b"seed %d" % i for i in range(6)]
    stores = [CorpusStore(str(tmp_path / name)) for name in ("a", "b")]
    for st in stores:
        for s in seeds:
            st.add(s, origin="direct")
    gone, kept = stores[0].ids()[1::2], stores[0].ids()[::2]
    assert [stores[0].retire(x) for x in gone + ["nope"]] == [True] * 3 + [
        False]
    assert stores[1].retire_many(gone + ["nope"]) == 3
    a, b = (CorpusStore(str(tmp_path / name)) for name in ("a", "b"))
    assert a.ids() == b.ids() == kept
    assert (sorted(os.listdir(tmp_path / "a" / "retired"))
            == sorted(os.listdir(tmp_path / "b" / "retired")) == sorted(gone))


# ---- checkpointed coverage maps across the packages ----------------------

def test_checkpoint_coverage_roundtrip_across_packages(tmp_path):
    """A coverage snapshot saved by either package loads in both; an
    empty one round-trips, a file without coverage is absent, another
    width is a mismatch."""
    from erlamsa_tpu.services import checkpoint as Jck
    from erlamsa_tpu_torch.services import checkpoint as Tck

    idx = Tdistill.CoverageIndex(map_bytes=32)
    idx.fold_case([("s1", b"\x07" + bytes(31)), ("s2", bytes(32))])
    scores = np.zeros((4, 3), np.int32)
    for tag, save in (("port", Tck.save_state), ("jax", Jck.save_state)):
        path = str(tmp_path / f"{tag}.npz")
        save(path, (1, 2, 3), 1, scores, coverage=idx.snapshot())
        for load in (Tck.load_coverage_maps, Jck.load_coverage_maps):
            verdict, snap = load(path, 32)
            assert verdict == "ok"
            back = Tdistill.CoverageIndex(map_bytes=32)
            back.restore(snap)
            assert list(back.per_seed) == ["s1", "s2"]
            np.testing.assert_array_equal(back.global_map, idx.global_map)
            assert back.edges() == 3
            assert load(path, 64) == ("mismatch", None)
    p_empty = str(tmp_path / "empty.npz")
    Tck.save_state(p_empty, (1, 2, 3), 1, scores,
                   coverage=Tdistill.CoverageIndex(map_bytes=32).snapshot())
    verdict, snap = Jck.load_coverage_maps(p_empty, 32)
    assert verdict == "ok" and snap["ids"] == []
    p_old = str(tmp_path / "old.npz")
    Tck.save_state(p_old, (1, 2, 3), 1, scores)
    assert Jck.load_coverage_maps(p_old, 32) == ("absent", None)
    assert Tck.load_coverage_maps(p_old, 32) == ("absent", None)


# ---- the frame codec and the CoverageHub ---------------------------------

def _frame(case, slot, blob, epoch=0, crc=None, op="cov"):
    return Tdist._pack_frame({"op": op, "case": case, "slot": slot,
                              "epoch": epoch,
                              "crc": zlib.crc32(blob) if crc is None
                              else crc}, blob)


def test_frame_codec_equals_jax():
    import io

    header = {"op": "cov", "case": 3, "slot": 9, "epoch": 0, "crc": 7}
    for blob in (b"", bytes(range(256)) * 4):
        packed = Tdist._pack_frame(header, blob)
        assert packed == Jdist._pack_frame(header, blob)
        f = io.BufferedReader(io.BytesIO(packed + packed[:3]))
        assert Tdist._read_frame(f) == (header, blob)
        with pytest.raises(ValueError):
            Tdist._read_frame(f)  # a torn second frame
    assert Tdist._read_frame(io.BufferedReader(io.BytesIO(b""))) is None
    with pytest.raises(ValueError):
        Tdist._read_frame(io.BufferedReader(io.BytesIO(b"not a frame at")))


def test_coverage_hub_frame_dispositions():
    """ok, stale epoch, bad crc, bad width and a wrong op: the JAX hub's
    counts; take() pops a case once."""
    good = bytes(31) + b"\x01"
    frames = [_frame(0, 0, good), _frame(0, 1, good, epoch=5),
              _frame(0, 2, good, crc=123), _frame(0, 3, bytes(8)),
              _frame(0, 4, good, op="bogus")]
    got = {}
    for name, mod in (("port", Tmon), ("jax", Jmon)):
        hub = mod.CoverageHub(port=0, map_bytes=32).start()
        try:
            with socket.create_connection((hub.host, hub.port),
                                          timeout=5) as s:
                for fr in frames:
                    s.sendall(fr)
            assert _wait(lambda: sum(hub.stats().values()) == 5)
            got[name] = (hub.stats(), hub.pending_frames(), hub.take(0),
                         hub.take(0), hub.alive())
        finally:
            hub.stop()
            hub.join(timeout=10)
    assert got["port"] == got["jax"]
    stats, pending, first, again, alive = got["port"]
    assert (stats["frames"], stats["stale"], stats["torn"]) == (1, 1, 3)
    assert pending == 1 and first == {0: good} and again == {} and alive


def test_coverage_hub_torn_stream_and_late_frames():
    hub = Tmon.CoverageHub(port=0, map_bytes=16).start()
    try:
        with socket.create_connection((hub.host, hub.port), timeout=5) as s:
            s.sendall(_frame(0, 0, bytes(16)))
        assert _wait(lambda: hub.pending_frames() == 1)
        assert hub.take(2) == {} and hub.stats()["late"] == 1
        with socket.create_connection((hub.host, hub.port), timeout=5) as s:
            s.sendall(b"this is not a frame at all")
        assert _wait(lambda: hub.stats()["torn"] >= 1)
        assert hub.alive()
    finally:
        hub.stop()
        hub.join(timeout=10)
    assert _wait(lambda: not hub.alive())


def test_coverage_hub_ingest_faults_trip_breaker_dead():
    """A persistent monitor.ingest fault storm opens the breaker: the
    hub reports dead, and stays dead once the faults stop."""
    Tchaos.configure("monitor.ingest:*", seed=3)
    hub = Tmon.CoverageHub(port=0, map_bytes=16).start()
    try:
        with socket.create_connection((hub.host, hub.port), timeout=5) as s:
            for i in range(6):
                s.sendall(_frame(0, i, bytes(16)))
        assert _wait(lambda: not hub.alive())
        assert hub.stats()["faulted"] >= 4
    finally:
        Tchaos.configure(None)
    try:
        # death is sticky: the faults have stopped, the hub stays dead
        with socket.create_connection((hub.host, hub.port), timeout=5) as s:
            s.sendall(_frame(1, 0, bytes(16)))
        assert _wait(lambda: hub.stats()["frames"] >= 1)
        assert not hub.alive()
    finally:
        hub.stop()
        hub.join(timeout=10)


# ---- no JAX in the new modules -------------------------------------------

def test_new_modules_import_no_jax(tmp_path):
    """A fresh interpreter imports the slice's modules, folds on the CPU,
    runs the host engine through the CLI and starts a hub with no jax
    and nothing of erlamsa_tpu in sys.modules."""
    code = (
        "import sys, io, contextlib\n"
        "import chip_smoke\n"
        "from erlamsa_tpu_torch.ops import coverage\n"
        "from erlamsa_tpu_torch.corpus import distill\n"
        "from erlamsa_tpu_torch.services import cli, dist, monitors, "
        "workerpool\n"
        "import torch\n"
        "idx = distill.CoverageIndex(8, use_device=True, device='cpu')\n"
        "assert idx.fold_case([('a', b'\\x03' + bytes(7))]) == [2]\n"
        "hub = monitors.CoverageHub(port=0).start()\n"
        "hub.stop(); hub.join(5)\n"
        "sys.stdin = io.TextIOWrapper(io.BytesIO(b'Hello erlamsa!\\n'))\n"
        "buf = io.BytesIO()\n"
        "out = io.TextIOWrapper(buf)\n"
        "with contextlib.redirect_stdout(out):\n"
        "    assert cli.main(['--backend', 'oracle', '-s', '1,2,3']) == 0\n"
        "out.flush()\n"
        "assert buf.getvalue(), 'no output'\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'erlamsa_tpu' or m.startswith('erlamsa_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
