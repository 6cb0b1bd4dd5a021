"""Persistent seed store: content-hash-deduped corpus with metadata.

Layout under the --corpus directory:

    <root>/corpus.json      metadata: per-seed origin, energy, hit
                            counts, discovered-by, event tallies
    <root>/seeds/<sha256>   one file per unique seed, named by its
                            content hash — dedup is the filename

JSON-backed like services/cmanager.py's mnesia stand-in: a thread lock
guards the in-memory state and every save is an atomic tmp+rename, so
concurrent writers (monitor threads publishing through apply_event,
the runner's case loop) never corrupt the store and a crash mid-save
leaves the previous snapshot intact. Seed files are immutable once
written (content-addressed), so cross-process sharing of a corpus
directory is safe too: the worst race is two writers creating the same
file with identical bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

from ..services import chaos, logger
from ..services.resilience import RetryExhausted, RetryPolicy
from .feedback import EVENT_GAIN, Event

STORE_VERSION = 1

# metadata saves are frequent and cheap; one quick retry absorbs a
# transient disk error (or an injected store.save fault) so persistence
# actually happens instead of silently best-efforting into the void
SAVE_RETRY = RetryPolicy(attempts=2, base=0.01, max_delay=0.1,
                         retry_on=(OSError,))

INIT_ENERGY = 1.0
MIN_ENERGY = 0.25
MAX_ENERGY = 64.0


def seed_id_for(data: bytes) -> str:
    """Content hash = identity; the store's dedup key and filename."""
    return hashlib.sha256(data).hexdigest()


class CorpusStore:
    """Deduped seed corpus with per-seed scheduling metadata."""

    # lock discipline (analysis/rules_threads.py enforces this declaration):
    # every touch of these fields happens with _lock held
    _GUARDED_BY = {"_lock": ("_meta", "_next_idx", "_cache")}

    def __init__(self, root: str, create: bool = True):
        self.root = root
        self.seeds_dir = os.path.join(root, "seeds")
        self.meta_path = os.path.join(root, "corpus.json")
        if create:
            os.makedirs(self.seeds_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._meta: dict[str, dict] = {}
        self._next_idx = 0
        self._cache: dict[str, bytes] = {}
        # admission hook: called with the seed id of every NEWLY added
        # seed, outside the store lock (callers may be service threads).
        # The arena layout uses it to stage device uploads at store
        # admission — a seed crosses PCIe once, here, then mutates from
        # device pages (corpus/arena.py)
        self.listener = None
        with self._lock:
            self._load_locked()

    # --- persistence (cmanager.py idiom: atomic, best-effort) ------------

    def _load_locked(self):
        """Caller holds self._lock (only __init__, before any thread can
        see the store — locked anyway so the guarded-field discipline
        holds by inspection, not by timing argument)."""
        for candidate in (self.meta_path, self.meta_path + ".bak"):
            if not os.path.exists(candidate):
                continue
            try:
                with open(candidate) as f:
                    st = json.load(f)
                self._meta = dict(st.get("seeds", {}))
                self._next_idx = max(
                    (m.get("idx", 0) + 1 for m in self._meta.values()),
                    default=0,
                )
                if candidate != self.meta_path:
                    logger.log("warning", "corpus store %s unusable; "
                               "recovered from backup %s", self.meta_path,
                               candidate)
                return
            except (OSError, ValueError) as e:
                logger.log("warning", "corpus store %s unreadable (%s)",
                           candidate, e)
        if os.path.exists(self.meta_path):
            logger.log("warning", "corpus store %s: no usable snapshot; "
                       "starting empty", self.meta_path)

    def _save_locked(self):
        """Caller holds self._lock. Atomic AND durable: tmp is fsynced
        before the rename publishes it (a power loss after os.replace
        must not leave a truncated corpus.json — "atomic" against process
        kills alone is not durability), the previous snapshot survives as
        .bak, and the directory entry is fsynced so the rename itself
        sticks. Transient write errors get one retry; a persistently
        failing disk degrades to best-effort (the live store stays
        valid)."""
        tmp = self.meta_path + ".tmp"
        blob = json.dumps({"version": STORE_VERSION, "seeds": self._meta})

        def _write():
            chaos.fault_point("store.save")
            with open(tmp, "w") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(self.meta_path):
                try:
                    os.replace(self.meta_path, self.meta_path + ".bak")
                except OSError:
                    pass
            os.replace(tmp, self.meta_path)
            from ..services.checkpoint import fsync_dir

            fsync_dir(self.meta_path)

        try:
            SAVE_RETRY.call(_write, site="store.save")
        except (RetryExhausted, OSError):
            pass  # persistence is best-effort; the live store stays valid

    def save(self):
        with self._lock:
            self._save_locked()

    # --- seed CRUD -------------------------------------------------------

    def add(self, data: bytes, origin: str = "import",
            discovered_by: str | None = None) -> tuple[str | None, bool]:
        """Dedup-add one seed. Returns (seed_id, newly_added); empty data
        is rejected with (None, False) — a zero-byte seed can never be
        mutated into anything and would poison batch assembly."""
        if not data:
            return None, False
        sid = seed_id_for(data)
        with self._lock:
            if sid in self._meta:
                return sid, False
            path = os.path.join(self.seeds_dir, sid)
            if not os.path.exists(path):
                def _write_seed():
                    chaos.fault_point("store.seed")
                    tmp = path + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(data)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, path)

                try:
                    SAVE_RETRY.call(_write_seed, site="store.seed")
                except (RetryExhausted, OSError):
                    # best-effort like _save_locked: the seed keeps being
                    # served from the in-memory cache this run; fsck drops
                    # the metadata entry if the file never landed
                    pass
            self._meta[sid] = {
                "idx": self._next_idx,
                "len": len(data),
                "origin": origin,
                "discovered_by": discovered_by,
                "energy": INIT_ENERGY,
                "hits": 0,
                "events": {},
            }
            self._next_idx += 1
            self._cache[sid] = data
            self._save_locked()
        if self.listener is not None:
            # outside self._lock: the listener (arena admission queue)
            # has its own lock and must not nest under the store's
            self.listener(sid)
        return sid, True

    def add_paths(self, paths: list[str]) -> tuple[int, int, int]:
        """Import seed files; unreadable/empty files are skipped with a
        logged warning instead of aborting the run (the _load_corpus
        contract). Returns (new, dup, skipped)."""
        new = dup = skipped = 0
        for p in paths:
            try:
                with open(p, "rb") as f:
                    data = f.read()
            except OSError as e:
                logger.log("warning", "corpus: skipping unreadable seed "
                           "%s: %s", p, e)
                skipped += 1
                continue
            if not data:
                logger.log("warning", "corpus: skipping empty seed %s", p)
                skipped += 1
                continue
            _sid, added = self.add(data, origin=os.path.basename(p))
            if added:
                new += 1
            else:
                dup += 1
        return new, dup, skipped

    def fsck(self, adopt_orphans: bool = True) -> dict:
        """Recovery pass: reconcile corpus.json against seeds/.

        - metadata entries whose seed file is missing are dropped (a
          schedule would crash reading them);
        - seed files whose content no longer matches their content-hash
          name are CORRUPT: quarantined to <root>/quarantine/ and dropped
          from the metadata;
        - seed files with no metadata entry (orphans — e.g. a crash
          between the file write and the corpus.json save) are adopted
          back into the store, or quarantined with adopt_orphans=False.

        Returns {"missing": n, "corrupt": n, "orphans": n, "ok": n} and
        persists the reconciled metadata when anything changed. Leftover
        .tmp files from torn writes are removed."""
        qdir = os.path.join(self.root, "quarantine")
        missing = corrupt = orphans = 0
        orphan_data: list[bytes] = []
        with self._lock:
            try:
                on_disk = set(os.listdir(self.seeds_dir))
            except OSError:
                on_disk = set()
            for name in sorted(on_disk):
                path = os.path.join(self.seeds_dir, name)
                if name.endswith(".tmp"):
                    # torn write: the content it was renaming to is either
                    # published under its hash or lost — never both
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    on_disk.discard(name)
                    continue
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    continue
                if seed_id_for(data) != name:
                    corrupt += 1
                    os.makedirs(qdir, exist_ok=True)
                    try:
                        # lint: chaos-site-coverage-ok quarantine move on the recovery path
                        os.replace(path, os.path.join(qdir, name))
                    except OSError:
                        pass
                    self._meta.pop(name, None)
                    self._cache.pop(name, None)
                    on_disk.discard(name)
                    logger.log("warning", "corpus fsck: %s corrupt "
                               "(content/hash mismatch), quarantined", name)
                elif name not in self._meta:
                    orphans += 1
                    if adopt_orphans:
                        orphan_data.append(data)
                    else:
                        os.makedirs(qdir, exist_ok=True)
                        try:
                            # lint: chaos-site-coverage-ok quarantine move on the recovery path
                            os.replace(path, os.path.join(qdir, name))
                        except OSError:
                            pass
            for sid in [s for s in self._meta if s not in on_disk]:
                missing += 1
                del self._meta[sid]
                self._cache.pop(sid, None)
                logger.log("warning", "corpus fsck: %s in corpus.json but "
                           "its seed file is gone; entry dropped", sid)
            changed = bool(missing or corrupt
                           or (orphans and not adopt_orphans))
            if changed:
                self._save_locked()
        # adoption re-enters through add() (it takes the lock itself)
        for data in orphan_data:
            self.add(data, origin="fsck-orphan")
        ok = len(self)
        summary = {"missing": missing, "corrupt": corrupt,
                   "orphans": orphans, "ok": ok}
        if missing or corrupt or orphans:
            logger.log("info", "corpus fsck: %d ok, %d missing, %d corrupt "
                       "quarantined, %d orphan(s) %s", ok, missing, corrupt,
                       orphans, "adopted" if adopt_orphans else "quarantined")
        return summary

    def get(self, seed_id: str) -> bytes:
        with self._lock:
            data = self._cache.get(seed_id)
        if data is None:
            with open(os.path.join(self.seeds_dir, seed_id), "rb") as f:
                data = f.read()
            with self._lock:
                self._cache[seed_id] = data
        return data

    def ids(self) -> list[str]:
        """Seed ids in insertion order — THE deterministic ordering every
        scheduler draw indexes into (energy.EnergyScheduler)."""
        with self._lock:
            items = sorted(self._meta.items(), key=lambda kv: kv[1]["idx"])
        return [sid for sid, _ in items]

    def __len__(self) -> int:
        with self._lock:
            return len(self._meta)

    def __contains__(self, seed_id: str) -> bool:
        with self._lock:
            return seed_id in self._meta

    def meta(self, seed_id: str) -> dict:
        with self._lock:
            return dict(self._meta[seed_id])

    def seed_paths(self) -> list[str]:
        """Seed file paths in insertion order (the oracle engine path
        reads files; the store IS files)."""
        return [os.path.join(self.seeds_dir, s) for s in self.ids()]

    # --- energy bookkeeping ---------------------------------------------

    def bump(self, seed_id: str, delta: float, kind: str | None = None):
        with self._lock:
            m = self._meta.get(seed_id)
            if m is None:
                return
            m["energy"] = min(MAX_ENERGY,
                              max(MIN_ENERGY, m["energy"] + delta))
            if kind:
                m["events"][kind] = m["events"].get(kind, 0) + 1

    def apply_event(self, ev: Event, credit: list[str] | None = None):
        """Fold one feedback event into seed energies. Events naming a
        seed bump it directly; anonymous events (a monitor can rarely say
        WHICH input crashed the target) split the gain evenly over the
        `credit` set — the seeds scheduled in the case that was in flight,
        the same attribution AFL makes."""
        gain = EVENT_GAIN.get(ev.kind, 1.0)
        if ev.seed_id is not None and ev.seed_id in self:
            self.bump(ev.seed_id, gain, ev.kind)
        elif credit:
            share = gain / len(credit)
            for sid in credit:
                self.bump(sid, share, ev.kind)

    def retire(self, seed_id: str) -> bool:
        """Remove a seed the distillation pass proved subsumed
        (corpus/distill.py). The seed file moves to <root>/retired/ —
        evidence is preserved but fsck will not re-adopt it as an
        orphan. Returns False for unknown ids. If the move itself fails
        (or an injected store.seed fault fires) the metadata removal
        still sticks; the stranded file is adopted back by a later fsck,
        which is the safe direction — a retired seed resurfacing costs
        schedule weight, a lost seed costs coverage."""
        return self.retire_many([seed_id]) == 1

    def retire_many(self, seed_ids) -> int:
        """retire() for each id in order, with one corpus.json save for
        all of them (one save per seed rewrites the whole index each
        time: seconds for a thousand seeds of a large store). Returns
        how many ids were known and retired. A crash before the save
        leaves moved files whose entries remain, which fsck drops as
        missing: the outcome of a crash after some of the one-by-one
        saves."""
        done = 0
        with self._lock:
            for seed_id in seed_ids:
                m = self._meta.pop(seed_id, None)
                if m is None:
                    continue
                done += 1
                self._cache.pop(seed_id, None)
                rdir = os.path.join(self.root, "retired")
                try:
                    chaos.fault_point("store.seed")
                    os.makedirs(rdir, exist_ok=True)
                    os.replace(os.path.join(self.seeds_dir, seed_id),
                               os.path.join(rdir, seed_id))
                except OSError as e:
                    logger.log("warning", "corpus: retiring %s: move "
                               "failed (%s); file left for fsck", seed_id,
                               e)
            if done:
                self._save_locked()
        return done

    def record_scheduled(self, counts: dict[str, int]):
        """hits += n per seed: the scheduler's energy-spend record that
        decays a seed's effective weight over time (energy.seed_weights)."""
        with self._lock:
            for sid, n in counts.items():
                m = self._meta.get(sid)
                if m is not None:
                    m["hits"] += n

    def energies(self) -> dict[str, tuple[float, int]]:
        """{seed_id: (energy, hits)} — the checkpointable schedule state."""
        with self._lock:
            return {s: (m["energy"], m["hits"])
                    for s, m in self._meta.items()}

    def restore_energies(self, mapping: dict[str, tuple[float, int]]):
        """Resume path (services/checkpoint.py): restored energies make a
        resumed run schedule exactly like the uninterrupted one."""
        with self._lock:
            for sid, (energy, hits) in mapping.items():
                m = self._meta.get(sid)
                if m is not None:
                    m["energy"] = float(energy)
                    m["hits"] = int(hits)

    def stats(self) -> dict:
        with self._lock:
            events: dict[str, int] = {}
            for m in self._meta.values():
                for k, n in m["events"].items():
                    events[k] = events.get(k, 0) + n
            return {
                "seeds": len(self._meta),
                "bytes": sum(m["len"] for m in self._meta.values()),
                "total_hits": sum(m["hits"] for m in self._meta.values()),
                "events": events,
            }
