"""Crash/event monitors and the coverage ingest hub.

Reference: src/erlamsa_monitor.erl and mon_* modules — a registry of
monitors started from ``--monitor +name:params`` / ``!name:off`` CLI specs,
each reporting findings through the logger and optionally running an
``after=exec`` recovery action:

  cm      connect-back listener catching SSRF/XXE/reverse-shell payloads
          (src/erlamsa_mon_connect.erl); its host:port is advertised to the
          payloads via the shared config
  probe   periodic TCP/UDP liveness probe; refused/timeout -> finding
          (src/erlamsa_mon_network.erl)
  exec    spawn-and-watch a target process; nonzero/signal exit -> finding
          (the cdb/r2 equivalent for environments without a debugger)
  r2      radare2-driven crash triage (src/erlamsa_mon_r2.erl); gated on
          an available `r2` binary
  lc      adb logcat crash extraction (src/erlamsa_mon_logcat.erl); gated
          on an available `adb` binary
  lxi     SCPI measurement-range monitor over TCP
          (src/erlamsa_mon_lxi.erl)
  cdb     the Windows CDB console debugger: on a debugger break-in log
          backtrace/registers, write a minidump, restart
          (src/erlamsa_mon_cdb.erl); gated on an available `cdb` binary

Unlike the original fire-and-forget daemon threads, every monitor loop
now runs under services/supervisor.py (per-monitor restart backoff,
give-up breaker on crash storms), monitor subprocesses spawn through
one chaos-faultable funnel with a per-execution hang watchdog
(deadline + process-group kill), and crash reports are deduped by
(signal, top-frames stack hash) before they reach the feedback bus —
the energy scheduler sees each distinct crash once, not a log line per
re-trigger.

``CoverageHub`` is the monitor plane's device-feedback half: a framed
connect-back listener (the r15 frame codec from services/dist.py)
accepting per-sample edge bitmaps that the corpus runner folds into
per-seed coverage tensors at case boundaries. This module runs no
torch code (like corpus/feedback.py): monitor threads never touch the
card, and the hub binds before the runner builds its device state.
"""

from __future__ import annotations

import hashlib
import os
import re
import shlex
import shutil
import signal
import socket
import subprocess
import threading
import time
import zlib

from ..constants import COVERAGE_MAP_BYTES, DEFAULT_CM_PORT
from ..corpus import feedback
from ..obs import trace
from . import chaos, logger, metrics
from .dist import _read_frame
from .resilience import OPEN, CircuitBreaker
from .supervisor import SupervisedThread

# shared monitor config, the reference's global_config ets analogue
CONFIG: dict = {"cm_port": DEFAULT_CM_PORT, "cm_host": None}

#: per-execution watchdog default: a watched target (or after-action)
#: that produces no exit within this many seconds is group-killed
EXEC_DEADLINE = 30.0


# --- subprocess funnel: one spawn site, one hang watchdog ----------------

def _spawn(argv: list[str], **popen_kw) -> subprocess.Popen:
    """Every monitor subprocess comes to life here: one chaos site
    (monitor.spawn) so fault specs can starve the whole recovery/triage
    plane, and its own session/process group so the hang watchdog can
    kill the target together with anything it forked."""
    chaos.fault_point("monitor.spawn")
    return subprocess.Popen(argv, start_new_session=True, **popen_kw)


def _kill_group(proc: subprocess.Popen):
    """Process-group kill with reaping; falls back to killing the lone
    process when the group is already gone."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except OSError:
        try:
            proc.kill()
        except OSError:
            pass
    try:
        proc.wait(timeout=5)
    except (subprocess.TimeoutExpired, OSError):
        pass


def _watch(proc: subprocess.Popen,
           deadline: float) -> tuple[bytes | None, int | None]:
    """Per-execution hang watchdog: wait for exit within `deadline`
    seconds; a target still running past it is process-group-killed.
    Returns (output, returncode); returncode None means the watchdog
    fired (a hang, not an exit)."""
    try:
        out, _ = proc.communicate(timeout=deadline if deadline > 0 else None)
        return out, proc.returncode
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        try:
            out, _ = proc.communicate(timeout=5)
        except (subprocess.TimeoutExpired, OSError):
            out = b""
        return out, None


def _run_after(params: dict):
    """after=exec recovery hook (erlamsa_monitor:do_after,
    src/erlamsa_monitor.erl:98-104). Spawns through the monitor.spawn
    funnel — failures are LOGGED, never swallowed — and a reaper thread
    waits on the action under the hang watchdog so a stuck recovery
    command is group-killed instead of leaking a zombie."""
    cmd = params.get("after")
    if not cmd:
        return
    budget = float(params.get("after_timeout", EXEC_DEADLINE))
    try:
        proc = _spawn(shlex.split(cmd))
    except (OSError, ValueError) as e:
        metrics.GLOBAL.record_monitor("spawn_failed")
        logger.log("error", "monitor after-action %r failed to spawn: %s",
                   cmd, e)
        return
    metrics.GLOBAL.record_monitor("after_spawned")

    def _reap():
        _out, rc = _watch(proc, budget)
        if rc is None:
            metrics.GLOBAL.record_monitor("hang_killed")
            logger.log("warning", "monitor after-action %r hung past "
                       "%.1fs, killed", cmd, budget)

    threading.Thread(target=_reap, name="mon:after-reap",
                     daemon=True).start()


# --- network helpers: monitor-plane socket I/O behind one fault site -----

def _net_read(sock: socket.socket, n: int) -> bytes:
    """Monitor-plane socket read (chaos site monitor.ingest)."""
    chaos.fault_point("monitor.ingest")
    return sock.recv(n)


def _net_write(sock: socket.socket, payload: bytes, addr=None):
    """Monitor-plane socket write (probe hellos, SCPI queries) behind
    the same monitor.ingest site — one spec kills the whole plane's
    I/O."""
    chaos.fault_point("monitor.ingest")
    if addr is not None:
        sock.sendto(payload, addr)
    else:
        sock.sendall(payload)


# --- crash dedup/triage --------------------------------------------------

_FRAME_PAT = re.compile(rb"(?:#\d+\s|\+0x[0-9a-fA-F]+|\bat\s+\S|\bin\s+\S+\s*\()")


class CrashTriage:
    """Dedup crashes by (signal, top-frames stack hash).

    The triage key hashes the first `frames` backtrace-looking lines of
    the target's output (falling back to the first non-empty lines when
    no frame pattern matches) together with the signal number — the
    classic "same signal, same top of stack => same bug" bucketing. The
    first observation of a bucket is a finding for the feedback bus;
    re-triggers only count.
    """

    def __init__(self, frames: int = 3):
        self.frames = int(frames)
        self._seen: set[str] = set()
        self.dups = 0

    def key(self, sig: int, output: bytes | None) -> str:
        lines = [ln.strip() for ln in (output or b"").splitlines()
                 if ln.strip()]
        top = [ln for ln in lines if _FRAME_PAT.search(ln)][:self.frames]
        if not top:
            top = lines[:self.frames]
        h = hashlib.sha1(b"|".join([b"sig%d" % sig, *top])).hexdigest()[:12]
        return f"sig{sig}:{h}"

    def observe(self, sig: int, output: bytes | None) -> tuple[str, bool]:
        """(triage key, first time seen?)"""
        k = self.key(sig, output)
        if k in self._seen:
            self.dups += 1
            return k, False
        self._seen.add(k)
        return k, True


# --- monitor base: supervised loops --------------------------------------

class Monitor:
    """One monitor = one supervised loop (services/supervisor.py): an
    unhandled crash in run() restarts it with backoff, and a crash
    storm trips the supervisor's give-up breaker instead of spinning.
    The public surface (start/stop/join/is_alive) matches the old
    threading.Thread subclass so CLI wiring and tests are unchanged."""

    name_code = "base"

    def __init__(self, params: dict):
        self.params = params
        self._stop_evt = threading.Event()
        self._thread = SupervisedThread(f"monitor:{self.name_code}",
                                        self._supervised_run)

    def _supervised_run(self):
        if not self._stop_evt.is_set():
            self.run()

    def run(self):
        raise NotImplementedError

    def start(self) -> "Monitor":
        self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()

    def join(self, timeout=None):
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()


class ConnectMonitor(Monitor):
    """cm: TCP listener catching connect-backs; '{event}'-prefixed payloads
    log as findings (src/erlamsa_mon_connect.erl:47-54)."""

    name_code = "cm"

    def run(self):
        port = int(self.params.get("port", DEFAULT_CM_PORT))
        CONFIG["cm_port"] = port
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind(("0.0.0.0", port))
        except OSError as e:
            logger.log("error", "cm monitor cannot bind :%d: %s", port, e)
            return
        srv.listen(16)
        srv.settimeout(1.0)
        logger.log("info", "connect monitor listening on :%d", port)
        while not self._stop_evt.is_set():
            try:
                conn, addr = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                conn.settimeout(2.0)
                data = _net_read(conn, 4096)
            except OSError:
                data = b""
            finally:
                conn.close()
            if data.startswith(b"{event}"):
                logger.log("finding", "cm event from %s: %r", addr[0], data[7:200])
            else:
                logger.log("finding", "connect-back from %s:%d (%d bytes)",
                           addr[0], addr[1], len(data))
            feedback.publish("connback", source="monitor:cm",
                             detail=f"from {addr[0]}")
            _run_after(self.params)


class NetworkProbeMonitor(Monitor):
    """probe: periodic hello; timeout/refusal is a finding
    (src/erlamsa_mon_network.erl:48-57)."""

    name_code = "probe"

    def run(self):
        host = self.params.get("host", "127.0.0.1")
        port = int(self.params.get("port", 80))
        proto = self.params.get("proto", "tcp")
        interval = float(self.params.get("interval", 5.0))
        hello = self.params.get("hello", "hello").encode()
        while not self._stop_evt.is_set():
            ok = False
            try:
                if proto == "udp":
                    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                    s.settimeout(3.0)
                    _net_write(s, hello, (host, port))
                    ok = True
                else:
                    with socket.create_connection((host, port), timeout=3.0) as s:
                        _net_write(s, hello)
                        ok = True
            except OSError as e:
                logger.log("finding", "probe: %s:%d unreachable (%s)", host, port, e)
                feedback.publish("drop", source="monitor:probe",
                                 detail=f"{host}:{port}")
                _run_after(self.params)
            if ok:
                logger.log("debug", "probe: %s:%d alive", host, port)
            self._stop_evt.wait(interval)


class ExecMonitor(Monitor):
    """exec: keep a target app running; abnormal exits are findings and the
    app is restarted — the cross-platform stand-in for the cdb/r2 debugger
    monitors (src/erlamsa_mon_cdb.erl behavior).

    Every execution runs under the hang watchdog (``timeout=`` param,
    default EXEC_DEADLINE): a wedged target is process-group-killed and
    reported as a hang finding. Spawn failures feed a CircuitBreaker so
    a broken cmdline cools down instead of hot-spinning, and crashes
    are triage-deduped before they reach the bus."""

    name_code = "exec"

    def __init__(self, params: dict):
        super().__init__(params)
        self.triage = CrashTriage()
        self.breaker = CircuitBreaker(failure_threshold=3,
                                      reset_timeout=10.0,
                                      name="monitor:exec")

    def run(self):
        cmd = self.params.get("app")
        if not cmd:
            logger.log("error", "exec monitor needs app=<cmdline>")
            return
        deadline = float(self.params.get("timeout", EXEC_DEADLINE))
        delay = float(self.params.get("delay", 5.0))
        while not self._stop_evt.is_set():
            if not self.breaker.allow():
                self._stop_evt.wait(delay)
                continue
            try:
                proc = _spawn(shlex.split(cmd), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
            except (OSError, ValueError) as e:
                self.breaker.record_failure()
                metrics.GLOBAL.record_monitor("spawn_failed")
                logger.log("error", "exec monitor: cannot spawn %r: %s",
                           cmd, e)
                self._stop_evt.wait(delay)
                continue
            self.breaker.record_success()
            out, rc = _watch(proc, deadline)
            if rc is None:
                metrics.GLOBAL.record_monitor("hang_killed")
                logger.log("finding", "exec target hung past %.1fs, "
                           "killed; tail: %r", deadline,
                           out[-500:] if out else b"")
                feedback.publish("finding", source="monitor:exec",
                                 detail="hang")
                _run_after(self.params)
            elif rc and not self._stop_evt.is_set():
                if rc < 0:
                    key, first = self.triage.observe(-rc, out)
                    if first:
                        metrics.GLOBAL.record_monitor("crash")
                        logger.log("finding", "exec target crashed sig=%d "
                                   "triage=%s; tail: %r", -rc, key,
                                   out[-500:] if out else b"")
                        feedback.publish("crash", source="monitor:exec",
                                         detail=key)
                    else:
                        metrics.GLOBAL.record_monitor("crash_dup")
                        logger.log("debug", "exec target crash (dup "
                                   "triage=%s)", key)
                else:
                    logger.log("warning", "exec target exited rc=%d; "
                               "tail: %r", rc, out[-500:] if out else b"")
                    feedback.publish("finding", source="monitor:exec",
                                     detail=f"rc={rc}")
                _run_after(self.params)
            self._stop_evt.wait(delay)


class R2Monitor(Monitor):
    """r2: drive radare2 over r2pipe for crash triage; registers/backtrace
    dumps on crash (src/erlamsa_mon_r2.erl:43-58). Requires `r2`."""

    name_code = "r2"

    def __init__(self, params: dict):
        super().__init__(params)
        self.triage = CrashTriage()

    def run(self):
        if shutil.which("r2") is None:
            logger.log("error", "r2 monitor: radare2 not found in PATH")
            return
        app = self.params.get("app")
        while not self._stop_evt.is_set():
            try:
                proc = _spawn(["r2", "-q0", "-d", *shlex.split(app)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            except (OSError, ValueError) as e:
                metrics.GLOBAL.record_monitor("spawn_failed")
                logger.log("error", "r2 monitor: cannot spawn: %s", e)
                self._stop_evt.wait(float(self.params.get("delay", 2.0)))
                continue
            try:
                proc.stdin.write(b"dc\n")
                proc.stdin.flush()
                out = proc.stdout.read()
                if b"SIGSEGV" in out or b"signal" in out:
                    proc.stdin.write(b"drj\nij\ndbt\n")
                    proc.stdin.flush()
                    dump = proc.stdout.read()
                    key, first = self.triage.observe(signal.SIGSEGV, dump)
                    if first:
                        metrics.GLOBAL.record_monitor("crash")
                        logger.log("finding", "r2 crash dump triage=%s: %r",
                                   key, dump[:1000])
                        feedback.publish("crash", source="monitor:r2",
                                         detail=key)
                    else:
                        metrics.GLOBAL.record_monitor("crash_dup")
                    _run_after(self.params)
            except (OSError, ValueError):
                pass
            finally:
                _kill_group(proc)
            self._stop_evt.wait(float(self.params.get("delay", 2.0)))


class LogcatMonitor(Monitor):
    """lc: adb logcat crash extraction for Android targets
    (src/erlamsa_mon_logcat.erl:31-51). Requires `adb`."""

    name_code = "lc"

    def run(self):
        if shutil.which("adb") is None:
            logger.log("error", "logcat monitor: adb not found in PATH")
            return
        app = self.params.get("app", "")
        if app:
            subprocess.run(["adb", "shell", "am", "start", "-n", app], check=False)
        try:
            proc = _spawn(["adb", "logcat", "*:E"], stdout=subprocess.PIPE)
        except OSError as e:
            metrics.GLOBAL.record_monitor("spawn_failed")
            logger.log("error", "logcat monitor: cannot spawn adb: %s", e)
            return
        crash_lines: list[bytes] = []
        for line in proc.stdout:
            if self._stop_evt.is_set():
                break
            if b"FATAL EXCEPTION" in line or b"SIGSEGV" in line:
                crash_lines = [line]
            elif crash_lines:
                crash_lines.append(line)
                if len(crash_lines) > 20:
                    logger.log("finding", "logcat crash: %r",
                               b"".join(crash_lines)[:2000])
                    feedback.publish("crash", source="monitor:lc")
                    _run_after(self.params)
                    crash_lines = []
        _kill_group(proc)


class LxiMonitor(Monitor):
    """lxi: SCPI MEAS:CURR? over TCP; out-of-range measurement -> finding
    (hardware fuzzing, src/erlamsa_mon_lxi.erl:75-93)."""

    name_code = "lxi"

    def run(self):
        host = self.params.get("host", "127.0.0.1")
        port = int(self.params.get("port", 5025))
        lo = float(self.params.get("lvalue", 0.0))
        hi = float(self.params.get("uvalue", 1.0))
        interval = float(self.params.get("interval", 2.0))
        while not self._stop_evt.is_set():
            try:
                with socket.create_connection((host, port), timeout=3.0) as s:
                    _net_write(s, b"MEAS:CURR?\n")
                    v = float(_net_read(s, 256).strip())
                    if not (lo <= v <= hi):
                        logger.log("finding",
                                   "lxi measurement %g outside [%g, %g]", v, lo, hi)
                        feedback.publish("finding", source="monitor:lxi",
                                         detail=f"{v}")
                        _run_after(self.params)
            except (OSError, ValueError) as e:
                logger.log("warning", "lxi probe failed: %s", e)
            self._stop_evt.wait(interval)


class CdbMonitor(Monitor):
    """cdb: drive the Windows CDB console debugger over stdio
    (src/erlamsa_mon_cdb.erl:72-94). Attach with ``pid=N`` (-p),
    ``attach=name`` (-pn) or launch with ``app=<cmdline>``; `g` resumes the
    target, and when the debugger breaks back in (crash/exception) the
    monitor logs the event, a `k` backtrace and `r` registers as findings,
    saves a timestamped minidump via ``.dump /m``, runs the after actions
    and re-attaches. ``cdb=<binary>`` overrides the debugger path (used by
    tests to substitute an emulator; real use needs cdb.exe in PATH).

    The stdio protocol matches the reference's port loop: every command's
    reply is read until the "> " debugger prompt (read_cdb_data,
    src/erlamsa_mon_cdb.erl:131-141).
    """

    name_code = "cdb"
    ATTEMPTS = 5  # ?START_MONITOR_ATTEMPTS

    def __init__(self, params: dict):
        super().__init__(params)
        self._proc: subprocess.Popen | None = None
        self.triage = CrashTriage()

    def stop(self):
        super().stop()
        proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.kill()

    def _target_args(self):
        if "pid" in self.params:
            return ["-p", str(self.params["pid"])]
        if "attach" in self.params:
            return ["-pn", str(self.params["attach"])]
        if "app" in self.params:
            return shlex.split(self.params["app"])
        return None

    def _read_to_prompt(self) -> bytes | None:
        """Accumulate debugger output until the trailing '> ' prompt; None
        when the debugger exits first (closed/process_exit in the ref)."""
        buf = b""
        while True:
            chunk = self._proc.stdout.read(1)
            if not chunk:
                return None
            buf += chunk
            if buf.endswith(b"> "):
                return buf

    def _call(self, cmd: bytes) -> bytes | None:
        try:
            self._proc.stdin.write(cmd)
            self._proc.stdin.flush()
        except OSError:
            return None
        return self._read_to_prompt()

    def run(self):
        cdb = self.params.get("cdb", "cdb")
        if shutil.which(cdb) is None:
            logger.log("error", "cdb monitor: %s not found in PATH", cdb)
            return
        args = self._target_args()
        if args is None:
            logger.log("error", "cdb monitor needs pid=/attach=/app=")
            return
        attempts = self.ATTEMPTS
        while not self._stop_evt.is_set():
            if attempts <= 0:
                logger.log("error",
                           "cdb monitor: too many failures (%d), giving up",
                           self.ATTEMPTS)
                return
            try:
                self._proc = _spawn(
                    [cdb, *args], stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                )
            except OSError as e:
                metrics.GLOBAL.record_monitor("spawn_failed")
                logger.log("warning", "cdb monitor spawn failed: %s", e)
                attempts -= 1
                self._stop_evt.wait(1.0)
                continue
            if self._stop_evt.is_set():  # stop() may have raced the spawn
                self._kill()
                return
            banner = self._read_to_prompt()
            if banner is None:
                logger.log("warning", "cdb monitor: debugger exited at start")
                attempts -= 1
                self._stop_evt.wait(1.0)
                continue
            logger.log("info", "cdb monitor attached: %r", banner[-200:])
            # `g` blocks until the debugger breaks back in — that IS the event
            crash = self._call(b"g\r\n")
            if crash is None or self._stop_evt.is_set():
                if not self._stop_evt.is_set():
                    logger.log("warning",
                               "cdb monitor: debugger exited while running")
                    attempts -= 1
                    self._stop_evt.wait(1.0)
                self._kill()
                continue
            # a full cycle reached the break-in: reset the give-up budget
            # (cdb_start(..., ?START_MONITOR_ATTEMPTS) after each cycle)
            attempts = self.ATTEMPTS
            logger.log("finding", "cdb monitor detected event (crash?): %r",
                       crash[:1000])
            bt = self._call(b"k\r\n")
            logger.log("finding", "cdb monitor backtrace: %r",
                       (bt or b"")[:2000])
            key, first = self.triage.observe(0, bt or crash)
            if first:
                metrics.GLOBAL.record_monitor("crash")
                feedback.publish("crash", source="monitor:cdb", detail=key)
            else:
                metrics.GLOBAL.record_monitor("crash_dup")
            regs = self._call(b"r\r\n")
            logger.log("finding", "cdb monitor registers: %r",
                       (regs or b"")[:2000])
            name = re.sub(r"[^A-Za-z0-9._-]", "_",
                          self.params.get("app", "cdb_target"))
            dump = name + time.strftime("_%Y_%m_%d_%H_%M_%S.minidump")
            res = self._call(f".dump /m {dump} \r\n".encode())
            logger.log("finding", "cdb monitor minidump saved to %s: %r",
                       dump, (res or b"")[:500])
            try:
                self._proc.stdin.write(b"q\r\n")
                self._proc.stdin.flush()
            except OSError:
                pass
            self._kill()
            _run_after(self.params)

    def _kill(self):
        proc = self._proc
        if proc is None:
            return
        try:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=5)
        except OSError:
            pass


# --- coverage ingest hub --------------------------------------------------

class CoverageHub:
    """Framed connect-back coverage ingest (the r15 frame codec of
    services/dist.py on a loopback-friendly listener).

    Instrumented targets (or the tier-1 stub) connect back and stream
    frames whose header is ``{"op": "cov", "case": C, "slot": S,
    "epoch": E, "crc": crc32(blob)}`` with the raw edge bitmap as the
    blob. Frames are crc32-checked against the blob and epoch-stamped;
    stale-epoch and torn (bad magic/width/crc) frames are rejected AND
    counted. Accepted maps buffer per case until the runner folds them
    at the case boundary (corpus/runner.py), where the sample ledger
    maps them back to (seed, case, slot).

    Robustness contract: the accept loop runs under the supervisor;
    every ingest failure — including an injected ``monitor.ingest``
    chaos fault — feeds a CircuitBreaker, and an OPEN circuit or a dead
    listener thread marks the hub dead. Death is sticky and one-way:
    the campaign degrades to hash-novelty and STAYS degraded, because a
    coverage signal that flickers would make adoption decisions depend
    on reconnect timing.
    """

    _GUARDED_BY = {"_lock": ("_pending", "counts")}

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 map_bytes: int = COVERAGE_MAP_BYTES, epoch: int = 0):
        self.map_bytes = int(map_bytes)
        self.epoch = int(epoch)
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._dead = False
        self._pending: dict[int, dict[int, bytes]] = {}
        self.counts = {"frames": 0, "stale": 0, "torn": 0, "faulted": 0,
                       "late": 0}
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, int(port)))
        srv.listen(8)
        srv.settimeout(0.5)
        self._srv = srv
        self.host, self.port = srv.getsockname()[:2]
        self.breaker = CircuitBreaker(failure_threshold=4,
                                      reset_timeout=3600.0,
                                      name="monitor:ingest")
        self._thread = SupervisedThread("monitor:coverage", self._serve)

    def start(self) -> "CoverageHub":
        self._thread.start()
        logger.log("info", "coverage hub listening on %s:%d (map=%dB "
                   "epoch=%d)", self.host, self.port, self.map_bytes,
                   self.epoch)
        return self

    def _serve(self):
        while not self._stop_evt.is_set():
            try:
                conn, addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener socket gone: alive() flips false
            threading.Thread(target=self._client, args=(conn, addr),
                             name="mon:cov-conn", daemon=True).start()
        try:
            self._srv.close()
        except OSError:
            pass

    def _client(self, conn: socket.socket, addr):
        f = conn.makefile("rb")
        try:
            while not self._stop_evt.is_set():
                try:
                    fr = _read_frame(f)
                except ValueError as e:
                    with self._lock:
                        self.counts["torn"] += 1
                    metrics.GLOBAL.record_coverage_frame("torn")
                    logger.log("warning", "coverage hub: torn stream from "
                               "%s: %s", addr[0], e)
                    break
                if fr is None:
                    break
                self._ingest(fr[0], fr[1], addr)
        except OSError:
            pass  # peer vanished mid-frame; buffered maps stay valid
        finally:
            try:
                f.close()
                conn.close()
            except OSError:
                pass

    def _ingest(self, header: dict, blob: bytes, addr):
        try:
            chaos.fault_point("monitor.ingest")
        except OSError as e:
            with self._lock:
                self.counts["faulted"] += 1
            self.breaker.record_failure()
            if self.breaker.state == OPEN:
                self._dead = True
            logger.log("warning", "coverage hub: ingest fault from %s: %s",
                       addr[0], e)
            return
        try:
            op = header.get("op")
            case = int(header["case"])
            slot = int(header["slot"])
            epoch = int(header.get("epoch", -1))
            crc = int(header.get("crc", -1))
        except (KeyError, TypeError, ValueError):
            op = None
            case = slot = epoch = crc = -1
        if op != "cov":
            with self._lock:
                self.counts["torn"] += 1
            metrics.GLOBAL.record_coverage_frame("torn")
            return
        if epoch != self.epoch:
            with self._lock:
                self.counts["stale"] += 1
            metrics.GLOBAL.record_coverage_frame("stale")
            return
        if len(blob) != self.map_bytes or zlib.crc32(blob) != crc & 0xFFFFFFFF:
            with self._lock:
                self.counts["torn"] += 1
            metrics.GLOBAL.record_coverage_frame("torn")
            return
        # accepted frames adopt any sender-carried trace context so a
        # remote target's coverage delivery lands parented under the
        # coordinator's case span in the merged fleet trace
        with trace.span_remote("coverage.ingest",
                               trace_id=str(header.get("trace", "")),
                               parent=int(header.get("span", 0) or 0),
                               case=case, slot=slot):
            with self._lock:
                self.counts["frames"] += 1
                self._pending.setdefault(case, {})[slot] = blob
        metrics.GLOBAL.record_coverage_frame("ok")
        self.breaker.record_success()

    def take(self, case: int) -> dict[int, bytes]:
        """Pop this case's buffered maps {slot: bitmap}. Frames for
        cases the runner already folded are dropped and counted late —
        re-folding them would make energy depend on arrival timing."""
        with self._lock:
            out = self._pending.pop(case, {})
            n_late = sum(len(self._pending.pop(c))
                         for c in [c for c in self._pending if c < case])
            if n_late:
                self.counts["late"] += n_late
        return out

    def pending_frames(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counts)

    def alive(self) -> bool:
        return not self._dead and self._thread.is_alive()

    def stop(self):
        self._stop_evt.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def join(self, timeout=None):
        self._thread.join(timeout)


MONITORS = {
    m.name_code: m
    for m in (ConnectMonitor, NetworkProbeMonitor, ExecMonitor, R2Monitor,
              LogcatMonitor, LxiMonitor, CdbMonitor)
}


def parse_monitor_spec(spec: str):
    """'+name:k=v,k=v' enables, '!name:off' disables
    (erlamsa_cmdparse monitor parsing, src/erlamsa_cmdparse.erl:436-451)."""
    if spec.startswith("!"):
        return None
    spec = spec.lstrip("+")
    name, _, rest = spec.partition(":")
    params = {}
    for kv in rest.split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            params[k] = v
    return name, params


def start_monitors(specs: list[str], default_cm: bool = False) -> list[Monitor]:
    """Start requested monitors; with default_cm the connect monitor starts
    unless disabled (erlamsa_monitor:default/0, src/erlamsa_monitor.erl:33)."""
    started = []
    disabled = {s.lstrip("!").partition(":")[0] for s in specs if s.startswith("!")}
    wanted = [parse_monitor_spec(s) for s in specs if not s.startswith("!")]
    wanted = [w for w in wanted if w]
    if default_cm and "cm" not in disabled and not any(n == "cm" for n, _ in wanted):
        wanted.append(("cm", {}))
    for name, params in wanted:
        cls = MONITORS.get(name)
        if cls is None:
            logger.log("error", "unknown monitor %s", name)
            continue
        mon = cls(params)
        mon.start()
        started.append(mon)
    return started
