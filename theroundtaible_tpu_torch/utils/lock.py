"""Hostname:PID-stamped advisory file locks for shared .roundtable files.

The reference has NO locking: concurrent `roundtable` invocations in one
project interleave read-modify-write cycles on chronicle.md / decree-log
/ manifest (SURVEY.md §5.2), and its own TODO acknowledges the gap as
future work ("stale lock detection — PID-based check ... so crashed
sessions don't lock", reference TODO.md:188). This implements exactly
that: O_CREAT|O_EXCL lock files stamped with the holder's PID; a lock
whose holder is no longer alive is stale and silently reclaimed, so a
crashed run can never deadlock the next one.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from pathlib import Path


class LockTimeout(RuntimeError):
    pass


# A lock from ANOTHER host cannot be PID-checked; it is presumed crashed
# (and reclaimed) once its file is this old. Roundtable store writes hold
# locks for milliseconds, so minutes of age means a dead holder — this
# keeps the module's no-deadlock guarantee in the multi-host case at the
# cost of a cross-host reclaim being slow instead of instant. Live
# holders are protected past this ceiling by the heartbeat below
# (advisor r3: a generic utility must not lose mutual exclusion just
# because one call site holds long).
CROSS_HOST_STALE_S = 300.0


def _stamp() -> str:
    return f"{socket.gethostname()}:{os.getpid()}"


def _parse_stamp(text: str) -> tuple[str | None, int]:
    """(hostname|None, pid) from a lock file's content. Legacy pid-only
    stamps (pre-multi-host) parse as (None, pid)."""
    text = text.strip()
    if ":" in text:
        host, _, pid_s = text.rpartition(":")
    else:
        host, pid_s = None, text
    try:
        return host or None, int(pid_s or "0")
    except ValueError:
        return host or None, 0


# Heartbeat: ONE shared daemon thread (started lazily on the first
# acquire in the process) touches every currently-held lock file's mtime
# every CROSS_HOST_STALE_S/3, so a LIVE holder is never mistaken for a
# crashed one by the age-gated cross-host reclaim — without paying a
# thread spawn on the millisecond-hold hot path. Before each touch the
# stamp is re-read: if it is no longer ours (another host age-reclaimed
# while this whole process was stalled), the entry is dropped so we never
# keep refreshing a lock that now belongs — or belonged — to someone
# else. Transient I/O errors (NFS hiccups) skip one beat and retry.
_hb_mutex = threading.Lock()
_hb_held: dict[str, str] = {}  # lock-file path -> stamp we wrote
_hb_started = False
_hb_wake = threading.Event()


def _hb_register(path: Path, stamp: str) -> None:
    global _hb_started
    with _hb_mutex:
        _hb_held[str(path)] = stamp
        if not _hb_started:
            _hb_started = True
            threading.Thread(target=_hb_loop, daemon=True).start()
    _hb_wake.set()  # interrupt a possibly-long wait so the new interval
    #                 (tests patch CROSS_HOST_STALE_S) takes effect now


def _hb_unregister(path: Path) -> None:
    with _hb_mutex:
        _hb_held.pop(str(path), None)


def _hb_loop() -> None:
    while True:
        _hb_wake.wait(CROSS_HOST_STALE_S / 3.0)
        _hb_wake.clear()
        with _hb_mutex:
            items = list(_hb_held.items())
        for path, stamp in items:
            try:
                content = Path(path).read_text().strip()
            except FileNotFoundError:
                _hb_unregister(Path(path))  # released/reclaimed
                continue
            except OSError:
                continue  # transient: retry next beat
            if content != stamp:
                _hb_unregister(Path(path))  # not ours anymore
                continue
            try:
                os.utime(path)
            except OSError:
                pass  # transient: retry next beat


class FileLock:
    """`with FileLock(path):` — advisory lock at `<path>.lock`.

    Holds of any length are safe: while held, the module's shared
    heartbeat keeps the lock file's mtime fresh, so a LIVE holder on
    another host is never mistaken for a crashed one by the age-gated
    cross-host reclaim (roundtable's millisecond store writes release
    long before the first beat ever fires)."""

    def __init__(self, target: str | Path, timeout_s: float = 10.0,
                 poll_s: float = 0.05):
        self.lock_path = Path(str(target) + ".lock")
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self._held = False

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, owned by someone else
        return True

    def _try_reclaim_stale(self) -> None:
        """Reclaim a lock whose holder died — without the check-then-unlink
        race: the file is CLAIMED first (atomic rename to a name only we
        use), then its content re-verified. If the rename grabbed a fresh
        lock that appeared between our read and the rename, it is restored
        via os.link (which refuses if a newer lock already took the slot).
        The remaining window needs three processes interleaving within the
        same few microseconds twice in a row — vanishingly small next to
        the 50ms poll cadence this lock operates at.

        Multi-host (shared filesystem): a PID is only meaningful on the
        host that wrote it — a live holder on another host would look
        dead to our local process table. Stamps carry hostname:pid; a
        stamp from a DIFFERENT hostname is reclaimed only once the lock
        file is CROSS_HOST_STALE_S old (age replaces the PID liveness
        check), so a crashed remote holder cannot deadlock this host
        forever and a live one is never raced."""
        try:
            host, pid = _parse_stamp(self.lock_path.read_text())
        except OSError:
            return  # holder is mid-write or lock vanished; just retry
        if host is not None and host != socket.gethostname():
            try:
                age = time.time() - self.lock_path.stat().st_mtime
            except OSError:
                return  # vanished between read and stat; just retry
            if age < CROSS_HOST_STALE_S:
                return  # possibly-live cross-host holder: wait it out
        elif not pid or self._pid_alive(pid):
            return
        claimed = Path(f"{self.lock_path}.reap.{os.getpid()}")
        try:
            os.rename(self.lock_path, claimed)
        except OSError:
            return  # someone else reclaimed (or released) first
        try:
            host2, pid2 = _parse_stamp(claimed.read_text())
        except OSError:
            host2, pid2 = None, 0
        fresh = (host2, pid2) != (host, pid) or (
            # same stamp, but the holder may have released and re-acquired
            # between our read and the rename — alive means fresh (only
            # checkable locally; the cross-host case was age-gated above)
            (host2 is None or host2 == socket.gethostname())
            and pid2 and self._pid_alive(pid2))
        if fresh:
            # We renamed a FRESH lock — put it back unless a newer lock
            # already occupied the slot.
            try:
                os.link(claimed, self.lock_path)
            except OSError:
                pass
        try:
            claimed.unlink()
        except OSError:
            pass

    def acquire(self) -> None:
        self.lock_path.parent.mkdir(parents=True, exist_ok=True)
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                fd = os.open(self.lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                stamp = _stamp()
                with os.fdopen(fd, "w") as f:
                    f.write(stamp)
                self._held = True
                _hb_register(self.lock_path, stamp)
                return
            except FileExistsError:
                self._try_reclaim_stale()
                if time.monotonic() > deadline:
                    raise LockTimeout(
                        f"Could not acquire {self.lock_path} within "
                        f"{self.timeout_s:.0f}s — another roundtable "
                        "process is writing; retry, or remove the lock "
                        "file if no other process is running")
                time.sleep(self.poll_s)

    def release(self) -> None:
        if self._held:
            self._held = False
            _hb_unregister(self.lock_path)
            try:
                self.lock_path.unlink()
            except OSError:
                pass

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False
