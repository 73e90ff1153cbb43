"""Dataset/output file handlers (port of
``triangle_splatting_tpu/utils/file_handler.py``; host-side Python, the same
code over the port's own ``io_utils`` registry).

``LocalHandler`` resolves paths under a local root. ``MirrorHandler`` keeps
a local working cache in front of a *remote* store with the reference's
cache semantics: skip-if-exists on both directions, an upload lock so only
one worker pushes, and ``.done`` / ``.fail`` flags to coordinate fleets of
training jobs.

The remote side is a small ``RemoteStore`` interface with two backends:
``FilesystemStore`` mirrors into another filesystem path (an NFS or
GCS-fuse shared disk), and ``OSSStore`` rides the io_utils OSSIO
object-store backend (activated by io_utils.set_oss_io; exercises the
reference's native storage when the oss2 sdk is installed). ``oss://``
string roots route to OSSStore automatically; ``OSSHandler`` is the
name-compatible alias of MirrorHandler.
"""

from __future__ import annotations

import abc
import os
import shutil
import time
from pathlib import Path


class BaseFileHandler(abc.ABC):
    @abc.abstractmethod
    def getFilePath(self, file_path: str | None = None) -> str: ...

    @abc.abstractmethod
    def hasFile(self, file_path: str) -> bool: ...


class LocalHandler(BaseFileHandler):
    """Plain local-filesystem handler (file_handler.py:22-36)."""

    def __init__(self, local_root: str, logger=None):
        self._local_root = os.path.abspath(str(local_root).rstrip("/"))
        self._logger = logger

    def getFilePath(self, file_path: str | None = None) -> str:
        if not self.hasFile(file_path):
            raise FileNotFoundError(
                f"File {file_path} not found on {self._local_root}")
        return self._getLocalPath(file_path)

    def hasFile(self, file_path: str | None) -> bool:
        return os.path.exists(self._getLocalPath(file_path))

    def _getLocalPath(self, file_path: str | None = None) -> str:
        return (self._local_root if file_path is None
                else os.path.join(self._local_root, file_path))


class RemoteStore(abc.ABC):
    """Minimal remote-object interface the mirror handler needs."""

    @abc.abstractmethod
    def exists(self, path: str) -> bool: ...

    @abc.abstractmethod
    def get(self, remote_path: str, local_path: str) -> None: ...

    @abc.abstractmethod
    def put(self, local_path: str, remote_path: str) -> None: ...

    @abc.abstractmethod
    def listdir(self, path: str) -> list[str]: ...

    @abc.abstractmethod
    def remove(self, path: str) -> None: ...

    @abc.abstractmethod
    def touch(self, path: str) -> None: ...


class FilesystemStore(RemoteStore):
    """Remote store backed by another filesystem path (shared NFS / fuse
    mount). The shared-disk equivalent of the reference's OSS bucket."""

    def __init__(self, root: str):
        self.root = str(root).rstrip("/")

    def _p(self, path: str) -> Path:
        return Path(self.root) / path if path else Path(self.root)

    def exists(self, path: str) -> bool:
        return self._p(path).exists()

    def get(self, remote_path: str, local_path: str) -> None:
        src = self._p(remote_path)
        Path(local_path).parent.mkdir(parents=True, exist_ok=True)
        if src.is_dir():
            shutil.copytree(src, local_path, dirs_exist_ok=True)
        else:
            shutil.copy2(src, local_path)

    def put(self, local_path: str, remote_path: str) -> None:
        dst = self._p(remote_path)
        dst.parent.mkdir(parents=True, exist_ok=True)
        if Path(local_path).is_dir():
            shutil.copytree(local_path, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(local_path, dst)

    def listdir(self, path: str) -> list[str]:
        p = self._p(path)
        return sorted(x.name for x in p.iterdir()) if p.is_dir() else []

    def remove(self, path: str) -> None:
        p = self._p(path)
        if p.is_dir():
            shutil.rmtree(p, ignore_errors=True)
        elif p.exists():
            p.unlink()

    def touch(self, path: str) -> None:
        p = self._p(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.touch()


class OSSStore(RemoteStore):
    """Remote store over the OSSIO object-store backend (reference
    file_handler.py:38-258 talks to OSS through io_utils' OSSIO; same
    pairing here). ``root`` is an ``oss://bucket/prefix`` path; ``backend``
    defaults to whichever backend the global ``io`` facade has registered
    for it (see io_utils.set_oss_io)."""

    def __init__(self, root: str, backend=None):
        from .io_utils import io
        self.root = str(root).rstrip("/")
        self._io = backend if backend is not None else io

    def _p(self, path: str) -> str:
        return f"{self.root}/{path}" if path else self.root

    def exists(self, path: str) -> bool:
        return self._io.exists(self._p(path))

    def get(self, remote_path: str, local_path: str) -> None:
        src = self._p(remote_path)
        if self._io.isdir(src):
            self._io.copytree(src, local_path)
        else:
            self._io.copy(src, local_path)

    def put(self, local_path: str, remote_path: str) -> None:
        dst = self._p(remote_path)
        if os.path.isdir(local_path):
            self._io.copytree(local_path, dst)
        else:
            self._io.copy(local_path, dst)

    def listdir(self, path: str) -> list[str]:
        p = self._p(path)
        try:
            return sorted(n.rstrip("/") for n in self._io.listdir(p))
        except FileNotFoundError:
            return []

    def remove(self, path: str) -> None:
        p = self._p(path)
        if self._io.exists(p) or self._io.isdir(p):
            self._io.remove(p)

    def touch(self, path: str) -> None:
        # Binary mode: the buffered handle puts the (empty) object on close;
        # a text append of "" would skip the write and create nothing.
        with self._io.open(self._p(path), "wb") as f:
            f.write(b"")


def make_oss_store(oss_root: str, backend=None) -> RemoteStore:
    """OSS-backed store. Requires an OSS backend: pass one, or register it
    first via io_utils.set_oss_io (needs the non-baked oss2 sdk)."""
    if backend is None:
        from .io_utils import io
        if io.islocal(oss_root):
            raise RuntimeError(
                f"no oss:// backend registered for {oss_root!r}; call "
                "io_utils.set_oss_io(config) first (requires the oss2 sdk)")
    return OSSStore(oss_root, backend)


class MirrorHandler(BaseFileHandler):
    """Local cache in front of a remote store (file_handler.py:38-258).

    get: fetch remote -> local cache unless cached (``get_skip_exist``).
    put: stage locally, optionally upload (``put_skip_exist`` guards the
    remote write). ``upload_lock`` elects a single uploader per remote root
    via an atomic lock file. ``.done`` / ``.fail`` flags mark finished runs.
    """

    def __init__(self, remote: RemoteStore | str, local_root: str,
                 logger=None, get_skip_exist: bool = True,
                 put_skip_exist: bool = False, upload_lock: bool = True):
        if isinstance(remote, str):
            remote = (make_oss_store(remote)
                      if remote.startswith("oss://")
                      else FilesystemStore(remote))
        self.remote = remote
        self._local_root = os.path.abspath(str(local_root).rstrip("/"))
        Path(self._local_root).mkdir(parents=True, exist_ok=True)
        self._logger = logger
        self._get_skip_exist = get_skip_exist
        self._put_skip_exist = put_skip_exist
        # upload_lock=False bypasses the election entirely: always upload,
        # no lock file, no heartbeat.
        self._lock_enabled = bool(upload_lock)
        self._can_upload = (self._acquire_upload_lock() if upload_lock
                            else True)

    # -- paths -------------------------------------------------------------
    def getLocalPath(self, file_path: str | None = None) -> str:
        return (self._local_root if file_path is None
                else os.path.join(self._local_root, file_path))

    def localExists(self, file_path: str) -> bool:
        return os.path.exists(self.getLocalPath(file_path))

    def remoteExists(self, file_path: str) -> bool:
        return self.remote.exists(file_path)

    def hasFile(self, file_path: str) -> bool:
        return self.localExists(file_path) or self.remoteExists(file_path)

    # -- get ---------------------------------------------------------------
    def getFile(self, file_path: str, skip_exist: bool | None = None) -> bool:
        skip = self._get_skip_exist if skip_exist is None else skip_exist
        local = self.getLocalPath(file_path)
        if skip and os.path.exists(local):
            return True
        if not self.remote.exists(file_path):
            return False
        self.remote.get(file_path, local)
        return True

    def getFilePath(self, file_path: str | None = None,
                    skip_exist: bool | None = None) -> str:
        if file_path is None:
            return self._local_root
        if not self.getFile(file_path, skip_exist):
            raise FileNotFoundError(f"{file_path} missing locally and on "
                                    f"the remote store")
        return self.getLocalPath(file_path)

    # -- put ---------------------------------------------------------------
    def putFile(self, src_file_path: str, dst_file_path: str,
                skip_exist: bool | None = None, upload: bool = False) -> bool:
        local = self.getLocalPath(dst_file_path)
        if os.path.abspath(src_file_path) != os.path.abspath(local):
            Path(local).parent.mkdir(parents=True, exist_ok=True)
            if Path(src_file_path).is_dir():
                shutil.copytree(src_file_path, local, dirs_exist_ok=True)
            else:
                shutil.copy2(src_file_path, local)
        if upload:
            return self.remotePutFile(dst_file_path, skip_exist)
        return True

    def remotePutFile(self, file_path: str,
                      skip_exist: bool | None = None) -> bool:
        if not self._can_upload:
            return False
        if self._lock_enabled and not self._maybe_refresh_lock():
            return False
        skip = self._put_skip_exist if skip_exist is None else skip_exist
        if skip and self.remote.exists(file_path):
            return True
        self.remote.put(self.getLocalPath(file_path), file_path)
        return True

    # -- misc --------------------------------------------------------------
    def remoteListDir(self, dir_path: str) -> list[str]:
        return self.remote.listdir(dir_path)

    def localRemove(self, file_path: str) -> None:
        p = Path(self.getLocalPath(file_path))
        if p.is_dir():
            shutil.rmtree(p, ignore_errors=True)
        elif p.exists():
            p.unlink()

    def remoteRemove(self, file_path: str) -> None:
        self.remote.remove(file_path)

    def localClear(self) -> None:
        shutil.rmtree(self._local_root, ignore_errors=True)
        Path(self._local_root).mkdir(parents=True, exist_ok=True)

    # -- done/fail flags (file_handler.py:220-255) ---------------------------
    def remoteSetDoneFlag(self, flag_name: str, done_flag: bool = True,
                          target_dir: str = "") -> None:
        suffix = ".done" if done_flag else ".fail"
        self.remote.touch(os.path.join(target_dir, flag_name + suffix))

    def remoteDone(self, flag_name: str, target_dir: str = "") -> bool:
        return self.remote.exists(
            os.path.join(target_dir, flag_name + ".done"))

    def remoteFail(self, flag_name: str, target_dir: str = "") -> bool:
        return self.remote.exists(
            os.path.join(target_dir, flag_name + ".fail"))

    def remoteNoDoneFlag(self, flag_name: str, target_dir: str = "") -> bool:
        return not (self.remoteDone(flag_name, target_dir)
                    or self.remoteFail(flag_name, target_dir))

    # -- upload lock ---------------------------------------------------------
    # A holder refreshes its timestamp on every upload; make this comfortably
    # larger than the longest expected gap between uploads (checkpoint/PLY
    # save cadence) or a live-but-quiet run can have its lock stolen.
    LOCK_STALE_S = 3600.0

    # double-check delay before declaring an UNREADABLE meta corrupt: a
    # fresh lock is only meta-less for the instant of its atomic put
    UNREADABLE_RECHECK_S = 2.0

    def _acquire_upload_lock(self) -> bool:
        """Elect one uploader per remote root (best-effort: a
        filesystem/fuse remote has no atomic create, so the election
        settles by writing our token and reading it back — last writer
        wins, the loser stays read-only). A lock whose embedded timestamp
        is older than ``LOCK_STALE_S`` (a dead process that never released)
        is broken; an UNREADABLE meta is NEVER broken — it is respected
        with a loud warning telling the operator to delete it (stealing on
        a read error would put two uploaders on one root).
        ``release_upload_lock()`` removes the lock if this process still
        owns it (a per-acquisition token, not a bare pid — pids collide
        across hosts sharing a remote root); it runs at interpreter exit."""
        lock = "upload.lock"
        try:
            if self.remote.exists(lock):
                _, age = self._read_lock_meta(lock)
                if age is None:
                    time.sleep(self.UNREADABLE_RECHECK_S)
                    _, age = self._read_lock_meta(lock)
                if age is None:
                    if self.remote.exists(lock):
                        self._warn("upload.lock has no readable meta; "
                                   "uploads disabled — delete it from the "
                                   "remote root to recover")
                        return False
                elif age < self.LOCK_STALE_S:
                    return False
                else:
                    self._warn(f"breaking stale upload.lock (age {age:.0f}s "
                               f"> {self.LOCK_STALE_S:.0f}s)")
                    try:
                        self.remote.remove(lock)
                    except Exception:
                        return False
            import uuid
            self._lock_token = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
            self.remote.put(self._write_lock_meta(), lock)
            # settle concurrent acquisitions: whoever's token survived wins
            token, _ = self._read_lock_meta(lock)
            if token != self._lock_token:
                return False
            self._lock_refreshed = time.time()
            import atexit
            atexit.register(self.release_upload_lock)
            self._start_lock_heartbeat()
            return True
        except Exception:
            return False

    def _start_lock_heartbeat(self) -> None:
        """Background re-stamp so a live run whose gap between uploads
        exceeds LOCK_STALE_S (long eval, slow iteration band) is never
        treated as stale and demoted mid-run — without this, the heartbeat
        only fired inside putFile."""
        import threading

        self._lock_mutex = threading.Lock()

        def beat():
            while getattr(self, "_can_upload", True) is not False:
                time.sleep(self.LOCK_STALE_S / 4)
                if getattr(self, "_can_upload", False) is not True:
                    break
                self._maybe_refresh_lock()

        t = threading.Thread(target=beat, daemon=True,
                             name="upload-lock-heartbeat")
        t.start()
        self._heartbeat_thread = t

    def _lock_guard(self):
        """Mutex serializing heartbeat / putFile / atexit-release access to
        the lock meta and the shared .upload_lock_peek scratch file. Created
        by _start_lock_heartbeat; before that only one thread exists."""
        import threading
        guard = getattr(self, "_lock_mutex", None)
        if guard is None:
            guard = self._lock_mutex = threading.Lock()
        return guard

    def release_upload_lock(self) -> None:
        """Drop the remote upload lock if still OURS (idempotent; a broken
        and re-acquired lock belonging to another process is left alone).
        Demotes under the mutex FIRST so the heartbeat thread cannot re-stamp
        a fresh lock after we remove it (which would block the next run's
        uploads for up to LOCK_STALE_S)."""
        with self._lock_guard():
            if not getattr(self, "_can_upload", False):
                return
            self._can_upload = False
            try:
                token, _ = self._read_lock_meta("upload.lock")
                if token == getattr(self, "_lock_token", None):
                    self.remote.remove("upload.lock")
            except Exception:
                pass

    def _maybe_refresh_lock(self) -> bool:
        """Heartbeat: re-stamp the held lock so long active runs are never
        treated as stale by newcomers. Returns False (and demotes this
        handler) if the lock is no longer ours — it was broken as stale and
        another process acquired it; silently reclaiming would put two
        concurrent uploaders on the same root."""
        now = time.time()
        if now - getattr(self, "_lock_refreshed", 0.0) < self.LOCK_STALE_S / 4:
            return True
        with self._lock_guard():
            if not getattr(self, "_can_upload", False):
                return False        # released/demoted while we waited
            try:
                token, _ = self._read_lock_meta("upload.lock")
                if token is None:
                    # Unreadable meta: consistent with _acquire_upload_lock,
                    # never act on a failed read — if the lock was broken and
                    # taken over, re-stamping here would steal it back and put
                    # two uploaders on one root. Retry at the next heartbeat.
                    return True
                if token != getattr(self, "_lock_token", None):
                    self._can_upload = False          # lost the election
                    self._warn("upload.lock now belongs to another process; "
                               "this handler is demoted to read-only — remote "
                               "artifacts from this run will stop uploading")
                    return False
                self.remote.put(self._write_lock_meta(), "upload.lock")
                self._lock_refreshed = now
            except Exception:
                pass
            return True

    def _warn(self, msg: str) -> None:
        if self._logger is not None:
            self._logger.warning(msg)
        else:  # pragma: no cover - fallback path
            print(f"[MirrorHandler] WARNING: {msg}")

    def _read_lock_meta(self, lock: str):
        """(token, age_seconds) from the lock's meta; (None, None) if
        unreadable."""
        try:
            local = Path(self._local_root) / ".upload_lock_peek"
            self.remote.get(lock, str(local))
            token, ts_s = local.read_text().split()[:2]
            return token, time.time() - float(ts_s)
        except Exception:
            return None, None

    def _write_lock_meta(self) -> str:
        meta = Path(self._local_root) / ".upload_lock_meta"
        token = getattr(self, "_lock_token", str(os.getpid()))
        meta.write_text(f"{token} {time.time()}\n")
        return str(meta)


# Name-compat alias: the reference's OSSHandler role (local cache + remote
# mirror) is filled by MirrorHandler over whatever store the deployment has.
OSSHandler = MirrorHandler
