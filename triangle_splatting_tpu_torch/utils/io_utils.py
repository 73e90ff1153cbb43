"""Pluggable IO abstraction (port of ``triangle_splatting_tpu/utils/io_utils.py``;
host-side Python, the same code: the port keeps its own module-level ``io``
registry, which the JAX package's does not share).

``DefaultIO`` covers the local filesystem with the reference's full method
surface (open/exists/move/copy/copytree/makedirs/remove/rmtree/listdir/
isdir/isfile/abspath/last_modified/size/md5). Remote backends register via
``IO.register``; ``OSSIO`` is the Alibaba-OSS backend (reference
io_utils.py:232-825) and lazily imports the ``oss2`` sdk at construction
(an optional dependency — tests exercise it against an in-memory fake;
a fuse-mounted bucket + DefaultIO also works). The
module-level singleton ``io`` dispatches by path prefix.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
import shutil
import time
from datetime import datetime, timedelta
from io import BytesIO, StringIO
from pathlib import Path

logger = logging.getLogger(__name__)

# Two-path methods must route to the remote backend when EITHER endpoint
# is remote (download / upload / remote-to-remote) — the reference gets
# this by subclass-override (OSSIO.copy handles all four combinations,
# io_utils.py:405-483); our prefix dispatcher checks both arguments.
_TWO_PATH_METHODS = frozenset({"move", "copy", "copytree", "safe_copy"})


class IO:
    """Dispatching facade: backends register with a path prefix."""

    def __init__(self):
        self._backends: list[tuple[str, "DefaultIO"]] = []
        self._default = DefaultIO()

    def register(self, prefix: str, backend: "DefaultIO") -> None:
        """Register (or replace) the backend owning a path prefix."""
        self._backends = [(p, b) for p, b in self._backends if p != prefix]
        self._backends.append((prefix, backend))

    def _match(self, path: str):
        path = str(path)
        for prefix, backend in self._backends:
            if path.startswith(prefix):
                return backend
        return None

    def _for(self, path: str) -> "DefaultIO":
        return self._match(path) or self._default

    def islocal(self, path) -> bool:
        return self._for(path) is self._default

    def __getattr__(self, name):
        def dispatch(path, *args, **kwargs):
            backend = self._match(path)
            if backend is None and name in _TWO_PATH_METHODS and args:
                backend = self._match(args[0])     # local -> remote upload
            return getattr(backend or self._default, name)(
                path, *args, **kwargs)
        return dispatch


class DefaultIO:
    """Local-filesystem IO (reference io_utils.py:120-229)."""

    def open(self, path, mode="r"):
        if "w" in mode or "a" in mode:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        return open(path, mode)

    def exists(self, path) -> bool:
        return os.path.exists(path)

    def move(self, src, dst):
        Path(dst).parent.mkdir(parents=True, exist_ok=True)
        shutil.move(src, dst)

    def copy(self, src, dst):
        Path(dst).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, dst)

    def copytree(self, src, dst):
        shutil.copytree(src, dst, dirs_exist_ok=True)

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)

    def remove(self, path):
        if os.path.isfile(path):
            os.remove(path)

    def rmtree(self, path):
        shutil.rmtree(path, ignore_errors=True)

    def listdir(self, path, recursive=False, full_path=False, contains=None):
        if recursive:
            names = [os.path.join(r, f) for r, _, fs in os.walk(path)
                     for f in fs]
            names = [os.path.relpath(n, path) for n in names]
        else:
            names = sorted(os.listdir(path))
        if contains is not None:
            pats = [contains] if isinstance(contains, str) else list(contains)
            names = [n for n in names if any(p in n for p in pats)]
        if full_path:
            names = [os.path.join(path, n) for n in names]
        return names

    def isdir(self, path) -> bool:
        return os.path.isdir(path)

    def isfile(self, path) -> bool:
        return os.path.isfile(path)

    def abspath(self, path) -> str:
        return os.path.abspath(path)

    def last_modified(self, path) -> datetime:
        return datetime.fromtimestamp(os.path.getmtime(path))

    def last_modified_str(self, path) -> str:
        return self.last_modified(path).strftime("%Y-%m-%d %H:%M:%S")

    def size(self, path) -> int:
        return os.path.getsize(path)

    def md5(self, path) -> str:
        h = hashlib.md5()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()


_OSS_PATH = re.compile(r"^oss://([^/]+)/(.+)$")
_BIG = 100 * 1024 ** 2          # progress / atomic-download threshold
_UPLOAD_LIMIT = 5 * 1024 ** 3   # single put_object_from_file cap
_MULTIPART_MIN = 1024 ** 3      # same-bucket copies above this go multipart


def _with_retries(fn, what: str, attempts: int = 10, delay: float = 3.0,
                  no_retry: tuple = ()):
    """Run ``fn`` with flat retries (reference io_utils.py:292-302: OSS
    calls fail transiently; 10 tries, 3 s apart). Exceptions in
    ``no_retry`` are raised immediately — for failures that can never
    succeed on retry (e.g. a 409 concurrent-writer position mismatch)."""
    for n in range(attempts):
        try:
            return fn()
        except no_retry:
            raise
        except Exception as e:                     # noqa: BLE001
            if n + 1 == attempts:
                raise
            logger.warning("%s failed (%s), retry %d/%d", what, e,
                           n + 1, attempts)
            time.sleep(delay)


class _AppendFile:
    """Text-mode ``w``/``a`` handle backed by OSS append-object.

    Mirrors the reference's OSSFile (io_utils.py:644-724): plain
    ``write`` pushes immediately (appending at the tracked position, with
    the 409 PositionNotEqualToLength race surfaced as an actionable
    error); used as a context manager it exposes the buffer and uploads
    once on exit.
    """

    def __init__(self, oss, bucket, key, position=0):
        self._oss = oss
        self._bucket = bucket
        self._key = key
        self.position = position
        self.buffer = StringIO()

    def write(self, content: str):
        pending = self.buffer.getvalue()
        if pending:
            content = pending + content
            self.buffer = StringIO()
        try:
            res = self._bucket.append_object(self._key, self.position,
                                             content)
            self.position = res.next_position
        except self._oss.exceptions.PositionNotEqualToLength:
            raise RuntimeError(
                f"append position mismatch on oss://"
                f"{self._bucket.bucket_name}/{self._key} "
                "(409 PositionNotEqualToLength): concurrent writers, or a "
                "retried append whose first attempt already landed "
                "server-side (lost response)") from None
        except (self._oss.exceptions.RequestError,
                self._oss.exceptions.ServerError) as e:
            self.buffer.write(content)   # keep the bytes; retried on flush
            logger.error("buffered write to oss://%s/%s after %s",
                         self._bucket.bucket_name, self._key, e)

    def flush(self):
        data = self.buffer.getvalue()
        if not data:
            return
        try:
            # A 409 position mismatch means another writer advanced the
            # object — retrying at the same position can never succeed, so
            # it skips the retry loop and surfaces the same actionable
            # error write() raises.
            res = _with_retries(
                lambda: self._bucket.append_object(self._key, self.position,
                                                   data),
                what=f"append oss://{self._bucket.bucket_name}/{self._key}",
                attempts=3, delay=5.0,
                no_retry=(self._oss.exceptions.PositionNotEqualToLength,))
        except self._oss.exceptions.PositionNotEqualToLength:
            raise RuntimeError(
                f"append position mismatch on oss://"
                f"{self._bucket.bucket_name}/{self._key} "
                "(409 PositionNotEqualToLength): concurrent writers, or a "
                "retried append whose first attempt already landed "
                "server-side (lost response)") from None
        except self._oss.exceptions.ObjectNotAppendable:
            # The object was created by a plain put (not appendable):
            # rewrite it as one appendable object with old + new content
            # (reference io_utils.py:688-712).
            old = self._bucket.get_object(self._key).read()
            if isinstance(old, bytes):
                old = old.decode()
            self._bucket.delete_object(self._key)
            self.position = 0
            res = self._bucket.append_object(self._key, 0, old + data)
        self.position = res.next_position
        self.buffer = StringIO()

    def seek(self, position: int):
        self.position = position

    def close(self):
        self.flush()

    def __enter__(self):
        return self.buffer

    def __exit__(self, *exc):
        self.flush()


class _BufferedBinaryFile:
    """Binary ``wb`` handle: buffer locally, one put_object on close
    (reference BinaryOSSFile, io_utils.py:727-742)."""

    def __init__(self, bucket, key):
        self._bucket = bucket
        self._key = key
        self.buffer = BytesIO()

    def write(self, data: bytes):
        self.buffer.write(data)

    def flush(self):
        pass

    def close(self):
        self._bucket.put_object(self._key, self.buffer.getvalue())

    def __enter__(self):
        return self.buffer

    def __exit__(self, *exc):
        self.close()


class _ReadHandle:
    """Context-manager wrapper over an in-memory read buffer (reference
    NullContextWrapper, io_utils.py:745-762)."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        return getattr(self._obj, name)

    def __iter__(self):
        return iter(self._obj)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class OSSIO(DefaultIO):
    """Alibaba-OSS object-store backend (reference io_utils.py:232-638).

    Paths are ``oss://<bucket>/<key>``; non-OSS paths fall through to the
    local DefaultIO methods (the facade normally routes those directly,
    but two-path ops like ``copy(local, oss://...)`` land here with one
    local endpoint). Construction requires the ``oss2`` sdk.
    """

    def __init__(self, access_key_id: str, access_key_secret: str,
                 hosts, buckets):
        import oss2
        super().__init__()
        self._oss = oss2
        self._auth = oss2.Auth(access_key_id, access_key_secret)
        if isinstance(buckets, str):
            buckets = [buckets]
        if isinstance(hosts, str):
            hosts = [hosts] * len(buckets)
        if len(hosts) != len(buckets):
            raise ValueError(
                f"{len(hosts)} hosts for {len(buckets)} buckets — provide "
                "one host per bucket or a single shared host")
        self._buckets = {
            name: oss2.Bucket(self._auth, host, name)
            for host, name in zip(hosts, buckets)
        }

    # -- path plumbing ----------------------------------------------------

    @staticmethod
    def _is_oss(path) -> bool:
        return str(path).startswith("oss://")

    def _split(self, path: str):
        m = _OSS_PATH.match(str(path))
        if not m:
            raise IOError(f'invalid oss path "{path}" '
                          '(want oss://<bucket>/<key>)')
        name, key = m.groups()
        name = name.split(".")[0]      # host-qualified bucket names
        try:
            return self._buckets[name], key.replace("//", "/")
        except KeyError:
            raise IOError(f"bucket {name!r} not registered "
                          f"(have {sorted(self._buckets)})") from None

    def _head_exists(self, bucket, key) -> bool:
        try:
            bucket.head_object(key)
            return True
        except Exception:              # noqa: BLE001
            return False

    # -- core methods -------------------------------------------------------

    def open(self, path, mode="r"):
        if not self._is_oss(path):
            return super().open(path, mode)
        bucket, key = self._split(path)
        if "w" in mode:
            if self._head_exists(bucket, key):
                bucket.delete_object(key)
            if "b" in mode:
                return _BufferedBinaryFile(bucket, key)
            return _AppendFile(self._oss, bucket, key)
        if mode == "a":
            pos = (bucket.head_object(key).content_length
                   if self._head_exists(bucket, key) else 0)
            return _AppendFile(self._oss, bucket, key, position=pos)
        if mode not in ("r", "rb"):
            raise ValueError(f"unsupported OSS open mode {mode!r}")
        if not self.exists(path):
            raise FileNotFoundError(path)
        data = _with_retries(lambda: bucket.get_object(key).read(),
                             what=f"read {path}")
        buf = BytesIO(data) if mode == "rb" else StringIO(data.decode())
        return _ReadHandle(buf)

    def exists(self, path) -> bool:
        if not self._is_oss(path):
            return super().exists(path)
        bucket, key = self._split(path)
        if not str(path).endswith("/"):
            if _with_retries(lambda: bucket.object_exists(key),
                             what=f"exists {path}"):
                return True
            key += "/"                 # fall through to directory marker
        return self._head_exists(bucket, key)

    def move(self, src, dst):
        if not self._is_oss(src) and not self._is_oss(dst):
            return super().move(src, dst)
        if src == dst:
            return
        self.copy(src, dst)
        self.remove(src)

    def safe_copy(self, src, dst, try_max: int = 5):
        """Best-effort copy (reference io_utils.py:384-398)."""
        for _ in range(try_max):
            try:
                return self.copy(src, dst)
            except Exception:          # noqa: BLE001
                pass
        logger.error("oss copy %s -> %s failed %d times, giving up",
                     src, dst, try_max)

    def copy(self, src, dst):
        cloud_src, cloud_dst = self._is_oss(src), self._is_oss(dst)
        if not cloud_src and not cloud_dst:
            return super().copy(src, dst)
        if src == dst:
            return
        if cloud_src and not cloud_dst:             # download
            parent = os.path.dirname(dst)
            if parent:
                os.makedirs(parent, exist_ok=True)
            bucket, key = self._split(src)
            # Atomic: fetch to a pid-unique temp then rename, so readers
            # never observe a half-written file (io_utils.py:400-404).
            tmp = f"{dst}.tmp_{os.getpid()}"
            bucket.get_object_to_file(key, tmp)
            os.replace(tmp, dst)
            return
        if cloud_dst and not cloud_src:             # upload
            bucket, key = self._split(dst)
            if os.stat(src).st_size > _UPLOAD_LIMIT:
                raise RuntimeError(
                    f"{src} exceeds the 5 GB single-object upload limit; "
                    "split it first")
            bucket.put_object_from_file(key, src)
            return
        # remote -> remote
        src_bucket, src_key = self._split(src)
        dst_bucket, dst_key = self._split(dst)
        if (src_bucket.get_bucket_location().location
                != dst_bucket.get_bucket_location().location):
            # Cross-region: bounce through a local temp file.
            import tempfile
            local = os.path.join(tempfile.gettempdir(),
                                 "ossio_xfer", src_key)
            self.copy(src, local)
            try:
                self.copy(local, dst)
            finally:
                os.remove(local)
            return
        total = src_bucket.head_object(src_key).content_length
        if total < _MULTIPART_MIN or src_bucket is not dst_bucket:
            dst_bucket.copy_object(src_bucket.bucket_name, src_key, dst_key)
            return
        # Large same-bucket object: server-side multipart ranges.
        determine_part_size = self._oss.determine_part_size
        PartInfo = self._oss.models.PartInfo
        part_size = determine_part_size(total, preferred_size=_BIG)
        upload_id = dst_bucket.init_multipart_upload(dst_key).upload_id
        parts, offset, n = [], 0, 1
        while offset < total:
            span = min(part_size, total - offset)
            res = dst_bucket.upload_part_copy(
                dst_bucket.bucket_name, src_key,
                (offset, offset + span - 1), dst_key, upload_id, n)
            parts.append(PartInfo(n, res.etag))
            offset += span
            n += 1
        dst_bucket.complete_multipart_upload(dst_key, upload_id, parts)

    def copytree(self, src, dst):
        cloud_src, cloud_dst = self._is_oss(src), self._is_oss(dst)
        if not cloud_src and not cloud_dst:
            return super().copytree(src, dst)
        names = self.listdir(src, recursive=True)
        for name in names:
            s = f"{str(src).rstrip('/')}/{name}"
            d = f"{str(dst).rstrip('/')}/{name}"
            if not self._is_oss(d):
                os.makedirs(os.path.dirname(d) or ".", exist_ok=True)
            self.copy(s, d)

    def listdir(self, path, recursive=False, full_path=False, contains=None):
        if not self._is_oss(path):
            return super().listdir(path, recursive, full_path, contains)
        if isinstance(contains, str):
            contains = [contains]
        bucket, key = self._split(path)
        prefix = key.rstrip("/") + "/"
        delimiter = "" if recursive else "/"
        names = [obj.key for obj in
                 self._oss.ObjectIterator(bucket, prefix=prefix,
                                          delimiter=delimiter)]
        names = [n for n in names if n != prefix]
        if not names and not self._head_exists(bucket, prefix):
            raise FileNotFoundError(
                f"no such directory: oss://{bucket.bucket_name}/{prefix}")
        names = [n[len(prefix):] for n in names]
        if contains:
            names = [n for n in names if any(p in n for p in contains)]
        if full_path:
            names = [f"oss://{bucket.bucket_name}/{prefix}{n}"
                     for n in names]
        return names

    def makedirs(self, path, exist_ok=True):
        if not self._is_oss(path):
            super().makedirs(path, exist_ok)
        # object stores have no directories — nothing to create

    def remove(self, path, is_dir=None):
        if not self._is_oss(path):
            return super().remove(path)
        if is_dir is None:
            is_dir = self.isdir(path)
        if is_dir:
            return self.rmtree(path)
        bucket, key = self._split(path)
        bucket.delete_object(key)

    def rmtree(self, path):
        if not self._is_oss(path):
            return super().rmtree(path)
        for child in self.listdir(path, recursive=True, full_path=True):
            bucket, key = self._split(child)
            bucket.delete_object(key)
        if self.exists(path):          # explicit directory-marker object
            bucket, key = self._split(str(path).rstrip("/") + "/")
            bucket.delete_object(key)

    def isdir(self, path) -> bool:
        if not self._is_oss(path):
            return super().isdir(path)
        try:
            self.listdir(str(path).rstrip("/") + "/")
            return True
        except FileNotFoundError:
            return False

    def isfile(self, path) -> bool:
        if not self._is_oss(path):
            return super().isfile(path)
        return self.exists(path) and not self.isdir(path)

    def abspath(self, path) -> str:
        return path if self._is_oss(path) else super().abspath(path)

    def authorize(self, path):
        """Make an object world-readable (reference io_utils.py:592-598)."""
        if not self._is_oss(path):
            raise ValueError("authorize applies to oss:// paths only")
        bucket, key = self._split(path)
        bucket.put_object_acl(key, self._oss.OBJECT_ACL_PUBLIC_READ)

    def last_modified(self, path) -> datetime:
        if not self._is_oss(path):
            return super().last_modified(path)
        # OSS reports HTTP-date GMT; the reference normalizes to UTC+8.
        return datetime.strptime(
            self.last_modified_str(path),
            r"%a, %d %b %Y %H:%M:%S %Z") + timedelta(hours=8)

    def last_modified_str(self, path) -> str:
        if not self._is_oss(path):
            return super().last_modified_str(path)
        bucket, key = self._split(path)
        return bucket.get_object_meta(key).headers["Last-Modified"]

    def size(self, path) -> int:
        if not self._is_oss(path):
            return super().size(path)
        bucket, key = self._split(path)
        return int(bucket.get_object_meta(key).headers["Content-Length"])

    def md5(self, path) -> str:
        if not self._is_oss(path):
            return super().md5(path)
        with self.open(path, "rb") as f:
            return hashlib.md5(f.read()).hexdigest()


def make_oss_io(access_key_id: str, access_key_secret: str, hosts,
                buckets) -> OSSIO:
    """OSS backend factory — requires the oss2 sdk (not baked into the GPU
    image; any environment with it installed gets the full backend)."""
    return OSSIO(access_key_id, access_key_secret, hosts, buckets)


def set_oss_io(oss_config) -> OSSIO:
    """Build an OSSIO from a config mapping/namespace with ak_id/ak_secret/
    hosts/buckets and register it on the ``oss://`` prefix of the global
    ``io`` (reference io_utils.py:791-797 mutates a module singleton; here
    registration is additive — local paths keep DefaultIO)."""
    def get(k):
        if hasattr(oss_config, k):
            return getattr(oss_config, k)
        try:
            return oss_config[k]
        except (TypeError, KeyError):
            raise ValueError(
                "oss_config must provide ak_id/ak_secret/hosts/buckets"
            ) from None
    backend = make_oss_io(get("ak_id"), get("ak_secret"), get("hosts"),
                          get("buckets"))
    io.register("oss://", backend)
    return backend


io = IO()
