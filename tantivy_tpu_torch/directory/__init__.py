"""Storage abstraction — parity with reference `src/directory/`.

`Directory` is a write-once-read-many byte-file store with atomic read/write
for `meta.json`, advisory locks, and change-watching
(`src/directory/directory.rs:107-226`). Implementations:

* `RamDirectory` — in-process dict (reference `ram_directory.rs:122`); the
  hermetic-test backend.
* `FsDirectory` — filesystem with atomic rename writes and fsync on commit
  (reference `mmap_directory/mod.rs:166`; we use regular reads + np.memmap at
  the consumer layer instead of a global mmap cache).
* `ManagedDirectory` — wrapper that tracks a living-files set and garbage
  collects unreferenced files (reference `managed_directory.rs:40`), and
  appends/validates a crc32 footer on every managed file
  (reference `footer.rs:28`).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from pathlib import Path
from typing import Callable, Iterable

from ..utils.failpoints import FailPointError, fail_point

META_FILEPATH = "meta.json"
MANAGED_FILEPATH = ".managed.json"


class FileDoesNotExist(FileNotFoundError):
    pass


class LockError(RuntimeError):
    pass


class DirectoryLock:
    def __init__(self, release: Callable[[], None]):
        self._release = release

    def release(self) -> None:
        if self._release is not None:
            self._release()
            self._release = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class WatchHandle:
    def __init__(self, unsubscribe: Callable[[], None]):
        self._unsubscribe = unsubscribe

    def unsubscribe(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None


class Directory:
    """WORM file store + atomic meta ops (reference `directory.rs:107`)."""

    def open_read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list_files(self) -> list[str]:
        raise NotImplementedError

    def atomic_read(self, path: str) -> bytes:
        return self.open_read(path)

    def atomic_write(self, path: str, data: bytes) -> None:
        self.write(path, data)
        self._notify_watchers(path)

    def sync_directory(self) -> None:
        pass

    # -- locks ---------------------------------------------------------------

    def acquire_lock(self, name: str, blocking: bool = False) -> DirectoryLock:
        raise NotImplementedError

    # -- watch ---------------------------------------------------------------

    def watch(self, callback: Callable[[], None]) -> WatchHandle:
        self._watchers.append(callback)

        def unsub():
            try:
                self._watchers.remove(callback)
            except ValueError:
                pass

        return WatchHandle(unsub)

    def _notify_watchers(self, path: str) -> None:
        if path == META_FILEPATH:
            for cb in list(getattr(self, "_watchers", [])):
                cb()


class RamDirectory(Directory):
    def __init__(self):
        self._files: dict[str, bytes] = {}
        self._locks: set[str] = set()
        self._watchers: list[Callable[[], None]] = []
        self._mutex = threading.RLock()

    def open_read(self, path: str) -> bytes:
        with self._mutex:
            try:
                return self._files[path]
            except KeyError:
                raise FileDoesNotExist(path) from None

    def write(self, path: str, data: bytes) -> None:
        with self._mutex:
            self._files[path] = bytes(data)

    def delete(self, path: str) -> None:
        with self._mutex:
            if path not in self._files:
                raise FileDoesNotExist(path)
            del self._files[path]

    def exists(self, path: str) -> bool:
        with self._mutex:
            return path in self._files

    def list_files(self) -> list[str]:
        with self._mutex:
            return sorted(self._files)

    def total_mem_usage(self) -> int:
        with self._mutex:
            return sum(len(v) for v in self._files.values())

    def acquire_lock(self, name: str, blocking: bool = False) -> DirectoryLock:
        with self._mutex:
            if name in self._locks:
                raise LockError(f"lock already held: {name}")
            self._locks.add(name)

        def release():
            with self._mutex:
                self._locks.discard(name)

        return DirectoryLock(release)


class FsDirectory(Directory):
    def __init__(self, path: str | os.PathLike):
        self.root = Path(path)
        if not self.root.is_dir():
            raise NotADirectoryError(str(self.root))
        self._watchers: list[Callable[[], None]] = []

    @classmethod
    def create(cls, path: str | os.PathLike) -> "FsDirectory":
        Path(path).mkdir(parents=True, exist_ok=True)
        return cls(path)

    def _p(self, path: str) -> Path:
        return self.root / path

    def open_read(self, path: str) -> bytes:
        try:
            return self._p(path).read_bytes()
        except FileNotFoundError:
            raise FileDoesNotExist(path) from None

    def path_of(self, path: str) -> Path:
        """Real filesystem path (consumers may np.load with mmap_mode)."""
        return self._p(path)

    def write(self, path: str, data: bytes) -> None:
        tmp = self._p(path + ".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, self._p(path))

    def atomic_write(self, path: str, data: bytes) -> None:
        tmp = self._p(path + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        # crash with the tmp file written but the rename not performed:
        # the previous file contents must stay live
        fail_point("atomic-write-rename")
        os.replace(tmp, self._p(path))
        self._notify_watchers(path)

    def delete(self, path: str) -> None:
        try:
            self._p(path).unlink()
        except FileNotFoundError:
            raise FileDoesNotExist(path) from None

    def exists(self, path: str) -> bool:
        return self._p(path).exists()

    def list_files(self) -> list[str]:
        return sorted(
            p.name for p in self.root.iterdir() if p.is_file() and not p.name.endswith(".tmp")
        )

    def sync_directory(self) -> None:
        fd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def acquire_lock(self, name: str, blocking: bool = False) -> DirectoryLock:
        lock_path = self._p(name)
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raise LockError(f"lock already held: {name}") from None
        os.close(fd)

        def release():
            try:
                lock_path.unlink()
            except FileNotFoundError:
                pass

        return DirectoryLock(release)


class ManagedDirectory(Directory):
    """GC + crc32-footer wrapper (reference `managed_directory.rs`,
    `footer.rs`). Every `write` appends an 8-byte footer
    `crc32(data) || magic` validated on read."""

    _MAGIC = b"TTPU"

    def __init__(self, inner: Directory):
        self.inner = inner
        self._watchers = getattr(inner, "_watchers", [])
        self._managed: set[str] = set()
        if inner.exists(MANAGED_FILEPATH):
            self._managed = set(json.loads(inner.atomic_read(MANAGED_FILEPATH)))

    def _save_managed(self) -> None:
        self.inner.atomic_write(
            MANAGED_FILEPATH, json.dumps(sorted(self._managed)).encode()
        )

    def _register(self, path: str) -> None:
        if path not in self._managed:
            self._managed.add(path)
            self._save_managed()

    def open_read(self, path: str) -> bytes:
        data = self.inner.open_read(path)
        if len(data) < 8 or data[-4:] != self._MAGIC:
            raise IOError(f"missing footer on managed file: {path}")
        body, crc = data[:-8], int.from_bytes(data[-8:-4], "little")
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise IOError(f"crc32 mismatch on {path}")
        return body

    def write(self, path: str, data: bytes) -> None:
        self._register(path)
        crc = zlib.crc32(data) & 0xFFFFFFFF
        self.inner.write(path, data + crc.to_bytes(4, "little") + self._MAGIC)

    def validate_checksum(self, path: str) -> bool:
        try:
            self.open_read(path)
            return True
        except IOError:
            return False

    def delete(self, path: str) -> None:
        self.inner.delete(path)

    def exists(self, path: str) -> bool:
        return self.inner.exists(path)

    def list_files(self) -> list[str]:
        return self.inner.list_files()

    def atomic_read(self, path: str) -> bytes:
        return self.inner.atomic_read(path)

    def atomic_write(self, path: str, data: bytes) -> None:
        self.inner.atomic_write(path, data)

    def sync_directory(self) -> None:
        self.inner.sync_directory()

    def acquire_lock(self, name: str, blocking: bool = False) -> DirectoryLock:
        return self.inner.acquire_lock(name, blocking)

    def watch(self, callback: Callable[[], None]) -> WatchHandle:
        return self.inner.watch(callback)

    def garbage_collect(self, living_files: Iterable[str]) -> list[str]:
        """Delete managed files not in `living_files` (reference
        `managed_directory.rs:109`). Returns deleted paths."""
        living = set(living_files) | {META_FILEPATH, MANAGED_FILEPATH}
        deleted = []
        for path in sorted(self._managed - living):
            if self.inner.exists(path):
                try:
                    fail_point("managed-dir-delete")
                    self.inner.delete(path)
                    deleted.append(path)
                except FileDoesNotExist:
                    pass
                except (FailPointError, OSError):
                    # recoverable delete failure: keep the path managed so
                    # a later GC pass retries it (reference
                    # managed_directory.rs logs and leaves the file listed)
                    continue
            self._managed.discard(path)
        if deleted:
            self._save_managed()
        return deleted
