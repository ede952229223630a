"""ctypes bindings for the native tar indexer (GIL-free positional reads;
counterpart of ``aki_tpu/data/native_tar.py``).

``aki_torch/native/tar_index.cpp`` is built with ``g++`` at first use into
``build/aki_torch/libtar_index-<hash>.so`` at the root of the checkout (the
hash covers the source and the flags; git ignores ``build/``). Where no
compiler is found the data layer reads shards with Python ``tarfile``
instead: the same samples, more slowly (:func:`reader` says which runs).

Use :class:`NativeTarShard` for map-style random access and
:func:`iter_samples` for webdataset-style streaming grouped by key, both
backed by pread, so worker threads fetch and decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

from ..ops.cuda_build import BUILD_DIR

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parents[1] / "native" / "tar_index.cpp"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libtar_index-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def _load_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except Exception as e:  # noqa: BLE001 — fall back to tarfile
            log.warning("native tar indexer unavailable (%r); using tarfile", e)
            _build_failed = True
            return None
        lib.tar_index_open.restype = ctypes.c_void_p
        lib.tar_index_open.argtypes = [ctypes.c_char_p]
        lib.tar_index_count.restype = ctypes.c_int64
        lib.tar_index_count.argtypes = [ctypes.c_void_p]
        lib.tar_index_entry.restype = ctypes.c_int
        lib.tar_index_entry.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tar_index_read.restype = ctypes.c_int64
        lib.tar_index_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_char_p,
        ]
        lib.tar_index_close.restype = None
        lib.tar_index_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def reader() -> str:
    """The shard reader the data layer runs: ``"native"`` or ``"tarfile"``."""
    return "native" if native_available() else "tarfile"


class NativeTarShard:
    """Random-access view of one tar shard: entries -> (offset, size)."""

    def __init__(self, path: str):
        self.path = str(path)
        lib = _load_lib()
        self._lib = lib
        self._handle = None
        self.entries: list[tuple[str, int, int]] = []
        if lib is not None:
            h = lib.tar_index_open(self.path.encode())
            if h:
                self._handle = ctypes.c_void_p(h)
                n = lib.tar_index_count(self._handle)
                name = ctypes.create_string_buffer(4096)
                off = ctypes.c_uint64()
                size = ctypes.c_uint64()
                for i in range(n):
                    if lib.tar_index_entry(self._handle, i, name, 4096,
                                           ctypes.byref(off),
                                           ctypes.byref(size)) == 0:
                        self.entries.append(
                            (name.value.decode(), off.value, size.value)
                        )
                return
        # fallback: python tarfile index
        import tarfile

        with tarfile.open(self.path) as tf:
            for m in tf:
                if m.isfile():
                    self.entries.append(
                        (m.name, m.offset_data, m.size)
                    )

    def __len__(self):
        return len(self.entries)

    def read(self, offset: int, size: int) -> bytes:
        if self._handle is not None:
            buf = ctypes.create_string_buffer(size)
            got = self._lib.tar_index_read(self._handle, offset, size, buf)
            return buf.raw[: max(got, 0)]
        with open(self.path, "rb") as f:
            f.seek(offset)
            return f.read(size)

    def close(self):
        if self._handle is not None and self._lib is not None:
            self._lib.tar_index_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def iter_samples(path: str):
    """Webdataset-style sample dicts via the native index (key-grouped)."""
    shard = NativeTarShard(path)
    sample: dict = {}
    for name, off, size in shard.entries:
        base = name.rsplit("/", 1)[-1]
        if "." not in base:
            continue
        key, ext = base.split(".", 1)
        ext = ext.lower()
        if sample and (sample.get("__key__") != key or ext in sample):
            yield sample
            sample = {}
        sample.setdefault("__key__", key)
        sample[ext] = shard.read(off, size)
    if sample:
        yield sample
    shard.close()
