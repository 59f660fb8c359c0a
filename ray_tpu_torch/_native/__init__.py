"""Native (C++) components of the port's runtime — built with g++ at first
use into `ray_tpu_torch/_build/` (a plain C ABI bound by ctypes). See
shm_store.cc for the object-store arena.

Nothing is built or loaded while this module is imported. A failed build
raises: the object store uses the arena unless `native_store=0` asks for
per-object segments, and it never falls back to them on its own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "shm_store.cc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_CXX = "g++"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    """The library built from the current source, compiling it if no
    build of this source exists. Raises RuntimeError if g++ fails."""
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD / f"shm_store-{digest}.so"
    if so.exists():
        return so
    _BUILD.mkdir(exist_ok=True)
    # per-process tmp name: several processes may build at once on a
    # fresh checkout, and two compilers writing one file would publish a
    # corrupt library
    tmp = _BUILD / f"shm_store-{digest}.so.{os.getpid()}.tmp"
    cmd = [_CXX, "-O2", "-fPIC", "-shared", "-std=c++17", "-o", str(tmp),
           str(_SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the shm arena failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("building the shm arena failed:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load_shm_store() -> ctypes.CDLL:
    """Load (building if needed) the arena library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        lib.rtpu_arena_create.restype = ctypes.c_void_p
        lib.rtpu_arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_arena_attach.restype = ctypes.c_void_p
        lib.rtpu_arena_attach.argtypes = [ctypes.c_char_p]
        lib.rtpu_arena_alloc.restype = ctypes.c_uint64
        lib.rtpu_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_arena_free.restype = None
        lib.rtpu_arena_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_arena_base.restype = ctypes.c_void_p
        lib.rtpu_arena_base.argtypes = [ctypes.c_void_p]
        lib.rtpu_arena_size.restype = ctypes.c_uint64
        lib.rtpu_arena_size.argtypes = [ctypes.c_void_p]
        lib.rtpu_arena_used.restype = ctypes.c_uint64
        lib.rtpu_arena_used.argtypes = [ctypes.c_void_p]
        lib.rtpu_arena_num_allocs.restype = ctypes.c_uint64
        lib.rtpu_arena_num_allocs.argtypes = [ctypes.c_void_p]
        lib.rtpu_arena_close.restype = None
        lib.rtpu_arena_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return lib


class Arena:
    """Thin OO wrapper over the C ABI. Owners allocate/free; attachers only
    read. ``view(offset, size)`` is a zero-copy memoryview into the shm."""

    def __init__(self, handle: int, lib: ctypes.CDLL, name: str, owner: bool):
        self._h = handle
        self._lib = lib
        self.name = name
        self.owner = owner
        base = lib.rtpu_arena_base(ctypes.c_void_p(handle))
        size = lib.rtpu_arena_size(ctypes.c_void_p(handle))
        self._mem = memoryview(
            (ctypes.c_ubyte * size).from_address(base)).cast("B")
        self._closed = False

    # -- construction -------------------------------------------------------
    @classmethod
    def create(cls, name: str, size: int) -> "Arena":
        """A new arena of `size` bytes at /dev/shm/<name>; raises
        OSError if shared memory cannot hold it."""
        lib = load_shm_store()
        h = lib.rtpu_arena_create(name.encode(), size)
        if not h:
            raise OSError(f"cannot create the shm arena {name} of {size} "
                          "bytes")
        return cls(h, lib, name, owner=True)

    @classmethod
    def attach(cls, name: str) -> Optional["Arena"]:
        """Map an existing arena; None if it is gone."""
        lib = load_shm_store()
        h = lib.rtpu_arena_attach(name.encode())
        if not h:
            return None
        return cls(h, lib, name, owner=False)

    # -- allocator ----------------------------------------------------------
    def alloc(self, size: int) -> int:
        """Returns payload offset, or 0 if the arena is full."""
        return self._lib.rtpu_arena_alloc(ctypes.c_void_p(self._h), size)

    def free(self, offset: int) -> None:
        self._lib.rtpu_arena_free(ctypes.c_void_p(self._h), offset)

    def view(self, offset: int, size: int) -> memoryview:
        return self._mem[offset:offset + size]

    @property
    def buf(self) -> memoryview:
        """Whole-arena view (SharedMemory.buf-compatible)."""
        return self._mem

    @property
    def used_bytes(self) -> int:
        return self._lib.rtpu_arena_used(ctypes.c_void_p(self._h))

    @property
    def num_allocs(self) -> int:
        return self._lib.rtpu_arena_num_allocs(ctypes.c_void_p(self._h))

    # -- lifecycle ----------------------------------------------------------
    def unlink_only(self) -> None:
        """Remove the shm name WITHOUT unmapping — the safe shutdown path
        when zero-copy arrays may still be alive in this process (munmap
        under a live view is a SIGSEGV; the mapping dies with the process
        and the kernel reclaims memory once all mappings drop)."""
        self._closed = True
        if self.owner:
            try:
                os.unlink(f"/dev/shm/{self.name.lstrip('/')}")
            except OSError:
                pass

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._mem.release()
        except BufferError:
            # Zero-copy views are still exported somewhere; leave the
            # mapping in place (process is usually exiting) but still remove
            # the shm name so the memory is reclaimed once mappings drop.
            if unlink and self.owner:
                try:
                    os.unlink(f"/dev/shm/{self.name.lstrip('/')}")
                except OSError:
                    pass
            return
        self._lib.rtpu_arena_close(ctypes.c_void_p(self._h),
                                   1 if unlink else 0)

    def __del__(self):
        try:
            self.close(unlink=False)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
