"""Build native sources into shared libraries and load them with ctypes.

Libraries go to `tpu_raytracer_torch/_build/` (git-ignored), named by a
hash of their sources and compiler command, so an edited source rebuilds
and an unchanged one loads at once. Each build writes a private temporary
file and renames it into place, so concurrent processes cannot load a
half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

_lock = threading.Lock()
_loaded: dict = {}
# compiler output of each library built by this process (name -> text)
BUILD_LOGS: dict = {}


def load_library(name: str, sources: list, command: list,
                 timeout: float = 600.0, headers=()) -> ctypes.CDLL:
    """Build (if needed) and load `name` from `sources` with `command`,
    a compiler invocation to which `-o <out> <sources>` is appended.
    `headers` are the files the sources include: they enter the hash,
    not the command. Raises if the compiler fails."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        digest = hashlib.sha256(" ".join(command).encode())
        for src in [*sources, *headers]:
            with open(src, "rb") as f:
                digest.update(f.read())
        out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([*command, "-o", tmp, *sources],
                                  capture_output=True, text=True,
                                  timeout=timeout)
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed ({' '.join(command)}):\n"
                    f"{BUILD_LOGS[name]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _loaded[name] = lib
        return lib
