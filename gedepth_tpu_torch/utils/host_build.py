"""Build and load the port's host C++ sources, and read a file's bytes.

  host_library_path(source, stem) -> `_build/lib<stem>_<hash>.so`
  build_host_library(source, stem) -> ctypes.CDLL, built on first use
  read_bytes(path_or_bytes)        -> (bytes, name for messages)

A source is built with the host compiler (`CXX`, default `c++`) into the
git-ignored `_build/` under a name that carries a hash of the flags and the
source, so an edited source is built again. The PNG unfilter
(`utils.png`) and the JPEG decoder (`utils.jpeg`) are built this way, each
on its own: one that fails to build leaves the other usable.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def host_library_path(source: Path, stem: str) -> Path:
    """Where `build_host_library` keeps the build of `source`."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_host_library(source: Path, stem: str):
    """The ctypes library of `source`, built if its build is not there
    yet. A failed build raises."""
    path = host_library_path(source, stem)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cxx = os.environ.get("CXX", "c++")
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, "lib.so")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed to build {source.name} "
                                   f"({proc.returncode}):\n{proc.stderr}")
            os.replace(out, path)
    return ctypes.CDLL(str(path))


def read_bytes(src):
    """(bytes, name): a file's bytes and its path, or bytes as given."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)
