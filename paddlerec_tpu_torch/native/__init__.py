"""The port's builds of the repository's native (C++) components, the
counterpart of ``paddlerec_tpu/native/``: the graph engine (``graph.py``),
the cube KV store with its server (``cube.py``), the multithreaded slot-text
parser ``libfastreader`` (``fastreader()``, read by ``reader.py``) and the
``criteo_parser`` preprocess filter (``build_criteo_parser()``, a
``pipe_command``).

Each source under ``native/`` is read as it is and compiled with ``g++ -O3
-std=c++17`` into the port's git-ignored ``build/native/``, never into
``native/build/``, which belongs to the JAX package.  A target is rebuilt
when a source it reads is newer; the compiler writes a temporary file that
is renamed into place, so that processes building at once never load a
half-written file.  Without ``g++``, or when the compiler fails, the build
raises ``NativeUnavailable``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


class NativeUnavailable(RuntimeError):
    pass


def build_native(target: str, source: str, flags: Sequence[str],
                 deps: Sequence[str] = ()) -> str:
    """Compile ``native/<source>`` into ``build/native/<target>`` unless the
    target is newer than it and every file of ``deps`` (sources it
    includes); returns the target's path."""
    out = BUILD_DIR / target
    srcs = [NATIVE_DIR / s for s in (source, *deps)]
    if out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{target}.", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", *flags, "-o", tmp, str(srcs[0])]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        raise NativeUnavailable(
            f"building {target} failed: {getattr(e, 'stderr', None) or e}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(out)


def build_criteo_parser() -> str:
    """Build (if needed) and return the ``criteo_parser`` binary: raw Criteo
    TSV on stdin → slot text on stdout."""
    return build_native("criteo_parser", "criteo_parser.cpp", ())


_fastreader: Optional[ctypes.CDLL] = None


def fastreader() -> ctypes.CDLL:
    """``native/fast_reader.cpp`` built as a shared library, with the
    argument types of ``frd_parse_file``, ``frd_parse_buffer`` and
    ``frd_count_lines`` set."""
    global _fastreader
    if _fastreader is None:
        so = build_native("libfastreader.so", "fast_reader.cpp",
                          ("-shared", "-fPIC", "-pthread"))
        lib = ctypes.CDLL(so)
        outs = [ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float)]
        lib.frd_parse_file.restype = ctypes.c_long
        lib.frd_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
            ctypes.c_int, *outs]
        lib.frd_parse_buffer.restype = ctypes.c_long
        lib.frd_parse_buffer.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, ctypes.c_int, *outs]
        lib.frd_count_lines.restype = ctypes.c_long
        lib.frd_count_lines.argtypes = [ctypes.c_char_p]
        _fastreader = lib
    return _fastreader
