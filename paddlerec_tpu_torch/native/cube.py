"""The cube KV store: sharded embedding tables for the serving fleet.

Counterpart of ``paddlerec_tpu/native/cube.py``: large sparse tables leave
the model artifact and are looked up in a sharded KV store at serving time.
Shard s holds the keys with ``key % num_shards == s`` (cube's
partitioning), as sorted keys and their float32 vectors in one file
(``native/cube_kv.cpp``: mmap'd, binary search in C).  The online trainer
publishes its deltas as such shards (``train/online.py``), and
``tools/export_cube.py`` a whole checkpoint.  ``cube_server`` serves shards
over TCP in the binary framing that ``native/cube_server.cpp`` documents;
``RemoteCubeClient`` speaks it.

Both binaries are the port's own builds of the unedited sources
(``libcubekv.so``: ``g++ -shared -fPIC``; ``cube_server``: ``-pthread``) in
``build/native/`` (``native/__init__.py`` ``build_native``), so the shard
files are byte for byte those of the JAX package for the same keys and
values.  A failed build raises ``NativeUnavailable``.
"""

from __future__ import annotations

import ctypes
import os
import re
import socket
import struct
import subprocess
from typing import List, Optional

import numpy as np

from paddlerec_tpu_torch.native import build_native

_lib: Optional[ctypes.CDLL] = None


def cubekv() -> ctypes.CDLL:
    """The shard library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native("libcubekv.so", "cube_kv.cpp",
                                       ["-shared", "-fPIC"]))
        lib.cube_build.restype = ctypes.c_int
        lib.cube_build.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ]
        lib.cube_open.restype = ctypes.c_void_p
        lib.cube_open.argtypes = [ctypes.c_char_p]
        lib.cube_dim.restype = ctypes.c_long
        lib.cube_dim.argtypes = [ctypes.c_void_p]
        lib.cube_count.restype = ctypes.c_long
        lib.cube_count.argtypes = [ctypes.c_void_p]
        lib.cube_lookup.restype = ctypes.c_long
        lib.cube_lookup.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.cube_close.restype = None
        lib.cube_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def build_cube_server() -> str:
    """The cube_server daemon, built at first use (it includes
    ``cube_kv.cpp``, so a newer one rebuilds it too)."""
    return build_native("cube_server", "cube_server.cpp", ["-pthread"],
                        deps=["cube_kv.cpp"])


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class CubeShardWriter:
    @staticmethod
    def build(path: str, keys: np.ndarray, values: np.ndarray) -> str:
        keys = np.ascontiguousarray(keys, np.int64)
        values = np.ascontiguousarray(values, np.float32)
        if keys.ndim != 1 or values.ndim != 2 or len(keys) != len(values):
            raise ValueError(f"keys {keys.shape} and values {values.shape} "
                             "must be (N,) and (N, dim)")
        rc = cubekv().cube_build(path.encode(), _i64p(keys), _f32p(values),
                                 len(keys), values.shape[1])
        if rc != 0:
            raise IOError(f"cube_build failed: {rc}")
        return path


def export_table(out_dir: str, keys: np.ndarray, values: np.ndarray,
                 num_shards: int = 1) -> List[str]:
    """Split (keys, values) into ``num_shards`` cube files by key % shards:
    ``<out_dir>/cube_shard_<s>.bin``."""
    os.makedirs(out_dir, exist_ok=True)
    keys = np.asarray(keys, np.int64)
    paths = []
    for s in range(num_shards):
        sel = (keys % num_shards) == s
        path = os.path.join(out_dir, f"cube_shard_{s}.bin")
        CubeShardWriter.build(path, keys[sel], values[sel])
        paths.append(path)
    return paths


def _shard_id(path: str) -> int:
    m = re.search(r"cube_shard_(\d+)\.bin$", path)
    if m is None:
        raise ValueError(f"{path!r} is not a cube shard (expect cube_shard_<id>.bin)")
    return int(m.group(1))


class CubeClient:
    """Query a set of cube shards in this process (the cube_api.h client
    analog)."""

    def __init__(self, shard_paths: List[str],
                 default_value: Optional[np.ndarray] = None):
        self._lib = cubekv()
        if not shard_paths:
            raise ValueError(
                "no shard paths given: expected one or more "
                "cube_shard_<id>.bin files (export_table writes shards "
                "under <out_dir>/)")
        # ordered by the shard id in the file name: a lexicographic sort
        # misroutes key % shards lookups once there are 10 or more
        ordered = sorted(shard_paths, key=_shard_id)
        if [_shard_id(p) for p in ordered] != list(range(len(ordered))):
            raise ValueError(f"shard set is not contiguous: {ordered}")
        self._handles = []
        for p in ordered:
            h = self._lib.cube_open(p.encode())
            if not h:
                raise IOError(f"cube_open failed for {p}")
            self._handles.append(h)
        self.num_shards = len(self._handles)
        self.dim = int(self._lib.cube_dim(self._handles[0]))
        self._default = (np.ascontiguousarray(default_value, np.float32)
                         if default_value is not None else None)

    def seek(self, keys: np.ndarray) -> np.ndarray:
        """(N,) int64 keys → (N, dim) float32 values (zeros on a miss, or
        the default value)."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        out = np.zeros((len(keys), self.dim), np.float32)
        default = (_f32p(self._default) if self._default is not None
                   else ctypes.POINTER(ctypes.c_float)())
        for s in range(self.num_shards):
            sel = (np.arange(len(keys)) if self.num_shards == 1
                   else np.nonzero(keys % self.num_shards == s)[0])
            if not len(sel):
                continue
            sub = np.ascontiguousarray(keys[sel])
            sub_out = np.zeros((len(sel), self.dim), np.float32)
            self._lib.cube_lookup(self._handles[s], _i64p(sub), len(sel),
                                  _f32p(sub_out), default)
            out[sel] = sub_out
        return out

    def close(self):
        for h in self._handles:
            self._lib.cube_close(h)
        self._handles = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RemoteCubeClient:
    """Query a fleet of cube servers over TCP (the cube_api.h remote
    client analog).

    addrs: one "host:port" per shard id (server i holds shard i, the keys
    with key % num_shards == i); a single address means one server holds
    every shard and routes each key itself.  The framing is that of
    ``native/cube_server.cpp``.
    """

    _REQ_MAGIC = 0x43554251
    _RESP_MAGIC = 0x43554252
    _ANY_SHARD = 0xFFFFFFFF

    def __init__(self, addrs: List[str], timeout: float = 10.0):
        if not addrs:
            raise ValueError("need at least one cube server address")
        self.addrs = list(addrs)
        self._socks = []
        for a in self.addrs:
            host, _, port = a.rpartition(":")
            s = socket.create_connection((host or "127.0.0.1", int(port)),
                                         timeout=timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks.append(s)
        self.dim = self._probe_dim()

    # pure framing functions: the wire grammar lives here so that the
    # golden-bytes fixtures (tests/fixtures/cube_wire/) pin it byte for byte
    @classmethod
    def encode_request(cls, shard_id: int, keys: np.ndarray) -> bytes:
        """u32 'QBUC' | u32 shard_id | u32 n | i64 keys[n] (all LE)."""
        keys = np.ascontiguousarray(keys, "<i8")
        return struct.pack("<III", cls._REQ_MAGIC, shard_id, len(keys)) + keys.tobytes()

    @classmethod
    def decode_response_header(cls, header: bytes):
        """20-byte header → (status, dim, n, hits); raises on bad magic."""
        magic, status, dim, n, hits = struct.unpack("<IIIII", header)
        if magic != cls._RESP_MAGIC:
            raise IOError(f"bad cube response magic {magic:#x}")
        return status, dim, n, hits

    def _roundtrip(self, sock, shard_id: int, keys: np.ndarray) -> np.ndarray:
        sock.sendall(self.encode_request(shard_id, keys))
        status, dim, n, _hits = self.decode_response_header(self._read_exact(sock, 20))
        if status != 0:
            raise IOError(f"cube server error (status {status})")
        vals = self._read_exact(sock, n * dim * 4)
        return np.frombuffer(vals, "<f4").reshape(n, dim).copy()

    @staticmethod
    def _read_exact(sock, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            got = sock.recv(min(n - len(buf), 1 << 20))
            if not got:
                raise IOError("cube server closed the connection")
            buf += got
        return bytes(buf)

    def _probe_dim(self) -> int:
        out = self._roundtrip(self._socks[0], self._ANY_SHARD, np.zeros(0, np.int64))
        return out.shape[1]

    def seek(self, keys: np.ndarray) -> np.ndarray:
        """(N,) int64 keys → (N, dim) float32 (zeros on a miss), routed
        key % num_servers across the fleet."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        ns = len(self._socks)
        if ns == 1:
            return self._roundtrip(self._socks[0], self._ANY_SHARD, keys)
        out = np.zeros((len(keys), self.dim), np.float32)
        owner = keys % ns
        for s in range(ns):
            sel = np.nonzero(owner == s)[0]
            if len(sel):
                out[sel] = self._roundtrip(self._socks[s], s, keys[sel])
        return out

    def close(self) -> None:
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_cube_server(port: int, shard_paths: List[str]) -> subprocess.Popen:
    """Launch the cube_server daemon on ``port`` serving ``shard_paths``;
    returns its ``Popen`` (the caller stops it).  Returns once the daemon
    has printed its readiness line, so clients can connect at once."""
    binary = build_cube_server()
    proc = subprocess.Popen([binary, str(port), *shard_paths],
                            stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if "serving" not in line:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"cube_server failed to start: {line!r}")
    return proc
