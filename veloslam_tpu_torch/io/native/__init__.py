"""ctypes binding of the C++ packet pump (packet_pump.cpp: pcap bulk
parse and write, the UDP receiver's background thread and ring, the paced
UDP sender), built with g++ on first use.

`load()` compiles `packet_pump.cpp` into
`build/veloslam_tpu_torch/packet_pump-<hash>.so` at the repository root,
named by a hash of the source and the flags as `_build.py` names the
kernels, and binds it with the JAX loader's ctypes signatures.  Without
g++, or when the build fails, it raises: the pure-Python receiver and
sender run only when the caller asks for them (`force_python=True` in
io.udp)."""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import threading
from pathlib import Path

from veloslam_tpu_torch import _build

SRC = Path(__file__).resolve().with_name("packet_pump.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the build of packet_pump.cpp lives (hash of source + flags)."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return _build.BUILD_DIR / f"packet_pump-{digest[:16]}.so"


def _configure(lib) -> None:
    c_ll = ctypes.c_longlong
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    llp = ctypes.POINTER(c_ll)
    lib.pp_read_packets.restype = c_ll
    lib.pp_read_packets.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p, llp,
                                    llp, c_ll]
    lib.pp_count_packets.restype = c_ll
    lib.pp_count_packets.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pp_write_pcap.restype = c_ll
    lib.pp_write_pcap.argtypes = [ctypes.c_char_p, u8p, llp, c_ll,
                                  ctypes.c_int, ctypes.c_int]
    lib.pp_udp_open.restype = ctypes.c_void_p
    lib.pp_udp_open.argtypes = [ctypes.c_int, ctypes.c_int, c_ll]
    lib.pp_udp_open_any.restype = ctypes.c_void_p
    lib.pp_udp_open_any.argtypes = [ctypes.c_int, ctypes.c_int, c_ll]
    lib.pp_udp_poll.restype = c_ll
    lib.pp_udp_poll.argtypes = [ctypes.c_void_p, u8p, llp, c_ll]
    lib.pp_udp_poll_lens.restype = c_ll
    lib.pp_udp_poll_lens.argtypes = [ctypes.c_void_p, u8p, llp,
                                     ctypes.POINTER(ctypes.c_int), c_ll]
    lib.pp_udp_dropped.restype = c_ll
    lib.pp_udp_dropped.argtypes = [ctypes.c_void_p]
    lib.pp_udp_close.restype = None
    lib.pp_udp_close.argtypes = [ctypes.c_void_p]
    lib.pp_udp_send.restype = c_ll
    lib.pp_udp_send.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p, c_ll,
                                ctypes.c_int, c_ll]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the packet pump; cached per process.
    Raises _build.KernelBuildError without g++ or on a failed build."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.is_file():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise _build.KernelBuildError(
                        "g++ not found on PATH: the packet pump "
                        "(packet_pump.cpp) is compiled on first use")
                _build.compile_shared([gxx, *GXX_FLAGS, str(SRC)], out)
            lib = ctypes.CDLL(str(out))
            _configure(lib)
            _lib = lib
        return _lib
