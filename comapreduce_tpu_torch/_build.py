"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles on first use with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with :mod:`ctypes` (no PyTorch headers: a build takes seconds, not the
minutes ``torch.utils.cpp_extension.load`` needs). Libraries land in
``build/comapreduce_tpu_torch/`` at the checkout root — ``.gitignore``
lists ``build/``, so nothing built is ever committed — keyed by a hash
of the source, the shared headers and the flags, so an edited kernel
rebuilds and an unchanged one loads straight away.

:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together. A missing ``nvcc`` or a failed build raises; there is no
fallback. Builds are serialised by one lock, so a campaign warm-up
thread and the main path never run ``nvcc`` on the same library twice.

These libraries are what the port compiles (eager PyTorch compiles no
programs), so they are its persistent compile cache:
:func:`set_build_dir` (``pipeline.campaign.enable_compile_cache``, the
``[ingest] compile_cache_dir`` knob) points the library directory
elsewhere, and a second process finds the libraries there without a
build. Every build and every library found on disk is reported to the
listeners of :func:`add_listener` (``pipeline.campaign.CompileCounter``
and the telemetry stream).

Host libraries (:func:`host_library`): ``csrc/<name>.cpp`` sources of
plain-C host code (the astrometry library of
:mod:`comapreduce_tpu_torch.astro.native`) build with ``g++`` and
``HOST_FLAGS`` into the same directory, keyed by the hash of the source
and the flags, and are reported to the same listeners. They are not
part of :func:`build`'s ``nvcc`` batch, so they build where there is no
``nvcc``. A missing source, a missing ``g++`` or a failed build raises.

Every CUDA C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after the launch; the
Python wrappers raise when that is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "HOST_FLAGS",
           "build", "library", "host_library", "nvcc_path", "gxx_path",
           "build_dir", "set_build_dir", "add_listener", "remove_listener",
           "c_function", "check", "count_launch", "tally_launches"]

_CSRC = Path(__file__).resolve().parent / "csrc"
#: one shared library per source, each with its own C entry points
KERNEL_SOURCES = ("masked_fill", "rolling_median", "binned_window_sum",
                  "windowed_gather", "prefilter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the g++ flags of the host libraries (the JAX package's
#: ``astro/native.py`` build's, so the code is the same bits)
HOST_FLAGS = ("-O3", "-shared", "-fPIC")

#: loaded libraries by path: a library of another directory (another
#: compile cache) is found or built there on its first use
_loaded: dict[str, ctypes.CDLL] = {}
#: the loaded library of each source in the current directory (what a
#: launch looks up)
_active: dict[str, ctypes.CDLL] = {}
_DEFAULT_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "comapreduce_tpu_torch"
#: ptxas resource reports (registers, shared memory, spills) per build
build_logs: dict[str, str] = {}
_lock = threading.RLock()
_dir_override: Path | None = None
_source_hash: dict[str, str] = {}
_listeners: list = []
_launch_lock = threading.Lock()
_thread = threading.local()


def build_dir() -> Path:
    """The library directory: :func:`set_build_dir`'s, else
    ``build/comapreduce_tpu_torch/`` at the checkout root."""
    return _DEFAULT_DIR if _dir_override is None else _dir_override


def set_build_dir(path) -> None:
    """Point the library directory at ``path`` (``None``: the default)."""
    global _dir_override
    with _lock:
        _dir_override = None if path is None else Path(path).resolve()
        _active.clear()


def add_listener(fn) -> None:
    """Call ``fn(event, name, seconds)`` on every ``"build"`` (one
    ``nvcc`` run, ``seconds`` its wall) and every ``"found"`` (a library
    loaded from disk without a build), on the thread that made it."""
    if fn not in _listeners:
        _listeners.append(fn)


def remove_listener(fn) -> None:
    if fn in _listeners:
        _listeners.remove(fn)


def _notify(event: str, name: str, seconds: float = 0.0) -> None:
    for fn in list(_listeners):
        fn(event, name, seconds)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or ``nvcc`` on ``PATH``. Raises when there is none."""
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and PATH): the CUDA kernels "
                           "cannot be built")
    return found


def _lib_path(name: str) -> Path:
    """The library of one source in the current directory; the hash of
    the sources, shared headers and flags is taken once a process."""
    digest = _source_hash.get(name)
    if digest is None:
        h = hashlib.sha256()
        for f in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = _source_hash[name] = h.hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=KERNEL_SOURCES) -> dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every named kernel library."""
    with _lock:
        paths = {n: _lib_path(n) for n in names}
        todo = [n for n in names if str(paths[n]) not in _loaded]
        procs = []
        for name in todo:
            out = paths[name]
            if out.is_file():
                _notify("found", name)
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(_CSRC), "-o",
                   str(tmp), str(_CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        failed = []
        for name, out, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (rc={proc.returncode})\n{log}")
                continue
            os.replace(tmp, out)     # atomic: a concurrent loader never
            #                          sees a half-written library
            _notify("build", name, time.perf_counter() - t0)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in todo:
            _loaded[str(paths[name])] = ctypes.CDLL(str(paths[name]))
        for name in names:
            _active[name] = _loaded[str(paths[name])]
        return {n: _active[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _active.get(name)
    if lib is None:
        lib = build((name,))[name]
    return lib


def gxx_path() -> str:
    """The host C++ compiler ``g++`` on ``PATH``; raises when there is
    none."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the host libraries "
                           "cannot be built")
    return found


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cpp``, built with
    ``g++ HOST_FLAGS`` on first use into :func:`build_dir` (named by the
    hash of the source and the flags; a concurrent loader never sees a
    half-written file). Raises on a missing source, a missing ``g++`` or
    a failed build."""
    with _lock:
        lib = _active.get(name)
        if lib is not None:
            return lib
        src = _CSRC / f"{name}.cpp"
        if not src.is_file():
            raise FileNotFoundError(f"host library source {src} not found")
        h = hashlib.sha256(src.read_bytes())
        h.update(" ".join(HOST_FLAGS).encode())
        out = build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"
        if str(out) not in _loaded:
            if out.is_file():
                _notify("found", name)
            else:
                out.parent.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [gxx_path(), *HOST_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                build_logs[name] = proc.stdout
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ failed on {src.name} "
                                       f"(rc={proc.returncode}):\n"
                                       f"{proc.stdout}")
                os.replace(tmp, out)
                _notify("build", name, time.perf_counter() - t0)
            _loaded[str(out)] = ctypes.CDLL(str(out))
        _active[name] = _loaded[str(out)]
        return _active[name]


def c_function(name: str, symbol: str, argtypes):
    """One C entry point of a kernel library, typed for ctypes (pointers
    and the stream as ``c_void_p``, so 64-bit values are never cut)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def count_launch(fn, body: str | None = None) -> None:
    """Add one to ``fn.launches`` (a kernel wrapper's counter; threads may
    launch at once), to ``fn.bodies[body]`` when the wrapper names the
    body it launched, and to the calling thread's tally, when one is open
    (:func:`tally_launches`)."""
    with _launch_lock:
        fn.launches += 1
        if body is not None:
            fn.bodies[body] += 1
    tally = getattr(_thread, "tally", None)
    if tally is not None:
        tally[fn.__name__] += 1


@contextlib.contextmanager
def tally_launches(counter):
    """Inside the block, add each kernel launch the calling thread makes
    to ``counter`` (a ``Counter`` of wrapper names; an SPMD shard's)."""
    prev = getattr(_thread, "tally", None)
    _thread.tally = counter
    try:
        yield counter
    finally:
        _thread.tally = prev
