"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

The sources under `adder_tpu_torch/csrc/` have a plain C interface (no
PyTorch headers to compile). Each `.cu` compiles to an object in its own
nvcc process, all started together, and one more nvcc call links the
objects into a shared library. The library lands in `adder_tpu_torch/build/`,
named by a digest of the sources, the headers and the flags, so an edited
source never loads a stale build. Pointers and the CUDA stream cross the
boundary as `c_void_p` (a plain int would cut them to 32 bits).

Flags that keep the kernels bit-exact with the reference:
  --fmad=false   no contraction of a product and a sum into one FMA;
  --prec-div=true and --ftz=false   IEEE division, subnormals kept.
`--use_fast_math` and `-ftz=true` must never be added.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("fused_resident.cu", "dvs_resident.cu", "davis_resident.cu",
           "fused_interval.cu", "interval_slots.cu")
HEADERS = ("adder_interval.cuh",)

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "--prec-div=true",
    "--ftz=false",
    "-Xptxas=-v",
    "-Xcompiler",
    "-fPIC",
)

_lib = None
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or (
        "/usr/local/cuda"
    )
    return os.path.join(home, "bin", "nvcc")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libadder_tpu_torch_{h.hexdigest()[:16]}.so"


def nvcc_command(out: pathlib.Path, source: str = SOURCES[0]) -> list:
    """The command that compiles one source into the object `out`."""
    return [nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(out), str(CSRC / source)]


def link_command(out: pathlib.Path, objects) -> list:
    return [nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(out), *(str(o) for o in objects)]


def build() -> pathlib.Path:
    """Compile the sources unless this exact build exists; the compiler's
    resource report (-Xptxas=-v: registers, spills) goes beside it."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{pathlib.Path(s).stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(nvcc_command(o, s), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for o, s in zip(objects, SOURCES)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, p.returncode, log)
              for s, p, log in zip(SOURCES, procs, logs) if p.returncode]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(link_command(tmp, objects), capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode:
            failed.append(("link", link.returncode, link.stderr))
    so.with_suffix(".ptxas.txt").write_text("".join(logs))
    for o in objects:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{s} ({rc}):\n{log[-4000:]}" for s, rc, log in failed))
    tmp.replace(so)
    return so


def build_log() -> str:
    """The last build's compiler output (empty when none is on disk)."""
    log = library_path().with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for entry in ("adder_resident_chunk", "adder_dvs_chunk",
                          "adder_dvs_rows", "adder_davis_chunk",
                          "adder_fused_interval", "adder_interval_slots"):
                fn = getattr(lib, entry)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.adder_exclusive_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.adder_exclusive_scan.restype = ctypes.c_int
            ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
            lib.adder_rows_keys.argtypes = [ptr, i64, ptr, ptr, ptr]
            lib.adder_rows_rank.argtypes = [ptr, ptr, ptr, i64, ctypes.c_int,
                                            ptr, ptr, ptr, ptr, ptr]
            lib.adder_rows_starts.argtypes = [ptr, ptr, i64, ptr, ptr]
            for fn in (lib.adder_rows_keys, lib.adder_rows_rank,
                       lib.adder_rows_starts):
                fn.restype = ctypes.c_int
            lib.adder_cuda_error_string.argtypes = [ctypes.c_int]
            lib.adder_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return f"{code} ({load().adder_cuda_error_string(code).decode()})"
