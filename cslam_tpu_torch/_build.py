"""Build and load the port's CUDA kernels.

At first use, nvcc compiles every `csrc/*.cu` of the package for
`sm_90a` (one nvcc process per source, all started together) and links
them into one shared library with a plain C interface, which ctypes
loads. The library lives in `cslam_tpu_torch/_build/`, named by a hash
of the sources and flags, so a changed source rebuilds and an unchanged
one is reused. Plain nvcc takes seconds for such a file; PyTorch's
extension builder takes minutes and keeps a lock file that a later run
can wait on forever, so it is not used.

A failed build raises: nothing falls back to another path.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_TIMEOUT_S = 300
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the library's entry points: (argtypes, restype)
SIGNATURES = {
    "cosine_topk_launch": ([_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P],
                           _I),
    "small_eigh_launch": ([_P, _I, _I, _P, _P, _P], _I),
    "small_qr_launch": ([_P, _I, _I, _I, _P, _P, _P], _I),
    "small_svd_launch": ([_P, _I, _I, _P, _P, _P, _P], _I),
}

_lib = None  # the loaded library
build_seconds = None  # wall seconds of this process's build, if it built


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME)")
    return found


def _run(cmds, what):
    """Run the commands in parallel; raise with the compiler's output if
    any fails or exceeds its timeout. Prints each command's output (the
    -Xptxas -v register and spill report)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        try:
            out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise RuntimeError(f"{what} timed out after {NVCC_TIMEOUT_S} s: "
                               f"{' '.join(cmd)}")
        if out.strip():
            print(out.rstrip(), flush=True)
        if p.returncode != 0:
            failed.append((cmd, p.returncode))
    if failed:
        raise RuntimeError(f"{what} failed: " + "; ".join(
            f"{' '.join(c)} -> rc {rc}" for c, rc in failed))


def library_path() -> Path:
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(SRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libcslam_tpu_torch_{h.hexdigest()[:16]}.so"


def build(out: Path) -> float:
    """Compile csrc/*.cu into `out`; returns the wall seconds taken."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(SRC_DIR.glob("*.cu"))
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    _run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
          for s, o in zip(sources, objs)], "nvcc compile")
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           *map(str, objs), "-o", str(tmp)]], "nvcc link")
    os.replace(tmp, out)
    for o in objs:
        o.unlink(missing_ok=True)
    return time.perf_counter() - t0


def load_library():
    """The kernel library, built on first use in this checkout and loaded
    once (ctypes.CDLL: its functions release the GIL for the call)."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        build_seconds = build(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib
