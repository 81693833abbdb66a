"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c

compiles each `circulantpreconditioner_tpu_torch/csrc/*.cu` (K1 to K7, the span
marker) into an object,
one nvcc process per source, all started together; `nvcc -shared` then links
them into
`circulantpreconditioner_tpu_torch/build/libcirculant_kernels-<hash>.so`, where
<hash> is a digest of the sources: the first use after a source change
rebuilds, later uses load the existing file. The library has a plain C
interface bound with ctypes (pointers and the stream as c_void_p, ints as
c_int or c_longlong, each entry returning its cudaError_t), so no PyTorch
headers are compiled. nvcc is taken from $CUDA_HOME/bin, /usr/local/cuda/bin or PATH; a
failed build raises with nvcc's output. ptxas's register and shared-memory
report is kept beside the library as <name>.log.

    python -m circulantpreconditioner_tpu_torch.native.build   # build now
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from circulantpreconditioner_tpu_torch.utils.profiling import host_spanned

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)  # a host int array (K1's plan, K5's grid)
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host pointer array (K5's coefficient fields)
_LP = ctypes.POINTER(ctypes.c_longlong)  # a host int64 array (K5's offsets)
# entry point → argtypes; restype is c_int (cudaError_t) unless listed below
_SIGNATURES = {
    "k1_fused_circulant_solve": [_P] * 7 + [_IP] + [_I] * 5 + [_P],
    "k1_scratch_floats": [_IP, _I, _I, _I],
    "k1_error_string": [_I],
    "k2_plane_stencil": [_P] * 5 + [_L, _I, _I] + [_L] * 6 + [ctypes.c_double, _I, _I, _P],
    "k2_error_string": [_I],
    "k3_complex_matmul": [_P] * 6 + [_I] * 5 + [_P],
    "k3_error_string": [_I],
    "k4_tier_matmul": [_P] * 3 + [_I, _L, _I, _L, _I] + [_L] * 4 + [_I, _I, _I, _P],
    "k4_row_words": [_I],
    "k4_error_string": [_I],
    "k5_smooth": [_P] * 3 + [_L, _I, ctypes.c_double, _I, _I, _P],
    "k5_restrict": [_P, _P, _PP, _LP, _I, _P, _P, _IP] + [_I] * 3 + [_P],
    "k5_sweep": [_P, _P, _P, _PP, _LP, _I, _P, _P, _IP, _I, ctypes.c_double, _I, _I, _P],
    "k5_error_string": [_I],
    "k6_block_jacobi": [_P] * 5 + [_L, _I, _I, _I, ctypes.c_double, _I, _I, _P],
    "k6_error_string": [_I],
    "k7_supercell_stencil": [_P] * 6 + [_L, _I, _I, _I, ctypes.c_double, _I, _I, _P],
    "k7_error_string": [_I],
    "span_mark": [_P, _I, _I, _I, _I, _P, ctypes.POINTER(ctypes.c_void_p)],
    "span_set_enabled": [_P, ctypes.POINTER(ctypes.c_void_p), _I, _I],
    "span_error_string": [_I],
}
_RESTYPES = {"k1_error_string": ctypes.c_char_p, "k1_scratch_floats": _L,
             "k2_error_string": ctypes.c_char_p, "k3_error_string": ctypes.c_char_p,
             "k4_error_string": ctypes.c_char_p, "k5_error_string": ctypes.c_char_p,
             "k6_error_string": ctypes.c_char_p, "k7_error_string": ctypes.c_char_p,
             "span_error_string": ctypes.c_char_p}


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC}")
    return srcs


def _library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcirculant_kernels-{h.hexdigest()[:16]}.so"


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, /usr/local/cuda/bin or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built on the machine with the GPU")
    return found


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc


def build(force: bool = False) -> tuple[Path, float]:
    """Compile the kernels if the library for the current sources is missing
    (or force=True). Returns (library path, seconds spent compiling)."""
    lib = _library_path()
    if lib.is_file() and not force:
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        with ThreadPoolExecutor(max_workers=len(objs)) as pool:
            compiled = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                       for src, o in zip(_sources(), objs)]))
        out = Path(tmp) / "lib.so"
        _run([nvcc, "-shared", "-o", str(out), *map(str, objs)])
        os.replace(out, lib)
    seconds = time.perf_counter() - t0
    lib.with_suffix(".log").write_text("".join(p.stdout + p.stderr for p in compiled))
    return lib, seconds


@functools.lru_cache(maxsize=1)
@host_spanned("port.setup.kernels")
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


if __name__ == "__main__":
    path, secs = build(force=True)
    print(f"built {path} in {secs:.1f} s")
    print(path.with_suffix(".log").read_text())
