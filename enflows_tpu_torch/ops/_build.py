"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` (``elementwise.cu``: B1-B3; ``coupling.cu``: B4, B5;
``leapfrog.cu``: B6; all include ``stages.cuh``) is compiled for ``sm_90a`` by
its own ``nvcc`` process, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``enflows_tpu_torch/_build/``, under a name
that carries a hash of every source and header under ``csrc/`` and of the
flags, so an edited source is rebuilt. Nothing here runs at import time, so
the package imports on a machine with no ``nvcc``.
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
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # mode, x, gy, gladj, y, ladj, gx, P, rows, Q, Qt, scratch, loss_part,
    # p_part, w_part, q_part, words, n_stages, n, d, G, E, n_pslots, n_rows,
    # n_dense, n_acc, packed, grid, block, smem, stream
    "enf_fused_chain": [_I] + [_P] * 16 + [_I, _LL] + [_I] * 11 + [_P],
    # mode, E, block, smem, blocks_per_sm, regs, local_bytes
    "enf_chain_occupancy": [_I] * 4 + [_P] * 3,
    # x, y, ladj, Wk, P, items, item floats, n_items, layers, n_layers, n,
    # d, ldh, tm, scratch, stage inputs, smem, grid, shift, stream
    "enf_coupling_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _LL, _I, _I,
                         _I, _P, _P, _I, _I, _F, _P],
    # x, gy, gl, gx, Wk, P, items, item floats, n_items, layers, n_layers,
    # rows, d, ldh, tm, smem, grid, n_pslots, scratch, stage inputs, p_part,
    # shift, stream
    "enf_coupling_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _LL,
                         _I, _I, _I, _I, _I, _I, _P, _P, _P, _F, _P],
    # scratch, layers, n_layers, rows, nsplit, w_part, w_len, smem, stream
    "enf_coupling_dw": [_P, _P, _I, _LL, _I, _P, _LL, _I, _P],
    # q0, p0, qo, po, lp0, lpL, eps, im, mu, iv, P, rows, Q, Qt, words,
    # n_stages, n, d, G, E, nreg, n_rows, num_steps, grid, block, smem,
    # stream
    "enf_fused_leapfrog": [_P] * 15 + [_I, _LL] + [_I] * 9 + [_P],
    # E, nreg, block, smem, blocks_per_sm, regs, local_bytes
    "enf_leapfrog_occupancy": [_I] * 4 + [_P] * 3,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or in /usr/local/cuda/bin)")


def sources() -> list[Path]:
    """The ``.cu`` files compiled into the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libenflows_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the library if it is not built yet. Returns its path, the
    seconds the build took (0.0 if it was already there) and nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel).
    Raises ``RuntimeError`` with nvcc's output when a step fails."""
    so = library_path()
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    srcs = sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(srcs, objs)]
        outs = [proc.communicate() for proc in procs]
        report = "".join(err + out for out, err in outs)
        failed = [f"{src.name} (exit {proc.returncode})"
                  for src, proc in zip(srcs, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               f"{report}")
        lib = Path(tmp) / so.name
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{proc.stderr}\n{proc.stdout}")
        log.write_text(report)
        os.replace(lib, so)
    return so, time.perf_counter() - t0, report


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, with ``argtypes`` and
    ``restype`` declared for every entry point."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.enf_error_string.argtypes = [ctypes.c_int]
    lib.enf_error_string.restype = ctypes.c_char_p
    return lib
