"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is a library with a plain ``extern "C"`` interface, built for
Hopper from the ``.cu`` sources listed in :data:`KERNELS` (they may include
headers of the same ``csrc/`` directory) into a shared library under
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``)
at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o build/kernels/lib<name>_<hash>.so <sources>

The library name carries a hash of every file under the kernel's
``csrc/`` directory (and the directories of the headers it shares), its
sources and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.
``build()`` starts one ``nvcc`` per missing library, all at once, and
waits for every one of them; the compiler's output (``-Xptxas -v``:
registers, shared memory, spills) is kept beside each library
(:func:`build_log`).  A failed build raises.  Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

_HERE = Path(__file__).resolve().parent
REPO_ROOT = _HERE.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Kernel(NamedTuple):
    """One library: its ``csrc/`` directory, the ``.cu`` files in it that
    are compiled, and the ``csrc/`` directories of other libraries whose
    headers its sources include (hashed with its own)."""
    csrc: Path
    sources: Tuple[str, ...]
    shared: Tuple[Path, ...] = ()


KERNELS = {
    "batched_cg": Kernel(_HERE / "batched_cg" / "csrc",
                         ("batched_cg.cu", "batched_cg_cluster.cu")),
    "simplex_proj": Kernel(_HERE / "simplex_proj" / "csrc",
                           ("simplex_proj.cu",)),
    "flash_attention": Kernel(_HERE / "flash_attention" / "csrc",
                              ("flash_attention.cu", "flash_attention_tc.cu")),
    "rwkv_wkv": Kernel(_HERE / "rwkv_wkv" / "csrc", ("rwkv_wkv.cu",)),
    # includes flash_attention's hopper.cuh
    "mla_attention": Kernel(_HERE / "mla_attention" / "csrc",
                            ("mla_attention.cu",),
                            (_HERE / "flash_attention" / "csrc",)),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin``, ``PATH``, or
    ``/usr/local/cuda/bin``); raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled on a "
                       "host with the CUDA toolkit (set CUDA_HOME or put "
                       "nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the built library for kernel ``name`` lives, named by a hash
    of every file under its ``csrc/`` and its ``shared`` directories (path
    and bytes), its sources and the flags."""
    kern = KERNELS[name]
    h = hashlib.sha256()
    for d in (kern.csrc,) + kern.shared:
        for f in sorted(p for p in d.rglob("*") if p.is_file()):
            h.update(f.relative_to(d.parent).as_posix().encode() + b"\0")
            h.update(f.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS + kern.sources).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output of the build of kernel ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def build(*names: str, timeout: float = 900.0) -> Dict[str, Path]:
    """Compile the named kernels (all of them when none are named) that
    are not built yet, one ``nvcc`` each, all started together."""
    names = names or tuple(KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        kern = KERNELS[name]
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(kern.csrc / src) for src in kern.sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        try:
            log, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {timeout} s"
        out.with_suffix(".log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``.  The first use of any kernel
    builds every kernel not built yet, all at once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build()[name]))
            _loaded[name] = lib
        return lib
