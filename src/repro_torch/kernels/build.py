"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each kernel source under ``kernels/<name>/csrc/`` exposes a plain C entry
point.  ``build_shared_library`` compiles it for Hopper (``sm_90a``) at first
use into ``build/`` at the repository root, keyed by a hash of the source
and the flags, and writes the library atomically (a temporary file renamed
into place), so concurrent processes never load a half-written file.  A
missing ``nvcc`` or a failed build raises: nothing falls back to the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Path], ctypes.CDLL] = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit")


def library_path(name: str, source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_shared_library(name: str, source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless this exact source is already built.
    Returns ``(library path, compiler log)``; the log holds ``-Xptxas -v``'s
    registers and spills.  It is kept beside the library (``.log``) and
    returned on later calls too, so a cached build still reports them."""
    out = library_path(name, source)
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return out, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}.{threading.get_ident()}"
    tmp = out.with_name(f"{out.name}.{tag}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    tmp_log = log_path.with_name(f"{log_path.name}.{tag}")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp, out)
    return out, log


def load_library(name: str, source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process:
    later calls neither hash the source nor touch the disk, so a launch
    pays no build check."""
    key = (name, source)
    lib = _loaded.get(key)
    if lib is None:
        with _lock:
            if key not in _loaded:
                path, _ = build_shared_library(name, source)
                _loaded[key] = ctypes.CDLL(str(path))
            lib = _loaded[key]
    return lib


Edits = Dict[str, List[Tuple[str, str]]]


def apply_edits(text: str, variants: Edits) -> Dict[str, str]:
    """Each variant's source: ``text`` with the variant's (old, new) text
    edits, each of which must apply exactly once (raises otherwise)."""
    out = {}
    for name, edits in variants.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: the edit {old[:60]!r}... does not apply")
            src = src.replace(old, new)
        out[name] = src
    return out


def build_variants(name: str, source: Path, variants: Edits) -> Dict[str, Path]:
    """Build every variant of a kernel source (``apply_edits``) with the
    port's flags, all at once; ``{variant: library path}``.  For the
    ablation scripts, which time what each part of a design is worth."""
    out_dir = BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for variant, text in apply_edits(source.read_text(), variants).items():
        sources[variant] = out_dir / f"{name}_{variant}.cu"
        sources[variant].write_text(text)
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = pool.map(lambda kv: build_shared_library(f"{name}_{kv[0]}", kv[1])[0],
                         sources.items())
        return dict(zip(sources, paths))
