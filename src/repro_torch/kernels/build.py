"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a -O3``, without ``--use_fast_math``)
into one shared library with a plain C interface, loaded with ``ctypes``.
Each ``.cu`` file compiles in its own ``nvcc`` process, all started
together, and the objects are then linked.

The build runs at first use, from the repository's sources only, into
``build/repro_torch/`` at the root of the checkout.  The library's name
carries a hash of the sources and flags, so an edited source builds a new
library.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

#: C signatures of the library's entry points: name -> (restype, argtypes)
SIGNATURES = {
    "ef_sparsify_launch": (_I, [_P, _P, _P, _P, _P, _I64, _I64, _P]),
    "ota_project_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                _P]),
    "ota_project_t_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _P]),
    "amp_fused_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                              _I, _I, _F, _P]),
    "amp_fused_smem_bytes": (_I64, [_I, _I, _I, _I, _I]),
    "amp_fused_max_active_clusters": (_I, [_I, _I, _I, _I, _I]),
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only where the CUDA toolkit is installed")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless the current sources are already built."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(log, flush=True)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                               str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(tmp_lib, out)
    return out


_library = None
_library_lock = threading.Lock()

#: held while a wrapper adds one to its launch count: rank threads of a
#: mesh launch the kernels concurrently, and ``launches += 1`` is a read,
#: an add and a write that two threads can interleave
LAUNCH_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.

    Its entry points are bound here once, with their C signatures: ctypes
    keeps each bound function as an attribute of the library object, so a
    launch's ``library().name`` is an attribute read.  The first call
    builds and loads under a lock, so rank threads that reach their first
    launch together start one ``nvcc`` build, not one each.
    """
    global _library
    lib = _library
    if lib is None:
        with _library_lock:
            if _library is None:
                lib = ctypes.CDLL(str(build()))
                for name, (restype, argtypes) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _library = lib
            lib = _library
    return lib


def current_stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device``, as an int for
    ctypes.  torch's raw getter builds no ``torch.cuda.Stream`` object, a
    few microseconds of host time per launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


@functools.lru_cache(maxsize=64)
def _const_u32(value: int, device: str) -> torch.Tensor:
    return _to_u32_bits(torch.tensor([value], dtype=torch.int64,
                                     device=device))


def _to_u32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 words -> int32 tensor of the same bit patterns."""
    words = words.to(torch.int64) & 0xFFFFFFFF
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32).reshape(1)


def device_u32(value, device) -> torch.Tensor:
    """A uint32 scalar in device memory, for a kernel to read.

    ``value`` is an int (cached per device, so a config seed is copied to
    the card once) or an int64-held uint32 tensor, converted on its device
    without a round trip to the host.
    """
    if isinstance(value, torch.Tensor):
        return _to_u32_bits(value.to(device))
    return _const_u32(int(value) & 0xFFFFFFFF, str(device))


def require_meta_f32(name: str, **tensors) -> None:
    """What a kernel's meta route takes: contiguous ``meta`` float32
    tensors, as the kernel takes CUDA ones."""
    for arg, t in tensors.items():
        if t.device.type != "meta":
            raise ValueError(f"{name}: {arg} must be a meta tensor, "
                             f"got {t.device}")
        if t.dtype is not torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def require_cuda_f32(name: str, **tensors) -> None:
    """Validate what a kernel takes: CUDA, float32, contiguous, one device.

    Plain attribute tests, since a launch of a few microseconds of device
    time pays for them on the host every call."""
    index = None
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype is not torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if index is None:
            index = t.get_device()
        elif t.get_device() != index:
            raise ValueError(f"{name}: {arg} is on {t.device}, the other "
                             f"tensors on cuda:{index}")
