"""Build the port's native libraries at first use and load them with ctypes.

Each CUDA kernel (`hough_vote.cu`, `conv3x3.cu`, `nms.cu`, `flow_warp.cu`) is a
`.cu` file under `posecnn_torch/csrc/` with a plain C entry point, compiled by `nvcc`;
the host renderer (`csrc/rasterizer.cc`), the host bilateral filter
(`csrc/bilateral.cc`) and the PNG reader's row filters (`csrc/png.cc`) are
compiled by `g++`. Each becomes a shared library
under `posecnn_torch/_build/` (listed in `.gitignore`); the file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused. Nothing
here runs at import time: the CPU tests import every module of the port, and
the CUDA kernels build only on a machine with `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no FMA contraction: the kernels must round like the plain versions
    "-fmad=false",
)
# the JAX package's rasterizer flags, and no FMA contraction (csrc/rasterizer.cc)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library(name: str) -> Path:
    """Compile `csrc/<name>.cu` with nvcc, or `csrc/<name>.cc` with g++, if
    not built yet, and return the .so path. A failed build raises."""
    src = CSRC / f"{name}.cu"
    cuda = src.exists()
    if not cuda:
        src = CSRC / f"{name}.cc"
    flags = NVCC_FLAGS if cuda else GXX_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: a process that finds the final
    # name finds a whole library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc() if cuda else "g++", *flags, "-o", tmp, str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def hough_vote_lib() -> ctypes.CDLL:
    """The loaded Hough vote library, with its entry point's C signature."""
    lib = ctypes.CDLL(str(build_library("hough_vote")))
    fn = lib.hough_vote_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def conv3x3_lib() -> ctypes.CDLL:
    """The loaded 3x3 convolution library, with its entry point's C signature."""
    lib = ctypes.CDLL(str(build_library("conv3x3")))
    fn = lib.conv3x3_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def nms_lib() -> ctypes.CDLL:
    """The loaded NMS keep-mask library, with its entry point's C signature."""
    lib = ctypes.CDLL(str(build_library("nms")))
    fn = lib.nms_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def flow_warp_lib() -> ctypes.CDLL:
    """The loaded flow warp library, with its entry points' C signatures."""
    lib = ctypes.CDLL(str(build_library("flow_warp")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flow_warp_forward_launch.argtypes = [ptr] * 11 + [i32] * 5 + [ctypes.c_float, i32, ptr]
    lib.flow_warp_forward_launch.restype = i32
    lib.flow_warp_backward_launch.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.flow_warp_backward_launch.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def bilateral_lib() -> ctypes.CDLL:
    """The loaded host bilateral filter, with its entry point's C signature."""
    lib = ctypes.CDLL(str(build_library("bilateral")))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.bilateral_filter_u8c3.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                          ctypes.c_double]
    lib.bilateral_filter_u8c3.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def rasterizer_lib() -> ctypes.CDLL:
    """The loaded host rasterizer, with its entry points' C signatures."""
    lib = ctypes.CDLL(str(build_library("rasterizer")))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rasterize_mesh.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_void_p, f32p, f32p, f32p, f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, f32p, i32p, f32p,
    ]
    lib.rasterize_mesh.restype = None
    lib.rasterize_depth.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int,
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i32p,
    ]
    lib.rasterize_depth.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def png_lib() -> ctypes.CDLL:
    """The loaded PNG row-filter library, with its entry point's C signature."""
    lib = ctypes.CDLL(str(build_library("png")))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.png_unfilter.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


LIBRARIES = {"hough_vote": hough_vote_lib, "conv3x3": conv3x3_lib, "nms": nms_lib, "flow_warp": flow_warp_lib,
             "rasterizer": rasterizer_lib, "bilateral": bilateral_lib, "png": png_lib}


def build_all() -> float:
    """Build every native library of the port (the CUDA kernels, the host
    rasterizer, bilateral filter and PNG row filters), one compiler per source, all started together, then load
    them; returns the seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        list(pool.map(build_library, LIBRARIES))
    for load in LIBRARIES.values():
        load()
    return time.perf_counter() - t0
