"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are plain CUDA C++ with a C interface, compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library and loaded with
``ctypes``. Building happens at first use, never at import, into
``streetunveiler_torch/_build/``; the library's name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Each source compiles in its own ``nvcc`` process, all started
together, then one link.

Each kernel wrapper bumps its entry of ``streetunveiler_torch.trace.
launch_counts`` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no multiply-add contraction, so each product and sum rounds
# as it does in the plain PyTorch versions. The pair geometry (cross
# products, k = A + px·B + py·C, t = det/kz) cancels heavily, and fused
# roundings moved a pixel's median depth by ~20 ulps and flipped pairs at
# the α = 1/255 gate against the plain version on an H100.
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    return srcs, hdrs


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsu_kernels_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel) and link
    them into the shared library; returns its path. Reuses a library
    already built from the same sources. The compiler's output, ptxas'
    register and spill report included, goes to ``<library>.log``."""
    lib_path = library_path()
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    srcs, _ = _sources()
    stem = lib_path[:-len(".so")]
    tag = f"{os.getpid()}"
    jobs = []
    for src in srcs:
        obj = f"{stem}_{os.path.basename(src)}.{tag}.o"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    log, failed = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== nvcc {os.path.basename(src)} (rc {proc.returncode})"
                   f"\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    tmp = f"{lib_path}.{tag}.tmp"
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared",
                               *[o for _, o, _ in jobs], "-o", tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    with open(stem + ".log", "w") as f:
        f.write("\n".join(log))
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"building the CUDA kernels failed ({failed}):\n"
                           + "\n".join(log))
    os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    """The compiler output of the last build of the current sources."""
    path = library_path()[:-len(".so")] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load_library() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # K3: the redesign (su_expand) and the first design
            for name in ("su_expand", "su_expand_first"):
                getattr(lib, name).argtypes = [vp, i32, vp, i32, i32, i32,
                                               i32, i32, i32, vp, vp, i32,
                                               vp]
                getattr(lib, name).restype = i32
            # K1/K2 take tile_order after tile_offsets; their bisection
            # variants (the first design) do not
            fwd = [vp, i32, i32, i32, i32, i32, vp, i32, i32, f32, f32, f32,
                   vp, vp, i32, vp]
            bwd = [vp, i32, i32, i32, i32, i32, vp, i32, i32, f32, f32, vp,
                   vp, vp, vp, i32, vp]
            lib.su_blend_fwd.argtypes = fwd[:7] + [vp] + fwd[7:]
            lib.su_blend_fwd.restype = i32
            lib.su_blend_bwd.argtypes = bwd[:7] + [vp] + bwd[7:]
            lib.su_blend_bwd.restype = i32
            lib.su_bisect_fwd.argtypes = [i32] + fwd
            lib.su_bisect_fwd.restype = i32
            lib.su_bisect_bwd.argtypes = [i32] + bwd
            lib.su_bisect_bwd.restype = i32
            # T1 and T2 on K1's and K2's H100 design take the tile order
            # as K1 and K2 do
            lib.su_bisect_fwd_sm90.argtypes = [i32] + fwd[:7] + [vp] + fwd[7:]
            lib.su_bisect_fwd_sm90.restype = i32
            lib.su_bisect_bwd_sm90.argtypes = [i32] + bwd[:7] + [vp] + bwd[7:]
            lib.su_bisect_bwd_sm90.restype = i32
            for name in ("su_blend_fwd_occupancy", "su_blend_bwd_occupancy",
                         "su_bisect_fwd_occupancy",
                         "su_bisect_fwd_sm90_occupancy",
                         "su_bisect_bwd_occupancy"):
                getattr(lib, name).argtypes = [i32, i32, i32, vp]
                getattr(lib, name).restype = i32
            # T3 and T9: the redesign (su_micro_reduce, su_mmt3) and the
            # first design (*_first) take the same arguments
            for name in ("su_micro_reduce", "su_micro_reduce_first"):
                getattr(lib, name).argtypes = [i32, i32, vp, i32, i32, vp,
                                               vp, i32, vp]
                getattr(lib, name).restype = i32
            # T4: the redesign (su_micro_prefix) and the first design
            for name in ("su_micro_prefix", "su_micro_prefix_first"):
                getattr(lib, name).argtypes = [i32, vp, ctypes.c_longlong,
                                               i32, vp, i32, vp]
                getattr(lib, name).restype = i32
            # T5/T6: the redesign (su_micro_floor) takes the segment order,
            # the positions, its scratch and the phases to run
            lib.su_micro_floor_first.argtypes = [
                i32, i32, vp, ctypes.c_longlong, vp, vp, i32, vp, vp, vp, vp,
                i32, vp]
            lib.su_micro_floor_first.restype = i32
            lib.su_micro_floor.argtypes = [
                i32, i32, vp, ctypes.c_longlong, vp, vp, vp, i32, i32, vp, vp,
                vp, vp, vp, i32, i32, vp]
            lib.su_micro_floor.restype = i32
            # T7/T8: the redesign (su_identity) and the first design take
            # the same arguments; su_identity_split and su_graph_nodes
            # (identity_split.cu) serve chip_smoke.py's measurement of a
            # copy in a CUDA graph
            for name in ("su_identity", "su_identity_first"):
                getattr(lib, name).argtypes = [vp, vp, ctypes.c_longlong, i32,
                                               vp]
                getattr(lib, name).restype = i32
            lib.su_identity_split.argtypes = [i32, i32, i32, vp, vp,
                                              ctypes.c_longlong, i32, vp]
            lib.su_identity_split.restype = i32
            lib.su_graph_nodes.argtypes = [vp, i32, vp, vp, vp, vp, vp]
            lib.su_graph_nodes.restype = i32
            for name in ("su_mmt3", "su_mmt3_first"):
                getattr(lib, name).argtypes = [vp, vp, vp, vp, vp, vp, i32,
                                               vp]
                getattr(lib, name).restype = i32
            lib.su_error_string.argtypes = [i32]
            lib.su_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def occupancy(entry: str, nq: int, n_gates: int, device: int = 0) -> int:
    """Blocks of a blend kernel's (nq, n_gates) instantiation that one SM
    holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``):
    ``entry`` is ``blend_fwd``/``blend_bwd`` (K1/K2), ``bisect_fwd``/
    ``bisect_bwd`` (their first design, the bisection tools' ``full``) or
    ``bisect_fwd_sm90`` (T1's ``full`` on K1's H100 design)."""
    blocks = ctypes.c_int(0)
    rc = getattr(load_library(), f"su_{entry}_occupancy")(
        nq, n_gates, device, ctypes.addressof(blocks))
    check(rc, f"{entry} occupancy")
    return blocks.value


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = load_library().su_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
