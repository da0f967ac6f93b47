"""Build and load the port's CUDA kernel library.

All sources under ``sepreformer_torch/csrc/*.cu`` (with the headers
``*.cuh`` they include) are compiled by one plain ``nvcc`` call for
``sm_90a`` into a shared library with a C interface, which is loaded
with ``ctypes``.  No PyTorch header is included, so the build takes
seconds, not minutes.  The library lands in ``build/sepreformer_torch/``
at the root of the checkout, named by a hash of the sources and headers:
an edited file gets a fresh build, an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "sepreformer_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
# launcher name -> argument types; a launcher returns cudaGetLastError()
SIGNATURES = {
    # x, lens, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, out,
    # B, T, F, eps, stream
    "sep_gcfn_f32": [_P] * 12 + [_I, _I, _I, _F, _P],
    # table, out, t, d, maxlen, stream
    "sep_relpos_f32": [_P, _P, _I, _I, _I, _P],
    # scores, v, lens, out, B, H, Lp, F, length, stream
    "sep_softmax_pv_f32": [_P] * 4 + [_I] * 5 + [_P],
    # x, dy, w, dx, dw, db, partial, partial_floats, B, T, C, K, stream
    "sep_depthwise_bwd_f32": [_P] * 7 + [_L] + [_I] * 4 + [_P],
    # scores, v, lens, out, row_max, row_sum, B, H, Lp, F, length,
    # seed_word, threshold, keep_scale, stream
    "sep_softmax_pv_train_fwd_f32": [_P] * 6 + [_I] * 5 + [_U, _U, _F, _P],
    # scores, v, out, dout, row_max, row_sum, lens, dscores, dv, B, H, Lp,
    # F, length, seed_word, threshold, keep_scale, stream
    "sep_softmax_pv_train_bwd_f32": [_P] * 9 + [_I] * 5 + [_U, _U, _F, _P],
    # est, src, out, S, B, T, scale_inv, eps, clamp_db, has_clamp, stream
    "sep_pit_sisnr_f32": [_P] * 3 + [_I] * 4 + [_F, _F, _I, _P],
    # x, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, out, B, T, F, eps,
    # seed0, seed1, threshold, scale, stream
    "sep_gcfn_train_fwd_f32": [_P] * 11 + [_I] * 3 + [_F, _U, _U, _U, _F,
                                                      _P],
    # x, dout, 9 params, dx, grads_small, grads_big, scratch,
    # scratch_floats, B, T, F, eps, seed0, seed1, threshold, scale, stream
    "sep_gcfn_train_bwd_f32": [_P] * 15 + [_L] + [_I] * 3 + [_F, _U, _U, _U,
                                                             _F, _P],
    # B, T, F -> floats of K8's scratch
    "sep_gcfn_train_bwd_scratch_floats": [_I, _I, _I],
    # q, k, v, table, lens, out, B, L, H, maxlen, stream
    "sep_flash_relpos_f32": [_P] * 6 + [_I] * 4 + [_P],
}
# launchers that return something else than a cudaError_t
RESTYPES = {"sep_gcfn_train_bwd_scratch_floats": _L}


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsepkernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this version of the sources is built.
    Prints the build seconds and the ptxas resource report to stderr."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    print(f"[sepreformer_torch] built {out.name} in {secs:.1f} s",
          file=sys.stderr)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(a, name: str, shape, device, dtype=None,
                 align: int = 16) -> None:
    """Raise unless ``a`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` (default float32) on ``device``, ``align``-byte aligned."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if a.device.type != "cuda" or a.device != device:
        raise ValueError(f"{name}: on {a.device}, expected {device} (CUDA)")
    if a.dtype != dtype:
        raise ValueError(f"{name}: dtype {a.dtype}, expected {dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {shape}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if a.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would record a call on ``tensors``: a wrapper of
    an eval kernel returns a result with no gradient, which would cut
    every gradient upstream of it."""
    import torch

    if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward; call it under "
            f"torch.no_grad() or torch.inference_mode(), or take the train "
            f"path")
