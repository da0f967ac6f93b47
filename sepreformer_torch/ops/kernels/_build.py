"""Build and load the port's CUDA kernel library.

All sources under ``sepreformer_torch/csrc/*.cu`` (with the headers
``*.cuh`` they include) are compiled for ``sm_90a`` by plain ``nvcc``
calls, one per source, all started together, and linked into a shared
library with a C interface, which is loaded with ``ctypes``.  No PyTorch
header is included, so the build takes seconds, not minutes, and the
longest source sets its length.  The library lands in
``build/sepreformer_torch/`` at the root of the checkout, named by a hash
of the sources and headers: an edited file gets a fresh build, an
unchanged one is loaded as it is.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    # the same with x and out bfloat16 (the parameters float32)
    "sep_gcfn_bf16": [_P] * 12 + [_I, _I, _I, _F, _P],
    # table, out, t, d, maxlen, stream
    "sep_relpos_f32": [_P, _P, _I, _I, _I, _P],
    # t, d, int out[5] -> K2's blocks, tiles, blocks per SM, registers,
    # local bytes
    "sep_relpos_occupancy": [_I, _I, _P],
    # scores, v, lens, out, B, H, Lp, F, length, stream
    "sep_softmax_pv_f32": [_P] * 4 + [_I] * 5 + [_P],
    # the same with scores_bf16, v_bf16 (one at least 1; out in v's
    # dtype) before the stream
    "sep_softmax_pv_bf16": [_P] * 4 + [_I] * 7 + [_P],
    # scores, bias, v, lens, out, B, H, Lp, F, length, stream
    "sep_softmax_pv_bias_f32": [_P] * 5 + [_I] * 5 + [_P],
    # x, dy, w, dx, dw, db, partial, partial_floats, B, T, C, K, stream
    "sep_depthwise_bwd_f32": [_P] * 7 + [_L] + [_I] * 4 + [_P],
    # scores, v, lens, out, row_max, row_sum, B, H, Lp, F, length,
    # seed_word, threshold, keep_scale, stream
    "sep_softmax_pv_train_fwd_f32": [_P] * 6 + [_I] * 5 + [_U, _U, _F, _P],
    # scores, v, out, dout, row_max, row_sum, lens, dscores, dv, B, H, Lp,
    # F, length, seed_word, threshold, keep_scale, stream
    "sep_softmax_pv_train_bwd_f32": [_P] * 9 + [_I] * 5 + [_U, _U, _F, _P],
    # K9's bfloat16 instances: scores, v, lens, out, out32, row_max,
    # row_sum, B, H, Lp, F, length, scores_bf16, v_bf16, seed_word,
    # threshold, keep_scale, stream
    "sep_softmax_pv_train_fwd_bf16": [_P] * 7 + [_I] * 7 + [_U, _U, _F, _P],
    # K10's: scores, v, out (float32), dout, row_max, row_sum, lens,
    # dscores, dv, B, H, Lp, F, length, scores_bf16, v_bf16, seed_word,
    # threshold, keep_scale, stream
    "sep_softmax_pv_train_bwd_bf16": [_P] * 9 + [_I] * 7 + [_U, _U, _F, _P],
    # the same two with the bias after the scores
    "sep_softmax_pv_train_fwd_bias_f32": [_P] * 7 + [_I] * 5 + [_U, _U, _F,
                                                               _P],
    "sep_softmax_pv_train_bwd_bias_f32": [_P] * 10 + [_I] * 5 + [_U, _U, _F,
                                                                _P],
    # est, src, out, S, B, T, scale_inv, eps, clamp_db, has_clamp, stream
    "sep_pit_sisnr_f32": [_P] * 3 + [_I] * 4 + [_F, _F, _I, _P],
    # S, B, T, stream: an empty launch of K11's shape
    "sep_pit_empty": [_I] * 3 + [_P],
    # S, T, int out[6] -> K11's cluster, held samples, shared memory,
    # registers, local bytes, clusters at once
    "sep_pit_occupancy": [_I, _I, _P],
    # x, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, out, B, T, F, eps,
    # seed0, seed1, threshold, scale, stream
    "sep_gcfn_train_fwd_f32": [_P] * 11 + [_I] * 3 + [_F, _U, _U, _U, _F,
                                                      _P],
    # x, dout, 9 params, dx, grads_small, grads_big, scratch,
    # scratch_floats, B, T, F, eps, seed0, seed1, threshold, scale, stream
    "sep_gcfn_train_bwd_f32": [_P] * 15 + [_L] + [_I] * 3 + [_F, _U, _U, _U,
                                                             _F, _P],
    # the same two with x, out, dout and dx bfloat16
    "sep_gcfn_train_fwd_bf16": [_P] * 11 + [_I] * 3 + [_F, _U, _U, _U, _F,
                                                       _P],
    "sep_gcfn_train_bwd_bf16": [_P] * 15 + [_L] + [_I] * 3 + [_F, _U, _U,
                                                              _U, _F, _P],
    # B, T, F -> floats of K8's scratch
    "sep_gcfn_train_bwd_scratch_floats": [_I, _I, _I],
    # F, int out[8] -> K7's, then K8's row pass's, blocks per SM,
    # registers, local bytes, warps
    "sep_gcfn_train_occupancy": [_I, _P],
    # the same of the bfloat16 instances
    "sep_gcfn_train_bf16_occupancy": [_I, _P],
    # q, k, v, table, lens, out, B, L, H, D, maxlen, stream
    "sep_flash_relpos_f32": [_P] * 6 + [_I] * 5 + [_P],
    # the same with q, k, v, table and out bfloat16
    "sep_flash_relpos_bf16": [_P] * 6 + [_I] * 5 + [_P],
    # x, dy, dw, db, partial, partial_floats, B, T, C, K, stream
    "sep_depthwise_bwd_w_f32": [_P] * 5 + [_L] + [_I] * 4 + [_P],
    # q, k, v, table, lens, out, row_max, row_sum, BH, L, H, D, maxlen,
    # block, seed_word, threshold, keep_scale, split, stream
    "sep_attn_train_fwd_f32": [_P] * 8 + [_I] * 6 + [_U, _U, _F, _I, _P],
    # K13's bfloat16 instance: q, k, v, table (bfloat16), lens, out
    # (bfloat16), out32, row_max, row_sum, then as the float32 entry
    "sep_attn_train_fwd_bf16": [_P] * 9 + [_I] * 6 + [_U, _U, _F, _I, _P],
    # BH, L, D, int out[13] -> K13's split, then its blocks per SM,
    # registers, local bytes, warps at SPLIT 1, 2 and 4
    "sep_attn_train_fwd_occupancy": [_I, _I, _I, _P],
    # BH, L, D -> floats of K14's scratch, and of its bfloat16 instance's
    "sep_attn_train_bwd_scratch_floats": [_I, _I, _I],
    "sep_attn_train_bwd_bf16_scratch_floats": [_I, _I, _I],
    # q, k, v, table, lens, out, dout, row_max, row_sum, dq, dk, dv,
    # dtable, scratch, scratch_floats, BH, L, H, D, maxlen, block,
    # seed_word, threshold, keep_scale, stream
    "sep_attn_train_bwd_f32": [_P] * 14 + [_L] + [_I] * 6 + [_U, _U, _F,
                                                             _P],
    # the same with q, k, v, table, dout, dq, dk, dv and dtable bfloat16
    # and out K13's float32 out32
    "sep_attn_train_bwd_bf16": [_P] * 14 + [_L] + [_I] * 6 + [_U, _U, _F,
                                                              _P],
    # x, w, bias, y, B, T, C, K, stream
    "sep_depthwise_fwd_f32": [_P] * 4 + [_I] * 4 + [_P],
    # x, 13 params, v, out, B, T, F, eps, stream
    "sep_cla_f32": [_P] * 16 + [_I] * 3 + [_F, _P],
    # the same with x and out bfloat16 (v float32)
    "sep_cla_bf16": [_P] * 16 + [_I] * 3 + [_F, _P],
    # x, x_down, 4 gate params, 9 GCFN params, out, B, T, L, F, eps, stream
    "sep_ega_gcfn_f32": [_P] * 16 + [_I] * 4 + [_F, _P],
    # the same with x, x_down and out bfloat16, and y, a float32 scratch
    # [B, T, F] for the residual, after out
    "sep_ega_gcfn_bf16": [_P] * 17 + [_I] * 4 + [_F, _P],
    # F, int out[4] -> K1's float32 instance's blocks per SM, registers,
    # local bytes, warps at a T/S/M width F
    "sep_gcfn_occupancy": [_I, _P],
    # D, int out[8] -> K3's at a T/S/M head width D, at SPLIT 1 and 2
    "sep_softmax_pv_width_occupancy": [_I, _P],
    # D, int out[4] -> K12's float32 instance's at a T/S/M head width D
    "sep_flash_relpos_occupancy": [_I, _P],
    # F, int* blocks -> K16's blocks per SM
    "sep_ega_gcfn_blocks_per_sm": [_I, _P],
    # F, int blocks[2] -> K15's blocks per SM, the GLU launch and the tail
    "sep_cla_blocks_per_sm": [_I, _P],
    # int blocks[4] -> K10's and K10b's blocks per SM, at head widths 16
    # and 32
    "sep_softmax_pv_train_bwd_blocks_per_sm": [_P],
    # int out[32] -> K3's and K3b's blocks per SM, registers, local bytes,
    # warps, at SPLIT 1 and 2, then the same at head width 32
    "sep_softmax_pv_occupancy": [_P],
    # int out[32] -> the same of K9 and K9b, at head widths 16 and 32
    "sep_softmax_pv_train_fwd_occupancy": [_P],
    # B, T, C, K, with_dx -> floats of K5's (K6's) scratch
    "sep_depthwise_bwd_partial_floats": [_I] * 5,
    # K, int out[12] -> K4's, K5's and K6's blocks per SM, registers,
    # local bytes, warps
    "sep_depthwise_occupancy": [_I, _P],
}
# launchers that return something else than a cudaError_t
RESTYPES = {"sep_gcfn_train_bwd_scratch_floats": _L,
            "sep_attn_train_bwd_scratch_floats": _L,
            "sep_attn_train_bwd_bf16_scratch_floats": _L,
            "sep_depthwise_bwd_partial_floats": _L}


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
    """Compile the library unless this version of the sources is built:
    one ``nvcc -c`` per source, all at once, then one link.  Writes each
    source's compiler output (the ptxas resource report) to
    ``build.log`` in source order, and prints the build seconds to
    stderr."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    objs = BUILD_DIR / f"obj.tmp{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    try:
        procs = [(src, objs / f"{src.stem}.o") for src in sources()]
        procs = [(src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in procs]
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                 *(str(obj) for _, obj, _ in procs)],
                capture_output=True, text=True)
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("the link")
        log = "".join(logs)
        (BUILD_DIR / "build.log").write_text(log)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    os.replace(tmp, out)
    print(f"[sepreformer_torch] built {out.name} in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
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


# The ROADMAP item, by title, that builds the widths a kernel is not built
# for: the T/S/M presets' widths (F 64, 96, 160; head widths 8, 12, 20),
# built for K1, K3 and K12 in float32 (their serving path), for no other
# kernel yet.
OTHER_PRESETS = "ROADMAP.md queue A, T/S/M"
# The one that builds the bfloat16 instances a kernel does not have.
BF16_STREAMS = "ROADMAP.md queue B, bfloat16 streams"


def check_width(name: str, what: str, value: int, built, todo: str) -> None:
    """Raise unless ``value`` (a width or head width) is one the kernel is
    built for; the error names the ROADMAP item ``todo`` that builds it."""
    if value not in built:
        raise ValueError(f"{name}: {what} {value} not in {tuple(built)} "
                         f"(not built yet: {todo})")


def check_dtype(name: str, a, built=None,
                todo: str = BF16_STREAMS) -> None:
    """Raise unless tensor ``a``'s dtype is one the kernel is built for
    (default float32 alone); the error names the ROADMAP item ``todo``
    that builds the others.  A kernel never converts a tensor behind the
    caller's back."""
    import torch

    built = (torch.float32,) if built is None else tuple(built)
    if a.dtype not in built:
        raise ValueError(f"{name}: dtype {a.dtype} not in {built} "
                         f"(not built yet: {todo})")


def dtypes_at(width: int, bf16_widths):
    """The dtypes a kernel's instances take at ``width`` (a width or head
    width): float32 and bfloat16 at ``bf16_widths``, float32 alone
    elsewhere (``check_dtype`` names queue B's item for the rest)."""
    import torch

    if width in bf16_widths:
        return (torch.float32, torch.bfloat16)
    return (torch.float32,)


def count_launch(wrapper, instance: str = "") -> None:
    """One launch of ``wrapper``'s kernel: its float32 instance counts in
    ``wrapper.launches``, another (``instance``, e.g. "bf16") in
    ``wrapper.instance_launches[instance]``."""
    if instance:
        counts = wrapper.instance_launches
        counts[instance] = counts.get(instance, 0) + 1
    else:
        wrapper.launches += 1


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
    if a.dtype != dtype:
        raise ValueError(f"{name}: dtype {a.dtype}, expected {dtype}")
    if a.device.type != "cuda" or a.device != device:
        raise ValueError(f"{name}: on {a.device}, expected {device} (CUDA)")
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
