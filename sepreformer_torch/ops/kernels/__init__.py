"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for a CPU tensor and launches
its kernel for a CUDA tensor; its ``launches`` attribute counts the
launches."""

from sepreformer_torch.ops.kernels.gcfn import fused_gcfn, gcfn_plain
from sepreformer_torch.ops.kernels.relpos import (
    materialize_pos_kt,
    materialize_pos_kt_plain,
)
from sepreformer_torch.ops.kernels.softmax_pv import (
    softmax_pv,
    softmax_pv_plain,
)

WRAPPERS = (fused_gcfn, materialize_pos_kt, softmax_pv)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = [
    "WRAPPERS", "fused_gcfn", "gcfn_plain", "launch_counts",
    "materialize_pos_kt", "materialize_pos_kt_plain", "reset_launches",
    "softmax_pv", "softmax_pv_plain",
]
