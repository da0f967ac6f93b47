"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for a CPU tensor and launches
its kernel for a CUDA tensor; its ``launches`` attribute counts the
launches.

Eval: K1 ``fused_gcfn``, K2 ``materialize_pos_kt`` (``pos_kt`` adds its
gradient), K3 ``softmax_pv``.  Train: K5 ``depthwise_bwd`` (the backward
of ``depthwise_large``), K9 ``softmax_pv_train_fwd`` and K10
``softmax_pv_train_bwd`` (the autograd function ``softmax_pv_dropout``),
K11 ``sisnr_pairwise_neg_fused``.
"""

from sepreformer_torch.ops.kernels.depthwise import (
    depthwise_bwd,
    depthwise_bwd_plain,
    depthwise_large,
)
from sepreformer_torch.ops.kernels.gcfn import fused_gcfn, gcfn_plain
from sepreformer_torch.ops.kernels.pit import (
    sisnr_pairwise_neg,
    sisnr_pairwise_neg_fused,
)
from sepreformer_torch.ops.kernels.relpos import (
    materialize_pos_kt,
    materialize_pos_kt_plain,
    pos_kt,
)
from sepreformer_torch.ops.kernels.softmax_pv import (
    softmax_pv,
    softmax_pv_plain,
)
from sepreformer_torch.ops.kernels.softmax_pv_train import (
    softmax_pv_dropout,
    softmax_pv_dropout_bwd_plain,
    softmax_pv_dropout_plain,
    softmax_pv_train_bwd,
    softmax_pv_train_fwd,
)

WRAPPERS = (fused_gcfn, materialize_pos_kt, softmax_pv, depthwise_bwd,
            softmax_pv_train_fwd, softmax_pv_train_bwd,
            sisnr_pairwise_neg_fused)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = [
    "WRAPPERS", "depthwise_bwd", "depthwise_bwd_plain", "depthwise_large",
    "fused_gcfn", "gcfn_plain", "launch_counts", "materialize_pos_kt",
    "materialize_pos_kt_plain", "pos_kt", "reset_launches",
    "sisnr_pairwise_neg", "sisnr_pairwise_neg_fused", "softmax_pv",
    "softmax_pv_dropout", "softmax_pv_dropout_bwd_plain",
    "softmax_pv_dropout_plain", "softmax_pv_plain", "softmax_pv_train_bwd",
    "softmax_pv_train_fwd",
]
