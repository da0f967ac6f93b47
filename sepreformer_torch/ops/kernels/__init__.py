"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for a CPU tensor and launches
its kernel for a CUDA tensor; its ``launches`` attribute counts the
launches.

Eval: K1 ``fused_gcfn``, K2 ``materialize_pos_kt`` (``pos_kt`` adds its
gradient), K3 ``softmax_pv``, K12 ``flash_relpos_attention`` (past the
bottleneck length ``blocks.FUSED_PV_MAX_LENGTH``, in place of K2 and
K3); the gradients of K1, K3 and K12 recompute their plain versions,
as the JAX package's ``custom_vjp``s do.  K1, K3, K7-K10 and K12-K16
also take bfloat16 streams (``ModelConfig.compute_dtype``), each through
an instance of its own (K5 and K6 take float32 operands there, as in
JAX), on every route; K16's bfloat16 form has no gradient, since the JAX
package's raises.  At the T, S and M presets' widths K1, K3 and K12 are
built, in float32 alone.  The kernels on no route (K3b, K4, K9b, K10b) raise on
a bfloat16 tensor, naming ROADMAP.md's queue B, bfloat16 streams.  Train: K5 ``depthwise_bwd``
(the backward of ``depthwise_large``; under ``depthwise.BWD_MODE =
"conv"`` K6 ``depthwise_bwd_w`` for dw and db), K7 ``gcfn_train_fwd`` and K8
``gcfn_train_bwd`` (the autograd function ``fused_gcfn_train``), K9
``softmax_pv_train_fwd`` and K10 ``softmax_pv_train_bwd`` (the autograd
function ``softmax_pv_dropout``), K11 ``sisnr_pairwise_neg_fused``.  The
routes ``attention_train_impl="pallas"`` (train) and
``attention_impl="single"`` (eval): K13 ``attention_train_fwd`` and K14
``attention_train_bwd`` (the autograd function
``flash_relpos_attention_train``).  The fused eval blocks
(``fused_local="on"``, ``fused_pair="on"``): K15 ``fused_cla`` and K16
``fused_ega_tail_gcfn``, autograd functions whose backward recomputes
the plain version.  K4 ``depthwise_fwd``, the k65 forward, is on no
route, as in the JAX package, and so are the two-tensor forms that
take ``bias=``: K3b ``softmax_pv_bias`` (``softmax_pv(..., bias=)``), K9b
``softmax_pv_train_fwd_bias`` and K10b ``softmax_pv_train_bwd_bias``
(``softmax_pv_dropout(..., bias=)``).
"""

from sepreformer_torch.ops.kernels.attention_train import (
    attention_train_bwd,
    attention_train_bwd_plain,
    attention_train_fwd,
    attention_train_fwd_bf16,
    attention_train_plain,
    flash_relpos_attention_train,
)
from sepreformer_torch.ops.kernels.cla import (
    cla_plain,
    cla_reference,
    fused_cla,
)
from sepreformer_torch.ops.kernels.depthwise import (
    depthwise_bwd,
    depthwise_bwd_plain,
    depthwise_bwd_w,
    depthwise_bwd_w_plain,
    depthwise_fwd,
    depthwise_fwd_plain,
    depthwise_large,
)
from sepreformer_torch.ops.kernels.ega_gcfn import (
    ega_tail_gcfn_plain,
    fused_ega_tail_gcfn,
)
from sepreformer_torch.ops.kernels.flash_attention import (
    flash_relpos_attention,
    flash_relpos_attention_plain,
)
from sepreformer_torch.ops.kernels.gcfn import fused_gcfn, gcfn_plain
from sepreformer_torch.ops.kernels.gcfn_train import (
    fused_gcfn_train,
    gcfn_train_bwd,
    gcfn_train_bwd_plain,
    gcfn_train_fwd,
    gcfn_train_plain,
)
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
    softmax_pv_bias,
    softmax_pv_plain,
)
from sepreformer_torch.ops.kernels.softmax_pv_train import (
    softmax_pv_dropout,
    softmax_pv_dropout_bwd_plain,
    softmax_pv_dropout_plain,
    softmax_pv_train_bwd,
    softmax_pv_train_bwd_bias,
    softmax_pv_train_fwd,
    softmax_pv_train_fwd_bias,
)

WRAPPERS = (fused_gcfn, materialize_pos_kt, softmax_pv, depthwise_bwd,
            gcfn_train_fwd, gcfn_train_bwd, softmax_pv_train_fwd,
            softmax_pv_train_bwd, sisnr_pairwise_neg_fused,
            flash_relpos_attention, depthwise_bwd_w, attention_train_fwd,
            attention_train_bwd, depthwise_fwd, fused_cla,
            fused_ega_tail_gcfn, softmax_pv_bias, softmax_pv_train_fwd_bias,
            softmax_pv_train_bwd_bias)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "instance_launches"):
            fn.instance_launches = {}


def launch_counts() -> dict:
    """Each wrapper's launches, and those of its other dtype instances
    (K1, K3, K7-K10 and K12-K16 in bfloat16) as "<wrapper> <instance>"."""
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    for fn in WRAPPERS:
        for instance, n in getattr(fn, "instance_launches", {}).items():
            counts[f"{fn.__name__} {instance}"] = n
    return counts


__all__ = [
    "WRAPPERS", "attention_train_bwd", "attention_train_bwd_plain",
    "attention_train_fwd", "attention_train_fwd_bf16",
    "attention_train_plain", "cla_plain", "cla_reference",
    "depthwise_bwd", "depthwise_bwd_plain", "depthwise_bwd_w",
    "depthwise_bwd_w_plain", "depthwise_fwd", "depthwise_fwd_plain",
    "depthwise_large", "ega_tail_gcfn_plain", "flash_relpos_attention_train",
    "flash_relpos_attention", "flash_relpos_attention_plain", "fused_cla",
    "fused_ega_tail_gcfn", "fused_gcfn",
    "fused_gcfn_train", "gcfn_plain", "gcfn_train_bwd",
    "gcfn_train_bwd_plain", "gcfn_train_fwd", "gcfn_train_plain",
    "launch_counts", "materialize_pos_kt",
    "materialize_pos_kt_plain", "pos_kt", "reset_launches",
    "sisnr_pairwise_neg", "sisnr_pairwise_neg_fused", "softmax_pv",
    "softmax_pv_bias", "softmax_pv_dropout", "softmax_pv_dropout_bwd_plain",
    "softmax_pv_dropout_plain", "softmax_pv_plain", "softmax_pv_train_bwd",
    "softmax_pv_train_bwd_bias", "softmax_pv_train_fwd",
    "softmax_pv_train_fwd_bias",
]
