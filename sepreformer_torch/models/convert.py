"""Weights from the JAX package's flax trees into the port.

The port's modules carry the reference model's state_dict names, so one
table ties each flax variable path to its state_dict key, with the
layout transform between the two.  This is the port's own copy of the
JAX package's ``models/convert.py`` table (``mapping_entries``).

Layout transforms (flax -> torch):
- Linear kernel [in, out]            -> weight [out, in]
- Conv1d 1x1 kernel [in, out]        -> weight [out, in, 1]
- depthwise kernel [k, 1, C]         -> weight [C, 1, k]
- encoder kernel [K, N]              -> Conv1d weight [N, 1, K]
- decoder kernel [N, K]              -> ConvTranspose1d weight [N, 1, K]
- LayerScale scale (F,)              -> layer_scale (1, 1, F)
- norm scale/bias                    -> weight/bias
- BN batch_stats mean/var            -> running_mean/running_var
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from sepreformer_torch.config import ModelConfig

Path = Tuple[str, ...]


class Entry(NamedTuple):
    kind: str          # layout transform, see TO_TORCH
    collection: str    # "params" | "batch_stats"
    path: Path         # flax variable path
    key: str           # torch state_dict key


TO_TORCH: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "identity": lambda a: a,
    "linear_w": lambda a: a.T,
    "conv1x1_w": lambda a: a.T[:, :, None],
    "depthwise_w": lambda a: a.transpose(2, 1, 0),
    "enc_conv_w": lambda a: a.T[:, None, :],
    "dec_conv_w": lambda a: a[:, None, :],
    "layer_scale": lambda a: a.reshape(1, 1, -1),
}


def _linear(out: List[Entry], path: Path, key: str, bias: bool = True):
    out.append(Entry("linear_w", "params", path + ("kernel",), key + ".weight"))
    if bias:
        out.append(Entry("identity", "params", path + ("bias",), key + ".bias"))


def _conv1x1(out: List[Entry], path: Path, key: str, bias: bool = True):
    out.append(Entry("conv1x1_w", "params", path + ("kernel",),
                     key + ".weight"))
    if bias:
        out.append(Entry("identity", "params", path + ("bias",), key + ".bias"))


def _depthwise(out: List[Entry], path: Path, key: str):
    out.append(Entry("depthwise_w", "params", path + ("kernel",),
                     key + ".weight"))
    out.append(Entry("identity", "params", path + ("bias",), key + ".bias"))


def _norm(out: List[Entry], path: Path, key: str):
    out.append(Entry("identity", "params", path + ("scale",), key + ".weight"))
    out.append(Entry("identity", "params", path + ("bias",), key + ".bias"))


def _layer_scale(out: List[Entry], path: Path, key: str):
    out.append(Entry("layer_scale", "params", path + ("scale",),
                     key + ".layer_scale"))


def _bn(out: List[Entry], path: Path, key: str):
    _norm(out, path, key)
    out.append(Entry("identity", "batch_stats", path + ("mean",),
                     key + ".running_mean"))
    out.append(Entry("identity", "batch_stats", path + ("var",),
                     key + ".running_var"))


def _mha(out: List[Entry], path: Path, key: str):
    _norm(out, path + ("norm",), key + ".layer_norm")
    for flax_name, torch_name in (("q", "linear_q"), ("k", "linear_k"),
                                  ("v", "linear_v"), ("out", "linear_out")):
        _linear(out, path + (flax_name,), f"{key}.{torch_name}")
    _layer_scale(out, path + ("layer_scale",), key + ".Layer_scale")


def _gcfn(out: List[Entry], path: Path, key: str):
    _norm(out, path + ("norm",), key + ".net1.0")
    _linear(out, path + ("proj_in",), key + ".net1.1")
    _depthwise(out, path + ("depthwise",), key + ".depthwise")
    _linear(out, path + ("proj_out",), key + ".net2.2")
    _layer_scale(out, path + ("layer_scale",), key + ".Layer_scale")


def _cla(out: List[Entry], path: Path, key: str):
    _norm(out, path + ("norm",), key + ".layer_norm")
    _linear(out, path + ("proj_in",), key + ".linear1")
    _depthwise(out, path + ("depthwise",), key + ".dw_conv_1d")
    _linear(out, path + ("proj_mid",), key + ".linear2")
    _bn(out, path + ("bn",), key + ".BN")
    _linear(out, path + ("proj_out",), key + ".linear3.1")
    _layer_scale(out, path + ("layer_scale",), key + ".Layer_scale")


def _global_block(out: List[Entry], path: Path, key: str):
    ega = key + ".block.ega.block"
    _mha(out, path + ("ega", "attn"), ega + ".self_attn")
    _norm(out, path + ("ega", "gate_norm"), ega + ".linear.0")
    _linear(out, path + ("ega", "gate_proj"), ega + ".linear.1")
    _gcfn(out, path + ("gcfn",), key + ".block.gcfn")


def _local_block(out: List[Entry], path: Path, key: str):
    _cla(out, path + ("cla",), key + ".block.cla")
    _gcfn(out, path + ("gcfn",), key + ".block.gcfn")


def _enc_stage(out: List[Entry], path: Path, key: str, down: bool):
    for i in (1, 2):
        _global_block(out, path + (f"global_{i}",), f"{key}.g_block_{i}")
        _local_block(out, path + (f"local_{i}",), f"{key}.l_block_{i}")
    if down:
        _depthwise(out, path + ("down", "conv"), key + ".downconv.down_conv")
        _bn(out, path + ("down", "bn"), key + ".downconv.BN")


def _dec_stage(out: List[Entry], path: Path, key: str):
    for i in (1, 2, 3):
        _global_block(out, path + (f"global_{i}",), f"{key}.g_block_{i}")
        _local_block(out, path + (f"local_{i}",), f"{key}.l_block_{i}")
        spk = f"{key}.spk_attn_{i}"
        _mha(out, path + (f"spk_attn_{i}", "attn"), spk + ".self_attn")
        _gcfn(out, path + (f"spk_attn_{i}", "gcfn"), spk + ".feed_forward")


def _spk_split(out: List[Entry], path: Path, key: str):
    _conv1x1(out, path + ("proj_in",), key + ".linear.0")
    _conv1x1(out, path + ("proj_out",), key + ".linear.2")
    _norm(out, path + ("norm",), key + ".norm")


def _output_layer(out: List[Entry], path: Path, key: str):
    _linear(out, path + ("proj_in",), key + ".end_conv1x1.0")
    _linear(out, path + ("proj_out",), key + ".end_conv1x1.2")


def mapping_entries(cfg: ModelConfig) -> List[Entry]:
    """The flax-path <-> state_dict-key table of one configuration."""
    out: List[Entry] = [
        Entry("enc_conv_w", "params", ("audio_encoder", "kernel"),
              "audio_encoder.conv1d.weight")]
    _norm(out, ("feature_projector", "norm"), "feature_projector.norm")
    _conv1x1(out, ("feature_projector", "proj"),
             "feature_projector.conv1d", bias=False)
    sep = ("separator",)
    out.append(Entry("identity", "params", sep + ("pos_emb", "pe_k"),
                     "separator.pos_emb.pe_k.weight"))
    for s in range(cfg.num_stages):
        _enc_stage(out, sep + (f"enc_{s}",), f"separator.enc_stages.{s}",
                   down=True)
    _enc_stage(out, sep + ("bottleneck",), "separator.bottleneck_G",
               down=False)
    if cfg.per_stage_spk_split:
        # Large_DM_WHAM: num_stages + 1 independent blocks
        for s in range(cfg.num_stages + 1):
            _spk_split(out, sep + (f"spk_split_{s}",),
                       f"separator.spk_split_block.{s}")
    else:
        _spk_split(out, sep + ("spk_split",), "separator.spk_split_block")
    for s in range(cfg.num_stages):
        _conv1x1(out, sep + (f"fusion_{s}",), f"separator.simple_fusion.{s}")
        _dec_stage(out, sep + (f"dec_{s}",), f"separator.dec_stages.{s}")
    _output_layer(out, ("out_layer",), "out_layer")
    out.append(Entry("dec_conv_w", "params", ("audio_decoder", "kernel"),
                     "audio_decoder.weight"))
    for s in range(cfg.num_stages):
        _output_layer(out, (f"aux_out_layer_{s}",), f"out_layer_bn.{s}")
        out.append(Entry("dec_conv_w", "params",
                         (f"aux_decoder_{s}", "kernel"),
                         f"decoder_bn.{s}.weight"))
    return out


def _get(tree: Mapping, path: Path) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.array(node, np.float32)  # a writable copy


def jax_state_dict(params: Mapping, batch_stats: Mapping,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's (and the reference's) state_dict from flax trees given
    as nested dicts of numpy arrays.  BatchNorm ``num_batches_tracked``
    buffers are 0."""
    trees = {"params": params, "batch_stats": batch_stats}
    sd: Dict[str, torch.Tensor] = {}
    for kind, coll, path, key in mapping_entries(cfg):
        value = TO_TORCH[kind](_get(trees[coll], path))
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = (
                torch.zeros((), dtype=torch.long))
    return sd


def from_jax_params(params: Mapping, batch_stats: Mapping, cfg: ModelConfig,
                    device="cuda"):
    """A port SepReformer on ``device`` (eval mode) holding the flax
    weights, loaded with ``load_state_dict(strict=True)``."""
    from sepreformer_torch.models.sepreformer import (
        SepReformer,
        resolve_device,
    )

    device = resolve_device(device)
    model = SepReformer(cfg)
    model.load_state_dict(jax_state_dict(params, batch_stats, cfg),
                          strict=True)
    return model.to(device).eval()
