"""The audio-only serving forward and the Large family's kernel widths, on
the CPU (no JAX).

- ``SepReformer.forward(..., aux=False)`` returns ``audio`` alone, the
  same bits as the aux-on forward's, with and without ``lengths``, also
  with one speaker-split block per stage.
- The three eval callers take it: ``Separator.separate`` (and through it
  ``Separator.__call__``, in full context and in chunks),
  ``Engine._test`` and ``Engine.infer_sample``; a forward hook on every
  aux head (``out_layer_bn``, ``decoder_bn``) never fires in them, and
  fires in ``eval_step`` (validation) and ``train_step``, whose losses
  read the aux outputs.
- The Large presets build at full width with every weight named by the
  mapping table.
- A wrapper asked for a width its kernel is not built for raises before
  anything launches, naming the ROADMAP item that builds it (meta
  tensors stand for the card's: a wrapper takes its plain version only
  for CPU tensors): K15/K16, K3b, K13 and the train kernels K7 and K9 at
  the T/S/M widths name "T/S/M".  K1 at 256 and K3 and K12 at 32 pass
  the width check, and so do a Large train step's kernels on the default
  route: K7/K8 at F 256, K9/K10 and K9b/K10b at head width 32.  K1 at F
  64, 96 and 160 and K3 and K12 at head widths 8, 12 and 20 (the T, S
  and M presets' serving path) pass it in float32, and refuse bfloat16
  naming queue B's "bfloat16 streams".
"""

import dataclasses

import numpy as np
import pytest
import torch

from sepreformer_torch import build_model, get_variant, load_separator
from sepreformer_torch.config import ModelConfig
from sepreformer_torch.data.audio import write_wav
from sepreformer_torch.data.dataset import build_dataloaders
from sepreformer_torch.engine import Engine
from sepreformer_torch.engine.train import (
    create_train_state,
    eval_step,
    train_step,
)
from sepreformer_torch.models.convert import mapping_entries
from sepreformer_torch.models.sepreformer import SepReformer
from sepreformer_torch.ops import kernels as K

TINY_SPLIT = dict(num_stages=2, enc_dim=16, feat_dim=64, num_heads=2,
                  pos_maxlen=32, local_kernel=9, per_stage_spk_split=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class AuxHeadCalls:
    """Counts the calls of a model's aux heads while it is entered."""

    def __init__(self, model):
        self.modules = [*model.out_layer_bn, *model.decoder_bn]
        self.calls = 0

    def __enter__(self):
        def hook(*_):
            self.calls += 1

        self.handles = [m.register_forward_hook(hook) for m in self.modules]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


@pytest.mark.parametrize("cfg", [get_variant("tiny").model,
                                 ModelConfig(**TINY_SPLIT)],
                         ids=["tiny", "per_stage_split"])
@pytest.mark.parametrize("lengths", [None, (800, 613)])
def test_audio_only_forward_is_bit_identical(cfg, lengths):
    model = build_model(cfg, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(2, 800)).astype(np.float32))
    lens = None if lengths is None else torch.tensor(lengths)
    with torch.inference_mode():
        audio, aux = model(x, lens)
        with AuxHeadCalls(model) as heads:
            alone = model(x, lens, aux=False)
    assert isinstance(alone, torch.Tensor)
    assert torch.equal(alone, audio)
    assert aux.shape == (cfg.num_stages, 2, 2, 800)
    assert heads.calls == 0


def test_separator_skips_the_aux_heads():
    sep = load_separator("tiny", device="cpu")
    wav = np.random.default_rng(1).normal(size=(3000,)).astype(np.float32)
    chunked = load_separator("tiny", device="cpu", chunk_seconds=0.125)
    with AuxHeadCalls(sep.model) as heads, \
            AuxHeadCalls(chunked.model) as chunk_heads:
        out = sep(wav)
        batch = sep.separate(np.stack([wav[:2000], wav[1000:3000]]),
                             [2000, 1500])
        chunks = chunked(wav)
    assert [o.shape for o in out] == [(3000,), (3000,)]
    assert tuple(batch.shape) == (2, 2, 2000)
    assert [c.shape for c in chunks] == [(3000,), (3000,)]
    assert heads.calls == chunk_heads.calls == 0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two test utterances of noise with their scp manifests."""
    root = tmp_path_factory.mktemp("corpus")
    (root / "scp").mkdir()
    rng = np.random.default_rng(3)
    lines = {"mix": [], "s1": [], "s2": []}
    for key, n in (("utt_a", 2400), ("utt_b", 3100)):
        src = (rng.normal(size=(2, n)) * 0.1).astype(np.float32)
        for sub, wav in (("s1", src[0]), ("s2", src[1]),
                         ("mix", src.sum(0))):
            path = root / f"{key}_{sub}.wav"
            write_wav(str(path), wav, 8000)
            lines[sub].append(f"{key} {path}")
    for sub, rows in lines.items():
        (root / "scp" / f"tt_{sub}.scp").write_text("\n".join(rows) + "\n")
    return root


def test_engine_eval_callers_skip_the_aux_heads(corpus, tmp_path):
    """``Engine._test`` and ``Engine.infer_sample`` run no aux head;
    ``eval_step`` and ``train_step`` run every one."""
    base = get_variant("tiny")
    cfg = dataclasses.replace(
        base, dataset=dataclasses.replace(base.dataset, scp_dir="scp",
                                          num_workers=1))
    loaders = build_dataloaders(cfg.dataset, "test", scp_root=str(corpus))
    engine = Engine(cfg, str(tmp_path / "w"), loaders, device="cpu")
    model = engine.state.model
    wav = np.random.default_rng(2).normal(size=(2401,)).astype(np.float32)
    path = str(tmp_path / "mix.wav")
    write_wav(path, wav * 0.1, 8000)
    with AuxHeadCalls(model) as heads:
        metrics = engine._test(compute_sdr=False)
        outs = engine.infer_sample(path, str(tmp_path / "out"))
    assert np.isfinite(metrics["sisnri"]) and len(outs) == 2
    assert heads.calls == 0

    state = create_train_state(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    mix = torch.from_numpy(wav[None, :2400] * 0.1)
    src = torch.stack([mix, -mix])
    per_call = cfg.model.num_stages * (1 + cfg.model.num_spks)
    with AuxHeadCalls(state.model) as heads:
        eval_step(state, mix, src)
    assert heads.calls == per_call
    with AuxHeadCalls(state.model) as heads:
        train_step(state, mix, src, 1e-4, 0.4,
                   torch.Generator().manual_seed(1))
    assert heads.calls == per_call


@pytest.mark.parametrize("name", ["SepReformer_Large_DM_WSJ0",
                                  "SepReformer_Large_DM_WHAM"])
def test_large_builds_at_full_width(name):
    cfg = get_variant(name).model
    with torch.device("meta"):
        model = SepReformer(cfg)
    assert {e.key for e in mapping_entries(cfg)} == {
        k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert model.separator.pos_emb.pe_k.weight.shape == (4000, 32)
    splits = model.separator.spk_split_block
    assert (len(splits) == cfg.num_stages + 1 if cfg.per_stage_spk_split
            else not isinstance(splits, torch.nn.ModuleList))


def meta(*shape):
    return torch.empty(*shape, device="meta")


def gcfn_args(f):
    h = 6 * f
    return meta(1, 8, f), [meta(*s) for s in [
        (f,), (f,), (f, h), (h,), (h, 3), (h,), (h // 2, f), (f,), (f,)]]


def cla_args(f):
    h = 2 * f
    return meta(1, 8, f), [meta(*s) for s in [
        (f,), (f,), (f, h), (h,), (65, f), (f,), (f, h), (h,), (h,), (h,),
        (h, f), (f,), (f,)]]


def pair_args(f):
    x, params = gcfn_args(f)
    return x, meta(1, 4, f), [meta(f), meta(f), meta(f, f), meta(f)], params


def large_train_calls():
    """A Large train step's kernels at Large's widths, on meta tensors:
    the default route's and the "pallas" route's K13/K14."""
    x, params = gcfn_args(256)
    scores, v = meta(1, 8, 128, 128), meta(1, 128, 256)
    q, table = meta(1, 8, 64, 32), meta(64, 32)
    return {
        "K7": lambda: K.gcfn_train_fwd(x, params, 1e-5, 1, 0.1),
        "K8": lambda: K.gcfn_train_bwd(x, params, 1e-5, 1, 0.1, x),
        "K7/K8 autograd": lambda: K.fused_gcfn_train(x, params, 1e-5, 1,
                                                     0.1),
        "K9/K10": lambda: K.softmax_pv_dropout(scores, v, 1, None, 100, 0.1),
        "K9b/K10b": lambda: K.softmax_pv_dropout(scores, v, 1, None, 100,
                                                 0.1, bias=scores),
        "K13/K14": lambda: K.flash_relpos_attention_train(q, q, q, table, 1,
                                                          32, 0.1),
    }


LARGE_TRAIN_BUILT = ("K7", "K8", "K7/K8 autograd", "K9/K10", "K9b/K10b",
                     "K13/K14")


@pytest.mark.parametrize("kernel", LARGE_TRAIN_BUILT)
def test_large_train_kernels_pass_the_width_check(kernel):
    """K7/K8 at F 256 and K9/K10, K9b/K10b and K13/K14 at head width 32
    are built: their wrappers refuse the meta tensors only for not lying
    on a card."""
    with pytest.raises(ValueError, match="expected meta .*CUDA"):
        large_train_calls()[kernel]()


def test_unbuilt_widths_name_their_roadmap_items():
    scores = meta(1, 8, 128, 128)
    tsm = "not built yet: ROADMAP.md queue A, T/S/M"
    with pytest.raises(ValueError, match="width 64 .*" + tsm):
        K.fused_ega_tail_gcfn(*pair_args(64), 1e-5)
    with pytest.raises(ValueError, match="width 64 .*" + tsm):
        K.fused_cla(*cla_args(64), 1e-5)
    with pytest.raises(ValueError, match="head dim 8 .*" + tsm):
        K.softmax_pv(scores, meta(1, 128, 64), None, 100, bias=scores)
    # the T/S/M train step: K7 at their widths, K9 at their head widths
    with pytest.raises(ValueError, match="width 64 .*" + tsm):
        K.gcfn_train_fwd(*gcfn_args(64), 1e-5, 1, 0.05)
    with pytest.raises(ValueError, match="head dim 8 .*" + tsm):
        K.softmax_pv_dropout(scores, meta(1, 128, 64), 1, None, 100, 0.05)
    qh = meta(1, 8, 64, 8)
    with pytest.raises(ValueError, match="head dim 8 .*" + tsm):
        K.flash_relpos_attention_train(qh, qh, qh, meta(64, 8), 1, 32, 0.1)


def test_large_serving_widths_pass_the_width_check():
    """K1, K15 and K16 at F 256 and K3, K3b and K12 at head width 32 are
    built: their wrappers refuse the meta tensors only for not lying on a
    card."""
    on_card = "expected meta .*CUDA|expected .*\\(CUDA\\)"
    with pytest.raises(ValueError, match=on_card):
        K.fused_gcfn(*gcfn_args(256), 1e-5)
    with pytest.raises(ValueError, match=on_card):
        K.fused_cla(*cla_args(256), 1e-5)
    with pytest.raises(ValueError, match=on_card):
        K.fused_ega_tail_gcfn(*pair_args(256), 1e-5)
    scores = meta(1, 8, 128, 128)
    with pytest.raises(ValueError, match=on_card):
        K.softmax_pv(scores, meta(1, 128, 256), None, 100)
    with pytest.raises(ValueError, match=on_card):
        K.softmax_pv(scores, meta(1, 128, 256), None, 100, bias=scores)
    q = meta(1, 64, 256)
    with pytest.raises(ValueError, match=on_card):
        K.flash_relpos_attention(q, q, q, meta(64, 32), 32)


# the T, S and M presets' (F, head width)
TSM_WIDTHS = [(64, 8), (96, 12), (160, 20)]


def tsm_serving_calls(f, d, dtype=torch.float32):
    """K1, K3 and K12 at a T/S/M preset's widths, on meta tensors of
    ``dtype``."""
    def m(*shape):
        return torch.empty(*shape, device="meta", dtype=dtype)

    params = gcfn_args(f)[1]
    scores, v, q = m(1, 8, 128, 128), m(1, 128, f), m(1, 64, f)
    return {"K1": lambda: K.fused_gcfn(m(1, 8, f), params, 1e-5),
            "K3": lambda: K.softmax_pv(scores, v, None, 100),
            "K12": lambda: K.flash_relpos_attention(q, q, q, m(64, d), 32)}


@pytest.mark.parametrize("kernel", ["K1", "K3", "K12"])
@pytest.mark.parametrize("f,d", TSM_WIDTHS)
def test_tsm_serving_widths_pass_the_width_check(f, d, kernel):
    """K1 at F 64, 96 and 160, K3 and K12 at head widths 8, 12 and 20 are
    built in float32: their wrappers refuse the meta tensors only for not
    lying on a card."""
    on_card = "expected meta .*CUDA|expected .*\\(CUDA\\)"
    with pytest.raises(ValueError, match=on_card):
        tsm_serving_calls(f, d)[kernel]()


@pytest.mark.parametrize("kernel", ["K1", "K3", "K12"])
@pytest.mark.parametrize("f,d", TSM_WIDTHS)
def test_tsm_serving_widths_refuse_bfloat16(f, d, kernel):
    """No bfloat16 instance at the T/S/M widths: the refusal names queue
    B's item before anything launches."""
    with pytest.raises(ValueError, match="bfloat16 .*not built yet: "
                       "ROADMAP.md queue B, bfloat16 streams"):
        tsm_serving_calls(f, d, torch.bfloat16)[kernel]()
