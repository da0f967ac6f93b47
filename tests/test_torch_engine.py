"""The port's run loop on the CPU: metrics and SI-SNRi losses, the LR
controller and the name-driven optimizer and criterion factories against
the JAX package, checkpoints, config overrides, and a tiny model trained,
resumed and tested through ``python -m sepreformer_torch.cli``'s
``main`` (the JAX package's ``tests/test_engine.py`` cases).  The Engine
itself against JAX's Engine is in ``test_torch_engine_jax.py``."""

import csv
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu import config as jax_config
from sepreformer_tpu import losses as jax_losses
from sepreformer_tpu import metrics as jax_metrics
from sepreformer_tpu.config import apply_override as jax_apply_override
from sepreformer_tpu.config import get_variant as jax_get_variant
from sepreformer_tpu.engine import factories as jax_factories
from sepreformer_tpu.engine.lr_control import LRController as JaxLRController
from sepreformer_torch import cli, config, losses, metrics
from sepreformer_torch.config import (
    ModelConfig,
    VariantConfig,
    apply_override,
    from_reference_yaml,
    get_variant,
)
from sepreformer_torch.data.synth import generate_corpus
from sepreformer_torch.engine import (
    create_train_state,
    latest_epoch,
    load_checkpoint,
    save_checkpoint,
    train_step,
)
from sepreformer_torch.engine import factories
from sepreformer_torch.engine.factories import make_optimizer_by_name
from sepreformer_torch.engine.lr_control import LRController
from sepreformer_torch.engine.train import TrainState, apply_gradients
from sepreformer_torch.models import build_model


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: beside the other test workers, each
    taking the CPU's cores, torch's own pool oversubscribed them and the
    training tests ran 25 to 60 times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def signals(seed, spks=2, t=1200):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(spks, t))
    est = src[::-1] + 0.3 * rng.normal(size=(spks, t))
    return est, src, src.sum(0)


@pytest.mark.parametrize("spks", [2, 3])
def test_metrics_match_jax(spks):
    est, src, mix = signals(spks, spks)
    assert metrics.sisnr_np(est[0], src[0]) == jax_metrics.sisnr_np(
        est[0], src[0])
    got, want = (metrics.pit_sisnri_np(est, src, mix),
                 jax_metrics.pit_sisnri_np(est, src, mix))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    if spks > 2:
        return   # BSS-eval's 512-tap solves grow with the speakers squared
    for g, w in zip(metrics.sdri_np(est, src, mix),
                    jax_metrics.sdri_np(est, src, mix)):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    for g, w in zip(metrics.bss_eval_sources(src, est),
                    jax_metrics.bss_eval_sources(src, est)):
        np.testing.assert_allclose(g, w, rtol=1e-12)


@pytest.mark.parametrize("spks", [2, 3])
def test_sisnr_losses_match_jax(spks):
    rng = np.random.default_rng(10 + spks)
    src = rng.normal(size=(spks, 3, 800)).astype(np.float32)
    est = (src[::-1] + 0.5 * rng.normal(size=src.shape)).astype(np.float32)
    mix = src.sum(0)
    np.testing.assert_allclose(
        losses.sisnr_db(torch.from_numpy(est), torch.from_numpy(src)).numpy(),
        np.asarray(jax_losses.sisnr_db(jnp.asarray(est), jnp.asarray(src))),
        rtol=1e-5, atol=1e-4)
    got = losses.pit_sisnr_improvement(torch.from_numpy(est),
                                       torch.from_numpy(src),
                                       torch.from_numpy(mix))
    want = jax_losses.pit_sisnr_improvement(jnp.asarray(est),
                                            jnp.asarray(src),
                                            jnp.asarray(mix))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def variants(**engine):
    """The same tiny variant as the port's and as the JAX package's config.
    Warmup spans three steps (two per epoch), the plateau halves the LR
    after one bad epoch from epoch 2 on, alpha decays from epoch 2."""
    sections = {
        "model": ("ModelConfig", dict(
            num_stages=1, num_spks=2, enc_dim=16, feat_dim=16, num_heads=2,
            pos_maxlen=64, local_kernel=9, dropout=0.0)),
        "optim": ("OptimConfig", dict(lr=1e-3, warmup_steps=3,
                                      plateau_factor=0.5,
                                      plateau_patience=0)),
        "dataset": ("DatasetConfig", dict(scp_dir="scp", max_len=4000,
                                          batch_size=2, num_workers=1)),
        "criterion": ("CriterionConfig", dict(alpha_decay_start_epoch=1,
                                              alpha_decay_every=1)),
        "engine": ("EngineConfig", dict(dict(max_epoch=3, start_scheduling=1,
                                             test_epochs=()), **engine)),
    }

    def build(pkg):
        return pkg.VariantConfig(name="tiny", **{
            key: getattr(pkg, cls)(**kw)
            for key, (cls, kw) in sections.items()})

    return build(config), build(jax_config)


def test_lr_controller_matches_jax():
    """Warmup, the relative threshold, patience, the min_lr clamp and a
    restore from the other package's state dict mid-way."""
    kw = dict(base_lr=1e-3, warmup_steps=3, plateau_factor=0.5,
              plateau_patience=1, min_lr=2e-4)
    port, ref = LRController(**kw), JaxLRController(**kw)
    for _ in range(5):
        port.warmup_step()
        ref.warmup_step()
        assert port.lr == ref.lr
    losses = [1.0, 1.0, 0.99995, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95,
              0.5, 0.6]
    for i, loss in enumerate(losses):
        if i == 6:
            port = LRController(**kw)
            port.load_state_dict(ref.state_dict())
        port.plateau_step(loss)
        ref.plateau_step(loss)
        assert port.state_dict() == ref.state_dict(), i
        assert port.lr == ref.lr, i
    assert ref.lr == kw["min_lr"]   # the clamp was reached
    cfg, jcfg = variants()
    assert (factories.make_lr_controller(cfg).state_dict()
            == jax_factories.make_lr_controller(jcfg).state_dict())
    no_warmup = ("ReduceLROnPlateau",)
    assert (factories.make_lr_controller(cfg, no_warmup).lr
            == jax_factories.make_lr_controller(jcfg, no_warmup).lr)


@pytest.mark.parametrize("name,kw", [
    ("AdamW", dict(weight_decay=1e-2)),
    ("Adam", dict()),
    ("SGD", dict(momentum=0.9)),
    ("SGD", dict(momentum=0.9, nesterov=True)),
])
def test_optimizer_by_name_matches_optax(name, kw):
    """Three steps of the port's optimizer after its global-norm clip
    (``apply_gradients``) against JAX's optax chain for the same name."""
    cfg, jcfg = variants()
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(scale=s, size=w0.shape).astype(np.float32)
             for s in (0.5, 4.0, 0.1)]   # the second one is clipped
    lrs = [1e-2, 5e-3, 2e-2]

    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    state = TrainState(cfg, module, factories.make_optimizer_by_name(
        cfg, module.parameters(), name, **kw), stft_kernel=None)
    tx = jax_factories.make_optimizer_by_name(jcfg, name, **kw)
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    for g, lr in zip(grads, lrs):
        module.w.grad = torch.from_numpy(g)
        apply_gradients(state, lr)
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state,
                                       params)
        params = {"w": params["w"] + lr * updates["w"]}
        np.testing.assert_allclose(module.w.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-5,
                                   atol=1e-6)


def test_criterions_match_jax():
    cfg, jcfg = variants()
    port = factories.make_criterions(cfg, device="cpu")
    ref = jax_factories.make_criterions(jcfg)
    assert list(port) == list(ref)
    rng = np.random.default_rng(4)
    src = rng.normal(size=(2, 2, 2048)).astype(np.float32)
    est = (src[::-1] + 0.3 * rng.normal(size=src.shape)).astype(np.float32)
    mix = src.sum(0)
    t = {k: torch.from_numpy(v) for k, v in (("e", est), ("s", src),
                                             ("m", mix))}
    j = {k: jnp.asarray(v) for k, v in (("e", est), ("s", src), ("m", mix))}
    for name in ("PIT_SISNR_mag", "PIT_SISNR_time"):
        np.testing.assert_allclose(float(port[name](t["e"], t["s"])),
                                   float(ref[name](j["e"], j["s"])),
                                   rtol=1e-4, err_msg=name)
    for got, want in zip(port["PIT_SISNRi"](t["e"], t["s"], t["m"]),
                         ref["PIT_SISNRi"](j["e"], j["s"], j["m"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    for got, want in zip(port["PIT_SDRi"](est[:, 0], src[:, 0], mix[0]),
                         ref["PIT_SDRi"](est[:, 0], src[:, 0], mix[0])):
        np.testing.assert_allclose(got, want, rtol=1e-12)


TINY = dict(num_stages=1, num_spks=2, enc_dim=16, feat_dim=16, num_heads=2,
            pos_maxlen=64, local_kernel=9)


@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD"])
def test_checkpoint_round_trip(tmp_path, name):
    """Weights, BatchNorm statistics, the optimizer's state and the extra
    dict come back from ``epoch.NNNN.pth``; the latest epoch wins."""
    cfg = VariantConfig("tiny", model=ModelConfig(**TINY))

    def fresh(seed):
        model = build_model(cfg.model, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
        state = create_train_state(cfg, model=model)
        state.optimizer = make_optimizer_by_name(
            cfg, model.parameters(), name,
            **({"momentum": 0.9} if name == "SGD" else {}))
        return state

    state = fresh(0)
    s = torch.from_numpy(np.random.default_rng(1).normal(
        scale=0.1, size=(2, 2, 800)).astype(np.float32))
    train_step(state, s.sum(0), s, 1e-3, 0.4,
               torch.Generator().manual_seed(2))
    save_checkpoint(str(tmp_path), 1, state, extra={"lr_ctl": {"best": 1.5}})
    path = save_checkpoint(str(tmp_path), 7, state,
                           extra={"valid_loss": -3.0})
    assert os.path.basename(path) == "epoch.0007.pth"
    assert latest_epoch(str(tmp_path)) == 7
    back, extra, ep = load_checkpoint(str(tmp_path), fresh(5))
    assert (ep, extra, back.step) == (7, {"valid_loss": -3.0}, 1)
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              back.model.state_dict().items()):
        assert torch.equal(a, b), n
    want = state.optimizer.state_dict()
    got = back.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"])
    for idx, entry in want["state"].items():
        assert set(got["state"][idx]) == set(entry)
        for key, value in entry.items():
            if torch.is_tensor(value):
                assert torch.equal(got["state"][idx][key], value), key
            else:
                assert got["state"][idx][key] == value, key
    assert load_checkpoint(str(tmp_path / "none"), fresh(0)) is None


def test_apply_override_matches_jax():
    cases = [("optim.warmup_steps", "100"), ("engine.test_epochs", "3,5"),
             ("dataset.dynamic_mixing", "on"), ("model.dropout", "0.1"),
             ("dataset.train_noise", "tr_n.scp"), ("engine.mvn", "false")]
    cfg, jcfg = get_variant("SepReformer_Base_WSJ0"), jax_get_variant(
        "SepReformer_Base_WSJ0")
    for dotted, raw in cases:
        cfg = apply_override(cfg, dotted, raw)
        jcfg = jax_apply_override(jcfg, dotted, raw)
        section, key = dotted.split(".")
        assert (getattr(getattr(cfg, section), key)
                == getattr(getattr(jcfg, section), key)), dotted
    with pytest.raises(KeyError):
        apply_override(cfg, "optim.nope", "1")
    with pytest.raises(KeyError):
        apply_override(cfg, "optim", "1")
    with pytest.raises(ValueError):
        apply_override(cfg, "engine.mvn", "maybe")


def test_list_models(capsys):
    assert cli.main(["--list-models"]) == 0
    assert capsys.readouterr().out.split() == [
        "SepReformer_Base_Libri2Mix", "SepReformer_Base_WSJ0",
        "SepReformer_L", "SepReformer_Large_DM_WHAM",
        "SepReformer_Large_DM_WHAMR", "SepReformer_Large_DM_WSJ0", "tiny"]


@pytest.mark.parametrize("flag", [["--engine-mode", "infer_sample"],
                                  ["--data-parallel", "2"],
                                  ["--model-parallel", "2"]])
def test_cli_refuses_what_is_not_ported(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(flag + ["--device", "cpu"])
    assert exc.value.code == 2
    # infer_sample is ported: without --sample-file it is refused, as in JAX
    expected = ("--sample-file" if "infer_sample" in flag
                else "ROADMAP.md queue A, parallel/")
    assert expected in capsys.readouterr().err


def test_reference_yaml_refuses_embed_v(tmp_path):
    """embed_v is queued with the other variants: the refusal names the
    ROADMAP item by its title."""
    path = tmp_path / "configs.yaml"
    path.write_text("config:\n  model:\n    module_separator:\n"
                    "      relative_positional_encoding:\n"
                    "        embed_v: true\n")
    with pytest.raises(ValueError, match="queue A, the other variants"):
        from_reference_yaml(str(path))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(str(root), n_train=4, n_valid=2, n_test=2,
                    utt_seconds=(0.5, 1.0), seed=0)
    return root


def cli_args(corpus, workdir, *extra):
    return ["--model", "tiny", "--device", "cpu", "--scp-root", str(corpus),
            "--scp-dir", "scp", "--workdir", str(workdir), "--batch-size",
            "2", "--set", "dataset.max_len=4000", "--set",
            "dataset.num_workers=1", "--set", "optim.warmup_steps=4",
            "--set", "engine.start_scheduling=0", "--set",
            "engine.test_epochs=", "--set", "model.num_stages=1", *extra]


def test_cli_trains_two_epochs_resumes_and_tests(corpus, tmp_path, capsys):
    """``main`` trains epochs 1 and 2 (max_epoch 3, the reference's
    range), saves the best checkpoint, resumes to train epoch 3, then
    ``test`` writes one CSV row per utterance and prints the means."""
    work = tmp_path / "work"
    ckpts = work / "log" / "scratch_weights"
    assert cli.main(cli_args(corpus, work, "--max-epoch", "3")) == 0
    assert latest_epoch(str(ckpts)) in (1, 2)
    # a resumed run tracks its best from scratch, so epoch 3 saves
    assert cli.main(cli_args(corpus, work, "--max-epoch", "4")) == 0
    assert latest_epoch(str(ckpts)) == 3
    payload = torch.load(ckpts / "epoch.0003.pth", weights_only=True)
    assert payload["epoch"] == 3 and payload["step"] == 3 * 2
    assert np.isfinite(payload["extra"]["valid_loss"])
    capsys.readouterr()
    assert cli.main(cli_args(corpus, work, "--engine-mode", "test")) == 0
    out = capsys.readouterr().out
    assert "SI-SNRi:" in out and "SDRi:" in out
    for name in ("test_SISNRi_value.csv", "test_SDRi_value.csv"):
        with open(work / name) as f:
            rows = list(csv.reader(f))
        assert len(rows) == 2 and all(np.isfinite(float(r[1])) for r in rows)


def test_engine_history_of_a_run(corpus, tmp_path):
    """The run loop's history: epochs 1..max_epoch-1, finite losses, the
    inline test at ``test_epochs``, with the plateau schedule and the
    reference's strict best."""
    from sepreformer_torch.data.dataset import build_dataloaders
    from sepreformer_torch.engine import Engine

    cfg = get_variant("tiny")
    cfg = dataclasses.replace(
        cfg, model=ModelConfig(**TINY),
        dataset=dataclasses.replace(cfg.dataset, scp_dir="scp",
                                    max_len=4000, num_workers=1),
        engine=dataclasses.replace(cfg.engine, max_epoch=2,
                                   start_scheduling=0, test_epochs=(1,),
                                   strict_reference_best=True))
    loaders = build_dataloaders(cfg.dataset, "train", scp_root=str(corpus))
    engine = Engine(cfg, str(tmp_path / "w"), loaders, device="cpu")
    hist = engine.run("train")["history"]
    assert [h["epoch"] for h in hist] == [1]
    assert all(np.isfinite(h["time_loss"]) and np.isfinite(h["valid"])
               for h in hist)
    assert os.path.exists(tmp_path / "w" / "test_SISNRi_value.csv")
