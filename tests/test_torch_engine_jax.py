"""The port's run loop held against the JAX package's on the CPU.

The two Engines train the same tiny one-stage model (the port Engine's
weights, handed to the JAX Engine in flax layout through the converter's
table) at dropout 0 on one generated corpus with the same loader seed:
two epochs, a resume for the third, then ``test``.  Per step the learning
rate and the aux-loss weight alpha must agree, per epoch the train and
valid losses and the plateau decision, at the end the saved epochs, the
LR controller's restored state and the test SI-SNRi and SDRi.  The epoch loop's policy
(plateau schedule, best tracking, ``strict_reference_best``, periodic
saves, inline tests) runs against JAX's on scripted validation losses.
The LR controller and the factories are in ``test_torch_engine.py``.
"""

import csv
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.data.dataset import (
    build_dataloaders as jax_build_dataloaders,
)
from sepreformer_tpu.engine import engine as jax_engine_module
from sepreformer_tpu.engine.train import TrainState as JaxTrainState
from sepreformer_tpu.engine.train import make_optimizer as jax_make_optimizer
from sepreformer_torch.data.dataset import build_dataloaders
from sepreformer_torch.data.synth import generate_corpus
from sepreformer_torch.engine import engine as engine_module
from test_torch_engine import one_torch_thread, variants  # noqa: F401
from test_torch_train import to_flax

RTOL = 1e-3   # losses and metrics after a few optimizer steps


NO_DATA = {"train": None, "valid": None, "test": None}


def jax_engine(monkeypatch, jcfg, workdir, loaders, model):
    """The JAX package's Engine starting from the port ``model``'s
    weights (its own initializer runs op by op on the CPU, 40 s even at
    this size), without TensorBoard (not ported, and its import alone
    takes seconds)."""
    sd = model.state_dict()
    params = jax.tree.map(jnp.asarray, to_flax(sd, jcfg.model))
    stats = jax.tree.map(jnp.asarray, to_flax(sd, jcfg.model, "batch_stats"))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats,
                          opt_state=jax_make_optimizer(jcfg).init(params))
    monkeypatch.setattr(jax_engine_module, "create_train_state",
                        lambda cfg, rng, sample_len=None: state)
    eng = jax_engine_module.Engine(jcfg, workdir, loaders)
    eng._tb = lambda: None
    return eng


@pytest.mark.parametrize("strict,nth", [(False, 0), (True, 0), (False, 2)])
def test_run_policy_matches_jax(tmp_path, monkeypatch, strict, nth):
    """``run`` on scripted phases: which epochs save and with what extra,
    the LR each epoch trains at, the inline tests, the history."""
    valid = [5.0, 4.0, 4.5, 4.5, 3.0, 3.5, 3.5, 2.0]
    cfg, jcfg = variants(max_epoch=8, start_scheduling=2, test_epochs=(3, 5),
                         strict_reference_best=strict,
                         save_every_n_epochs=nth)
    port = engine_module.Engine(cfg, str(tmp_path / "p"), NO_DATA,
                                device="cpu")
    engines = {"port": port,
               "jax": jax_engine(monkeypatch, jcfg, str(tmp_path / "j"),
                                 NO_DATA, port.state.model)}
    trace = {name: [] for name in engines}
    for name, module in (("port", engine_module), ("jax", jax_engine_module)):
        monkeypatch.setattr(
            module, "save_checkpoint",
            lambda d, ep, st, extra, log=trace[name]: log.append(
                ("save", ep, extra)))
    history = {}
    for name, eng in engines.items():
        log, losses = trace[name], iter(valid)

        def train_epoch(epoch, eng=eng, log=log):
            log.append(("train", epoch, eng.lr_ctl.lr))
            return {"time_loss": float(epoch), "mag_loss": 0.5}

        eng._train_epoch = train_epoch
        eng._validate = lambda losses=losses: {"time_loss": next(losses),
                                               "mag_loss": 0.0}
        eng._test = lambda wav_dir=None, compute_sdr=True, log=log: (
            log.append(("test", compute_sdr)) or {})
        history[name] = eng.run("train")["history"]
        log.append(("end", eng.lr_ctl.state_dict()))
    assert trace["port"] == trace["jax"]
    assert history["port"] == history["jax"]
    assert any(e[0] == "save" for e in trace["port"])


# -- two epochs, a resume and a test, end to end ------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(str(root), n_train=4, n_valid=2, n_test=2,
                    utt_seconds=(0.5, 1.0), seed=0)
    return str(root)


def engines(monkeypatch, corpus, tmp_path, steps, plateaus, before=None,
            **engine):
    """A port and a JAX Engine on the corpus from the same weights, in
    workdirs that persist across calls (so a second call resumes, each
    from its own checkpoint); each logs (lr, alpha) per train step into
    ``steps`` and (valid loss, lr) per plateau step into ``plateaus``.
    The JAX Engine takes the jitted steps of the JAX Engine ``before``
    where given: they depend on the model, loss and optimizer settings
    alone, and tracing the train step again would take 14 s."""
    cfg, jcfg = variants(**engine)
    port = engine_module.Engine(
        cfg, str(tmp_path / "port"),
        build_dataloaders(cfg.dataset, "train", scp_root=corpus),
        device="cpu")
    ref = jax_engine(
        monkeypatch, jcfg, str(tmp_path / "jax"),
        jax_build_dataloaders(jcfg.dataset, "train", scp_root=corpus),
        port.state.model)

    if before is not None:
        ref.eval_step = before.eval_step
    step = ref.jitted_step = (ref.train_step if before is None
                              else before.jitted_step)

    def jax_step(state, mix, src, lr, alpha, rng):
        steps["jax"].append((float(lr), float(alpha)))
        return step(state, mix, src, lr, alpha, rng)

    ref.train_step = jax_step
    for name, eng in (("port", port), ("jax", ref)):
        ctl = eng.lr_ctl
        plateau = ctl.plateau_step

        def logged(loss, ctl=ctl, plateau=plateau, log=plateaus[name]):
            plateau(loss)
            log.append((loss, ctl.lr))

        ctl.plateau_step = logged
    return port, ref


def saved_epochs(ckpt_dir):
    return sorted(int(m.group(1)) for n in os.listdir(ckpt_dir)
                  if (m := re.match(r"^epoch\.(\d+)", n)))


def test_engine_trains_resumes_and_tests_like_jax(corpus, tmp_path,
                                                  monkeypatch):
    steps = {"port": [], "jax": []}
    plateaus = {"port": [], "jax": []}
    port_step = engine_module.train_step

    def logged_step(state, mix, src, lr, alpha, generator):
        steps["port"].append((lr, alpha))
        return port_step(state, mix, src, lr, alpha, generator)

    monkeypatch.setattr(engine_module, "train_step", logged_step)

    port, ref = engines(monkeypatch, corpus, tmp_path, steps, plateaus)
    history = {"port": port.run("train")["history"],
               "jax": ref.run("train")["history"]}

    port, ref = engines(monkeypatch, corpus, tmp_path, steps, plateaus,
                        before=ref, max_epoch=4)
    assert port.start_epoch == ref.start_epoch > 1
    got, want = port.lr_ctl.state_dict(), ref.lr_ctl.state_dict()
    np.testing.assert_allclose(got.pop("best"), want.pop("best"), rtol=RTOL)
    assert got == want
    history["port"] += port.run("train")["history"]
    history["jax"] += ref.run("train")["history"]

    assert [h["epoch"] for h in history["port"]] == [
        h["epoch"] for h in history["jax"]]
    assert history["port"][-1]["epoch"] == 3
    for a, b in zip(history["port"], history["jax"]):
        for key in ("time_loss", "mag_loss", "valid"):
            np.testing.assert_allclose(a[key], b[key], rtol=RTOL,
                                       err_msg=f"epoch {a['epoch']} {key}")
    assert len(steps["port"]) == len(steps["jax"]) == 2 * len(
        history["port"])
    np.testing.assert_allclose(steps["port"], steps["jax"], rtol=1e-6)
    assert len(plateaus["port"]) == len(plateaus["jax"]) > 0
    np.testing.assert_allclose(plateaus["port"], plateaus["jax"], rtol=RTOL)
    assert saved_epochs(port.ckpt_dir) == saved_epochs(ref.ckpt_dir)

    got, want = port.run("test"), ref.run("test")
    assert set(got) == set(want) == {"sisnri", "sdri"}
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=1e-3, err_msg=key)
    for name in ("test_SISNRi_value.csv", "test_SDRi_value.csv"):
        rows = []
        for workdir in (port.workdir, ref.workdir):
            with open(os.path.join(workdir, name)) as f:
                rows.append(list(csv.reader(f)))
        assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
        np.testing.assert_allclose(
            np.array([r[1:] for r in rows[0]], float),
            np.array([r[1:] for r in rows[1]], float), rtol=RTOL, atol=1e-3,
            err_msg=name)
