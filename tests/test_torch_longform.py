"""The port's long-form front ends against the JAX package on the CPU.

- ``serving.separate_chunked`` (the port's copy) against the JAX
  package's, with one numpy ``forward_batch`` and no model, bit for bit,
  over several lengths and hops.
- ``Separator.__call__`` against the JAX package's ``Separator`` from the
  same weights: a wav path written at 16 kHz, ``engine.mvn``, and
  ``chunk_seconds`` shorter than the input.
- ``python -m sepreformer_torch.cli --engine-mode infer_sample`` on a
  small variant writes finite wavs, and exits 2 without a sample file.
- ``load_separator`` on a directory of the port's checkpoints loads the
  latest epoch.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sepreformer_tpu import api as jax_api
from sepreformer_tpu import config as jax_config
from sepreformer_tpu import serving as jax_serving
from sepreformer_torch import build_model, cli, get_variant, serving
from sepreformer_torch.api import Separator, load_separator
from sepreformer_torch.data.audio import read_wav, write_wav
from sepreformer_torch.engine import create_train_state, save_checkpoint
from sepreformer_torch.models import from_jax_params

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_slice import PARITY, flax_trees

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fake_forward(batch):
    """[N, C] -> [N, 2, C]: two 'speakers' of each chunk, swapped in the
    chunks whose mean is positive, so the stitch has to realign them."""
    a = np.tanh(3.0 * batch)
    b = np.cumsum(batch, axis=-1) * 0.01
    out = np.stack([a, b], axis=1)
    swap = batch.mean(axis=-1) > 0
    out[swap] = out[swap][:, ::-1]
    return out.astype(np.float32)


@pytest.mark.parametrize("total,chunk,hop", [(900, 1000, None),
                                             (5000, 1000, None),
                                             (5003, 800, 300),
                                             (20011, 1200, 1200),
                                             (30000, 1000, 450)])
def test_separate_chunked_matches_jax(total, chunk, hop):
    """Inputs shorter than a chunk, ragged last batches (more than eight
    chunks), a hop equal to the chunk and odd hops."""
    wav = np.random.default_rng(total).normal(size=total).astype(np.float32)
    assert serving.chunk_starts(total, chunk, hop or chunk // 2) == \
        jax_serving.chunk_starts(total, chunk, hop or chunk // 2)
    got = serving.separate_chunked(fake_forward, wav, chunk, hop)
    ref = jax_serving.separate_chunked(fake_forward, wav, chunk, hop)
    assert got.shape == (2, total) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("total,chunk_seconds,chunked", [
    (5000, None, False), (5000, 0.7, False), (5601, 0.7, True),
    (20000, 0.49, True)])
def test_separate_long_chooses_the_route(total, chunk_seconds, chunked):
    """Chunks only past ``chunk_seconds``, cut to the encoder stride (0.7 s
    at 8 kHz is 5600 samples, 0.49 s is 3920); full context otherwise."""
    wav = np.random.default_rng(total).normal(size=total).astype(np.float32)
    widths = []

    def forward_batch(batch):
        widths.append(batch.shape[1])
        return fake_forward(batch)

    def full_context(x):
        return np.stack([x, -x])

    got = serving.separate_long(forward_batch, full_context, wav,
                                chunk_seconds, 8000, 16)
    if chunked:
        chunk = int(chunk_seconds * 8000) // 16 * 16
        assert set(widths) == {chunk}
        np.testing.assert_array_equal(
            got, serving.separate_chunked(fake_forward, wav, chunk))
    else:
        assert widths == []
        np.testing.assert_array_equal(got, np.stack([wav, -wav]))


@pytest.fixture(scope="module")
def weights():
    """Seeded tiny weights as flax trees, LayerScale 0.5."""
    cfg = get_variant("tiny").model
    return flax_trees(build_model(cfg, device="cpu"), cfg)


def separators(weights, mvn=False, chunk_seconds=None):
    """The port's and the JAX package's Separator on the same weights."""
    port_cfg = get_variant("tiny")
    port_cfg = dataclasses.replace(port_cfg, engine=dataclasses.replace(
        port_cfg.engine, mvn=mvn))
    m = port_cfg.model
    jcfg = jax_config.VariantConfig(
        name="tiny",
        model=jax_config.ModelConfig(**{k: getattr(m, k) for k in (
            "num_stages", "num_spks", "enc_dim", "enc_kernel", "enc_stride",
            "feat_dim", "num_heads", "pos_maxlen", "local_kernel",
            "down_kernel")}, dropout=0.0),
        engine=jax_config.EngineConfig(mvn=mvn))
    params, stats = weights
    port = Separator(port_cfg, from_jax_params(params, stats, m,
                                               device="cpu"),
                     chunk_seconds=chunk_seconds)
    ref = jax_api.Separator(variant=jcfg, params=params, batch_stats=stats,
                            chunk_seconds=chunk_seconds)
    return port, ref


def test_separator_reads_a_wav_path_at_the_model_rate(weights, tmp_path):
    """A 16 kHz file is resampled to 8 kHz by both packages."""
    rng = np.random.default_rng(4)
    path = str(tmp_path / "mix16k.wav")
    write_wav(path, 0.3 * rng.uniform(-1, 1, size=4810), 16000)
    port, ref = separators(weights)
    got, want = port(path), ref(path)
    assert [g.shape for g in got] == [(2405,), (2405,)]
    np.testing.assert_allclose(np.stack(got), np.stack(want), **PARITY)


def test_separator_applies_mvn(weights):
    wav = (0.05 + 0.2 * np.random.default_rng(5).normal(size=1500)).astype(
        np.float32)
    port, ref = separators(weights, mvn=True)
    got = np.stack(port(wav))
    np.testing.assert_allclose(got, np.stack(ref(wav)), **PARITY)
    plain, _ = separators(weights)
    assert not np.allclose(got, np.stack(plain(wav)), rtol=1e-2, atol=1e-3)


def test_separator_serves_long_inputs_in_chunks(weights):
    """2.5 s at 8 kHz in 0.49 s chunks (3920 samples, a multiple of the
    stride): ten chunks go through two batches of eight, the last padded."""
    wav = (0.2 * np.random.default_rng(6).normal(size=20000)).astype(
        np.float32)
    port, ref = separators(weights, chunk_seconds=0.49)
    calls = []
    forward = port.separate
    port.separate = lambda batch, lengths=None: (
        calls.append((batch.shape, lengths)) or forward(batch, lengths))
    got = port(wav)
    assert calls == [((8, 3920), None), ((8, 3920), None)]
    assert [g.shape for g in got] == [(20000,), (20000,)]
    np.testing.assert_allclose(np.stack(got), np.stack(ref(wav)), **PARITY)
    # an input no longer than a chunk takes the full-context path
    assert [g.shape for g in port(wav[:3000])] == [(3000,), (3000,)]


def test_cli_infer_sample_writes_wavs(tmp_path):
    wav_path = str(tmp_path / "mix.wav")
    write_wav(wav_path, 0.3 * np.random.default_rng(7).uniform(
        -1, 1, size=3000), 8000)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "sepreformer_torch.cli", "--model", "tiny",
         "--device", "cpu", "--engine-mode", "infer_sample", "--sample-file",
         wav_path, "--workdir", str(tmp_path / "work"), "--out-wav-dir",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = [f"mix_{s}.wav" for s in ("in", "out_0", "out_1")]
    assert proc.stdout.split() == [str(out / n) for n in names[1:]]
    for name in names:
        x, rate = read_wav(str(out / name))
        assert rate == 8000 and x.shape == (3000,)
        assert np.isfinite(x).all() and 0.85 < np.abs(x).max() <= 0.9


def test_cli_infer_sample_in_chunks(tmp_path, capsys):
    wav_path = str(tmp_path / "long.wav")
    write_wav(wav_path, 0.3 * np.random.default_rng(8).uniform(
        -1, 1, size=6000), 8000)
    assert cli.main(["--model", "tiny", "--device", "cpu", "--engine-mode",
                     "infer_sample", "--sample-file", wav_path,
                     "--chunk-seconds", "0.25", "--workdir",
                     str(tmp_path / "work")]) == 0
    outs = capsys.readouterr().out.split()
    assert outs == [str(tmp_path / f"long_out_{i}.wav") for i in (0, 1)]
    for path in outs:
        x, _ = read_wav(path)
        assert x.shape == (6000,) and np.isfinite(x).all()


def test_cli_infer_sample_needs_a_sample_file(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--engine-mode", "infer_sample", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--sample-file" in capsys.readouterr().err


def test_load_separator_takes_the_latest_epoch(tmp_path):
    cfg = get_variant("tiny")
    ckpt_dir = str(tmp_path / "scratch_weights")
    for epoch, seed in ((1, 1), (3, 3), (2, 2)):
        state = create_train_state(
            cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        save_checkpoint(ckpt_dir, epoch, state)
    sep = load_separator("tiny", checkpoint=ckpt_dir, device="cpu")
    latest = build_model(cfg.model, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    for name, p in latest.state_dict().items():
        torch.testing.assert_close(sep.model.state_dict()[name], p,
                                   rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        load_separator("tiny", checkpoint=str(tmp_path), device="cpu")
