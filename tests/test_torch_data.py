"""The port's data pipeline (``sepreformer_torch/data``) against the JAX
package's on the CPU: the synthetic corpus, the loaders' batches with and
without dynamic mixing, and ``collate``'s length buckets."""

import dataclasses
import os

import numpy as np
import pytest

from sepreformer_tpu.config import DatasetConfig as JaxDatasetConfig
from sepreformer_tpu.data import dataset as jax_dataset
from sepreformer_tpu.data.synth import generate_corpus as jax_generate
from sepreformer_torch.config import DatasetConfig
from sepreformer_torch.data import dataset
from sepreformer_torch.data.synth import generate_corpus

SIZES = dict(n_train=4, n_valid=2, n_test=2, utt_seconds=(0.5, 1.0), seed=0)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same corpus written by the port and by the JAX package."""
    port = tmp_path_factory.mktemp("port")
    ref = tmp_path_factory.mktemp("jax")
    generate_corpus(str(port), **SIZES)
    jax_generate(str(ref), **SIZES)
    return port, ref


def test_generate_corpus_is_bit_identical_to_jax(corpora):
    port, ref = corpora
    files = sorted(os.path.relpath(os.path.join(d, n), port)
                   for d, _, names in os.walk(port) for n in names)
    assert len(files) == 3 * 8 + 9     # mix, s1, s2 wavs; nine scp files
    assert files == sorted(os.path.relpath(os.path.join(d, n), ref)
                           for d, _, names in os.walk(ref) for n in names)
    for name in files:
        got = (port / name).read_bytes()
        want = (ref / name).read_bytes()
        if name.endswith(".scp"):     # absolute paths under each root
            want = want.replace(str(ref).encode(), str(port).encode())
        assert got == want, name


def loader_batches(module, cfg, root, epochs=(1, 2)):
    loaders = module.build_dataloaders(cfg, "train", scp_root=str(root),
                                       seed=3)
    out = []
    for part in ("train", "valid", "test"):
        for epoch in epochs:
            loaders[part].set_epoch(epoch)
            out.extend((part, epoch, b) for b in loaders[part])
    return out


@pytest.mark.parametrize("dynamic,workers", [(False, 1), (True, 1),
                                             (True, 2)])
def test_loaders_yield_the_jax_batches(corpora, dynamic, workers):
    """Two epochs of every loader: the same mixtures, sources, lengths and
    keys in the same order, with dynamic mixing off and on (one worker,
    and two, whose per-item generators are spawned in order)."""
    port, _ = corpora
    kw = dict(scp_dir="scp", max_len=4000, batch_size=2,
              dynamic_mixing=dynamic, num_workers=workers)
    got = loader_batches(dataset, DatasetConfig(**kw), port)
    want = loader_batches(jax_dataset, JaxDatasetConfig(**kw), port)
    assert len(got) == len(want) == 2 * (2 + 1 + 2)
    for (part, epoch, g), (_, _, w) in zip(got, want):
        msg = f"{part} epoch {epoch}"
        assert g.keys == w.keys, msg
        np.testing.assert_array_equal(g.mixture, w.mixture, err_msg=msg)
        np.testing.assert_array_equal(g.sources, w.sources, err_msg=msg)
        np.testing.assert_array_equal(g.input_sizes, w.input_sizes,
                                      err_msg=msg)


def test_collate_buckets_match_jax():
    """Sorted longest first and padded to the batch max rounded up to the
    bucket (0.5 s at 8 kHz), or to ``pad_to``."""
    rng = np.random.default_rng(4)
    items = []
    for i, n in enumerate((3001, 5400, 4000, 120)):
        items.append((rng.normal(size=n).astype(np.float32),
                      [rng.normal(size=n).astype(np.float32)
                       for _ in range(2)], f"k{i}"))
    for pad_to in (None, 4096, 2000):
        g = dataset.collate(items, pad_to)
        w = jax_dataset.collate(items, pad_to)
        assert dataclasses.astuple(g)[3] == w.keys
        for a, b in zip(dataclasses.astuple(g)[:3],
                        dataclasses.astuple(w)[:3]):
            np.testing.assert_array_equal(a, b)
    assert dataset.collate(items).mixture.shape == (4, 8000)
    assert dataset.collate(items).keys == ["k1", "k2", "k0", "k3"]
