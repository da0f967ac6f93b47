"""Host-side data pipeline: scp datasets, dynamic mixing, static-shape
batches.  The port's copy of the JAX package's ``data/dataset.py``: the
same arithmetic and the same draws from the same seeds.

Differences from the reference loader (models/<VARIANT>/dataset.py):

- train/valid batches are padded to exactly ``max_len`` samples, one
  shape for every step (the reference pads to the batch max);
- eval batches are padded to a length *bucket* (multiple of
  ``eval_bucket``), with true lengths carried alongside for metric
  truncation on host;
- per-host key sharding for multi-host data parallelism (the reference is
  single-process);
- background thread prefetch instead of torch DataLoader workers.

Dynamic-mixing flavors reproduce each variant's semantics (SURVEY.md §2.7):
  wsj0  — different-speaker second utterance, RMS-norm to source 1,
          +-5 dB gains (SepReformer_Large_DM_WSJ0/dataset.py:93-140)
  wham  — + noise scp, crop seeded at max_len, no same-speaker check
          (SepReformer_Large_DM_WHAM/dataset.py:89-146)
  whamr — reverberant sources build the mixture, anechoic sources are the
          targets, +-3 dB source / -6..+3 dB noise gains, co-cropped pairs
          (SepReformer_Large_DM_WHAMR/dataset.py:89-154)
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from sepreformer_torch.config import DatasetConfig
from sepreformer_torch.data.audio import read_wav
from sepreformer_torch.data.scp import parse_scps


@dataclass
class Batch:
    """One host batch (numpy, ready for device put)."""

    mixture: np.ndarray        # [B, T] float32
    sources: np.ndarray        # [spks, B, T] float32
    input_sizes: np.ndarray    # [B] int32 true lengths
    keys: List[str]

    @property
    def batch_size(self) -> int:
        return self.mixture.shape[0]


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x)))) or 1.0


def _match_length(rng: np.random.Generator, wav: np.ndarray, length: int) -> np.ndarray:
    """Random crop to ``length`` (reference __match_length)."""
    leftover = len(wav) - length
    idx = int(rng.integers(0, leftover + 1)) if leftover > 0 else 0
    return wav[idx : idx + length]


def _truncate_to_stride(mix, srcs, stride: int = 4):
    """Drop trailing samples so len % stride == 0 (ref: dataset.py:148-151)."""
    rem = len(mix) % stride
    if rem:
        mix = mix[:-rem]
        srcs = [s[:-rem] for s in srcs]
    return mix, srcs


def _wsj_speakers(key: str) -> Tuple[str, str]:
    """WSJ mixture key '<utt1>_<g1>_<utt2>_<g2>' -> speaker ids (first 3
    chars of each utterance field)."""
    parts = key.split("_")
    return parts[0][:3], parts[2][:3]


class SeparationDataset:
    """Mixture + per-speaker source dataset over scp manifests."""

    def __init__(
        self,
        cfg: DatasetConfig,
        partition: str,
        scp_root: str = ".",
    ):
        self.cfg = cfg
        self.partition = partition
        scp_dir = os.path.join(scp_root, cfg.scp_dir)
        names = {
            "train": (cfg.train_mixture, cfg.train_sources),
            "valid": (cfg.valid_mixture, cfg.valid_sources),
            "test": (cfg.test_mixture, cfg.test_sources),
        }[partition]
        self.mix_dict = parse_scps(os.path.join(scp_dir, names[0]))
        self.src_dicts = [parse_scps(os.path.join(scp_dir, s)) for s in names[1]]
        self.noise_dict = None
        self.reverb_dicts: List[Dict[str, str]] = []
        if partition == "train":
            if cfg.train_noise:
                self.noise_dict = parse_scps(os.path.join(scp_dir, cfg.train_noise))
            self.reverb_dicts = [
                parse_scps(os.path.join(scp_dir, s)) for s in cfg.train_reverb_sources
            ]
        self.keys = sorted(self.mix_dict)
        self.dynamic = cfg.dynamic_mixing and partition == "train"

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def num_spks(self) -> int:
        return len(self.src_dicts)

    def load(self, key: str, rng: np.random.Generator):
        """-> (mixture, [sources]) float32, stride-truncated, train-cropped."""
        if self.dynamic:
            flavor = self.cfg.dm_flavor
            if flavor == "wsj0":
                return self._dm_wsj0(key, rng)
            if flavor == "wsj0_base":
                return self._dm_wsj0_base(key, rng)
            if flavor == "wham":
                return self._dm_wham(key, rng)
            if flavor == "whamr":
                return self._dm_whamr(key, rng)
            raise ValueError(f"unknown dm_flavor {flavor!r}")
        return self._direct(key, rng)

    # -- loading strategies ------------------------------------------------

    def _read(self, table: Dict[str, str], key: str) -> np.ndarray:
        path = table[key]
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        x, _ = read_wav(path, sr=self.cfg.sampling_rate)
        return x

    def _direct(self, key: str, rng: np.random.Generator):
        srcs = [self._read(d, key) for d in self.src_dicts]
        mix = self._read(self.mix_dict, key)
        mix, srcs = _truncate_to_stride(mix, srcs)
        if self.partition != "test" and len(mix) > self.cfg.max_len:
            start = int(rng.integers(0, len(mix) - self.cfg.max_len + 1))
            mix = mix[start : start + self.cfg.max_len]
            srcs = [s[start : start + self.cfg.max_len] for s in srcs]
        return mix, srcs

    def _pick_partner(self, key: str, rng: np.random.Generator,
                      check_speaker: bool) -> str:
        keys = self.keys
        while True:
            cand = keys[int(rng.integers(0, len(keys)))]
            if not check_speaker:
                return cand
            a1, a2 = _wsj_speakers(key)
            b1, b2 = _wsj_speakers(cand)
            if a1 != b2 and a2 != b1:
                return cand

    def _two_sources(self, key: str, rng, check_speaker: bool,
                     gain_db: float):
        """Load source1 from ``key`` and source2 from a random partner,
        RMS-normalized to source 1, each with a random +-gain_db dB gain."""
        partner = self._pick_partner(key, rng, check_speaker)
        i1, i2 = (0, 1) if rng.random() > 0.5 else (1, 0)
        files = [(self.src_dicts[i1], key), (self.src_dicts[i2], partner)]
        srcs, ref_rms = [], None
        for idx, (table, k) in enumerate(files):
            x = self._read(table, k)
            if idx == 0:
                ref_rms = _rms(x)
            x = x * (ref_rms / _rms(x))
            gain = 10.0 ** (-rng.uniform(-gain_db, gain_db) / 20.0)
            srcs.append(gain * x)
        return srcs, ref_rms

    def _dm_wsj0(self, key: str, rng: np.random.Generator):
        srcs, _ = self._two_sources(key, rng, check_speaker=True, gain_db=5.0)
        min_len = min(len(s) for s in srcs)
        srcs = [_match_length(rng, s, min_len) for s in srcs]
        mix = sum(srcs)
        mix, srcs = _truncate_to_stride(mix, srcs)
        if len(mix) > self.cfg.max_len:
            start = int(rng.integers(0, len(mix) - self.cfg.max_len + 1))
            mix = mix[start : start + self.cfg.max_len]
            srcs = [s[start : start + self.cfg.max_len] for s in srcs]
        return mix, srcs

    def _dm_wsj0_base(self, key: str, rng: np.random.Generator):
        """Base-variant dynamic mixing (SepReformer_Base_WSJ0/
        dataset.py:85-133): ±2.5 dB random gains and NO RMS normalization
        of the partner source (unlike the Large flavor's ref_rms matching).

        Reference quirks, handled explicitly:
        - its same-speaker check compares key fields 1 and 3 — the GAIN
          fields of a wsj0-2mix key, not the utterance/speaker fields
          (Base dataset.py:98-100; the Large variant checks fields 0/2) —
          kept faithfully;
        - it calls ``self.speed_aug`` (dataset.py:112), an attribute
          ``MyDataset.__init__`` never sets (``speed_list`` is accepted
          and dropped, dataset.py:66), so enabling this flavor upstream
          crashes with AttributeError.  The augmentation therefore does
          not exist in any runnable form and is omitted here.
        """
        keys = self.keys
        while True:
            cand = keys[int(rng.integers(0, len(keys)))]
            p, c = key.split("_"), cand.split("_")
            if p[1][:3] != c[3][:3] and p[3][:3] != c[1][:3]:
                partner = cand
                break
        i1, i2 = (0, 1) if rng.random() > 0.5 else (1, 0)
        srcs = []
        for table, k in [(self.src_dicts[i1], key),
                         (self.src_dicts[i2], partner)]:
            x = self._read(table, k)
            gain = 10.0 ** (-rng.uniform(-2.5, 2.5) / 20.0)
            srcs.append(gain * x)
        min_len = min(len(s) for s in srcs)
        srcs = [_match_length(rng, s, min_len) for s in srcs]
        mix = sum(srcs)
        mix, srcs = _truncate_to_stride(mix, srcs)
        if len(mix) > self.cfg.max_len:
            start = int(rng.integers(0, len(mix) - self.cfg.max_len + 1))
            mix = mix[start : start + self.cfg.max_len]
            srcs = [s[start : start + self.cfg.max_len] for s in srcs]
        return mix, srcs

    def _dm_wham(self, key: str, rng: np.random.Generator):
        srcs, ref_rms = self._two_sources(key, rng, check_speaker=False, gain_db=5.0)
        noise = self._read(self.noise_dict, key)
        noise = noise * (ref_rms / _rms(noise))
        noise = noise * 10.0 ** (-rng.uniform(-5.0, 5.0) / 20.0)
        min_len = min([self.cfg.max_len] + [len(s) for s in srcs] + [len(noise)])
        srcs = [_match_length(rng, s, min_len) for s in srcs]
        noise = _match_length(rng, noise, min_len)
        mix = sum(srcs) + noise
        mix, srcs = _truncate_to_stride(mix, srcs)
        return mix, srcs

    def _dm_whamr(self, key: str, rng: np.random.Generator):
        partner = self._pick_partner(key, rng, check_speaker=False)
        i1, i2 = (0, 1) if rng.random() > 0.5 else (1, 0)
        pairs = [(i1, key), (i2, partner)]
        anech, reverb, ref_rms = [], [], None
        for idx, (si, k) in enumerate(pairs):
            a = self._read(self.src_dicts[si], k)
            r = self._read(self.reverb_dicts[si], k)
            if idx == 0:
                ref_rms = _rms(a)
            factor = ref_rms / _rms(a)
            gain = 10.0 ** (-rng.uniform(-3.0, 3.0) / 20.0)
            anech.append(gain * factor * a)
            reverb.append(gain * factor * r)
        noise = self._read(self.noise_dict, key)
        noise = noise * (ref_rms / _rms(noise))
        noise = noise * 10.0 ** (-rng.uniform(-6.0, 3.0) / 20.0)
        min_len = min(
            [self.cfg.max_len]
            + [len(a) for a in anech]
            + [len(noise)]
        )
        # co-crop each (reverb, anechoic) pair at the same offset
        co, srcs = [], []
        for a, r in zip(anech, reverb):
            stacked = np.stack([r[: len(a)], a[: len(r)]], axis=-1)
            stacked = _match_length(rng, stacked, min_len)
            co.append(stacked[..., 0])
            srcs.append(stacked[..., 1])
        noise = _match_length(rng, noise, min_len)
        mix = sum(co) + noise
        mix, srcs = _truncate_to_stride(mix, srcs)
        return mix, srcs


def collate(
    items: Sequence[Tuple[np.ndarray, List[np.ndarray], str]],
    pad_to: Optional[int] = None,
    bucket: int = 4000,
) -> Batch:
    """Assemble a static-shape batch.

    items: list of (mixture, sources, key).  Sorted by length descending
    (matching the reference collate, dataset.py:40-61) and zero-padded to
    ``pad_to`` if given, else to the batch max rounded up to ``bucket``.
    """
    items = sorted(items, key=lambda it: len(it[0]), reverse=True)
    spks = len(items[0][1])
    sizes = np.array([len(it[0]) for it in items], np.int32)
    if pad_to is None:
        pad_to = int(-(-sizes.max() // bucket) * bucket)
    b = len(items)
    mixture = np.zeros((b, pad_to), np.float32)
    sources = np.zeros((spks, b, pad_to), np.float32)
    keys = []
    for i, (mix, srcs, key) in enumerate(items):
        t = min(len(mix), pad_to)
        mixture[i, :t] = mix[:t]
        for s in range(spks):
            sources[s, i, :t] = srcs[s][:t]
        keys.append(key)
    return Batch(mixture, sources, np.minimum(sizes, pad_to), keys)


class DataLoader:
    """Thread-prefetched batch iterator with per-host sharding.

    For multi-host data parallelism each host loads a disjoint shard of the
    keys (``host_id``/``num_hosts``); batches per host are the global batch
    divided by the number of hosts.
    """

    def __init__(
        self,
        dataset: SeparationDataset,
        batch_size: int,
        shuffle: bool,
        pad_to: Optional[int],
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        drop_last: bool = False,
        prefetch: int = 4,
        eval_bucket: int = 4000,
        sort_by_length: bool = False,
        num_workers: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_to = pad_to
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.eval_bucket = eval_bucket
        self.sort_by_length = sort_by_length
        self.num_workers = max(1, num_workers)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _key_order(self) -> List[str]:
        keys = self.dataset.keys[self.host_id :: self.num_hosts]
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            keys = list(keys)
            rng.shuffle(keys)
        elif self.sort_by_length:
            # batched eval: similar-length utterances share a batch so the
            # bucket-padded shape wastes little compute and few distinct
            # shapes get compiled.  File size is length-proportional for
            # PCM wavs — no need to decode headers.
            mix = self.dataset.mix_dict
            keys = sorted(
                keys,
                key=lambda k: (os.path.getsize(mix[k])
                               if os.path.exists(mix[k]) else 0),
                reverse=True,
            )
        return list(keys)

    def __len__(self) -> int:
        if self.drop_last:
            # lockstep across hosts: every host must run the SAME number of
            # train steps per epoch or the collectives deadlock when
            # one host's shard has one extra batch.  The global minimum is
            # len(keys) // num_hosts keys per host.
            return (len(self.dataset.keys) // self.num_hosts) // self.batch_size
        n = len(self.dataset.keys[self.host_id :: self.num_hosts])
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        keys = self._key_order()
        batches = [
            keys[i : i + self.batch_size]
            for i in range(0, len(keys), self.batch_size)
        ]
        if self.drop_last:
            batches = batches[: len(self)]  # cross-host lockstep, see __len__
        rng = np.random.default_rng((self.seed, self._epoch, self.host_id))

        pool = (
            ThreadPoolExecutor(self.num_workers)
            if self.num_workers > 1 else None
        )

        def produce(out_q: queue.Queue):
            try:
                for group in batches:
                    if pool is None:
                        items = [
                            (*self.dataset.load(key, rng), key)
                            for key in group
                        ]
                    else:
                        # per-item child generators, spawned sequentially:
                        # crops/remixes are deterministic in (seed, epoch,
                        # item index) regardless of thread scheduling
                        rngs = rng.spawn(len(group))
                        futs = [
                            pool.submit(self.dataset.load, key, r)
                            for key, r in zip(group, rngs)
                        ]
                        items = [
                            (*f.result(), key)
                            for f, key in zip(futs, group)
                        ]
                    out_q.put(collate(items, self.pad_to, self.eval_bucket))
                out_q.put(None)
            except BaseException as e:  # surface worker errors to consumer
                out_q.put(e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def build_dataloaders(
    cfg: DatasetConfig,
    engine_mode: str,
    scp_root: str = ".",
    host_id: int = 0,
    num_hosts: int = 1,
    seed: int = 0,
) -> Dict[str, DataLoader]:
    """Build {train,valid,test} loaders (test-only when evaluating,
    ref: dataset.py:15; test batch size forced to 1, ref: dataset.py:30)."""
    partitions = ["test"] if "test" in engine_mode else ["train", "valid", "test"]
    loaders = {}
    for part in partitions:
        ds = SeparationDataset(cfg, part, scp_root)
        if part == "test":
            # host-sharded like train/valid: on a pod every utterance is
            # evaluated by exactly one host (Engine._test merges rows and
            # globally reduces the summary metric)
            loaders[part] = DataLoader(
                ds, batch_size=cfg.eval_batch_size, shuffle=False,
                pad_to=None, seed=seed,
                host_id=host_id, num_hosts=num_hosts,
                sort_by_length=cfg.eval_batch_size > 1,
                num_workers=cfg.num_workers,
            )
        else:
            loaders[part] = DataLoader(
                ds,
                batch_size=cfg.batch_size,
                shuffle=True,
                pad_to=cfg.max_len,
                seed=seed,
                host_id=host_id,
                num_hosts=num_hosts,
                drop_last=True,
                num_workers=cfg.num_workers,
            )
    return loaders
