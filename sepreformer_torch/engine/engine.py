"""Run-loop engine of the port: train, test and test_save on one card.

The JAX package's ``engine/engine.py`` (the reference Engine's observable
behaviour, models/<VARIANT>/engine.py) on the port's train and eval steps:

- resume from the latest ``epoch.NNNN.pth`` checkpoint (engine.py:30-36),
  from ``log/pretrain_weights`` when it holds one;
- warmup LR stepped per iteration during epoch 1 only (engine.py:61);
- plateau LR on the valid loss for epoch > start_scheduling
  (engine.py:201);
- progressive aux-loss weighting alpha per epoch (engine.py:72);
- inline test at ``test_epochs`` (engine.py:204-208);
- best-checkpoint saving with proper best tracking, or the reference's
  per-epoch reset with ``strict_reference_best`` (engine.py:194);
- per-utterance metric CSVs during test (engine.py:118-136);
- ``test_save`` writes peak-normalized (x0.5) wavs (engine.py:137-144);
- ``infer_sample`` separates one wav file in full context or in chunks
  (engine.py:152-172).

One process on one device.  Not ported: grouped dispatch
(``steps_per_dispatch``; ROADMAP.md queue A, "One dispatch per step: CUDA
graphs"), the mesh and multi-host paths (queue A, "``parallel/``") and
TensorBoard (queue A, "Run-time utilities").
"""

from __future__ import annotations

import csv
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sepreformer_torch.config import VariantConfig
from sepreformer_torch.data.audio import peak_normalize, read_wav, write_wav
from sepreformer_torch.data.dataset import DataLoader
from sepreformer_torch.engine.checkpoint import (
    latest_epoch,
    load_checkpoint,
    save_checkpoint,
)
from sepreformer_torch.engine.factories import make_lr_controller
from sepreformer_torch.engine.train import (
    check_trainable,
    create_train_state,
    eval_step,
    train_step,
)
from sepreformer_torch.losses import progressive_alpha
from sepreformer_torch.metrics import pit_sisnri_np, sdri_np
from sepreformer_torch.serving import separate_long

log = logging.getLogger("sepreformer_torch")


def apply_cmvn(x: np.ndarray, lengths: Optional[np.ndarray] = None
               ) -> np.ndarray:
    """Per-utterance mean/variance normalization (utils/functions.py:1-4),
    applied when engine.mvn is set (engine.py:57).  With ``lengths`` the
    statistics span only each row's true samples."""
    if lengths is None:
        return (x - x.mean(axis=-1, keepdims=True)) / (
            x.std(axis=-1, keepdims=True) + 1e-8)
    lengths = np.asarray(lengths)
    m = np.arange(x.shape[-1])[None] < lengths[:, None]
    cnt = lengths[:, None].astype(np.float64)
    mean = (x * m).sum(-1, keepdims=True) / cnt
    var = (np.square(x - mean) * m).sum(-1, keepdims=True) / cnt
    return ((x - mean) / (np.sqrt(var) + 1e-8)).astype(x.dtype) * m


def _host_sum(values) -> float:
    """The float64 sum of 0-d device tensors, with one transfer."""
    if not values:
        return 0.0
    return float(torch.stack(values).double().sum().cpu())


class Engine:
    """The epoch loop.  ``workdir`` plays the role of the reference's model
    directory (checkpoints under ``<workdir>/log/scratch_weights``).  The
    weights and then every step's dropout come from one CPU generator
    seeded with ``seed``."""

    def __init__(self, cfg: VariantConfig, workdir: str,
                 dataloaders: Optional[Dict[str, DataLoader]] = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.workdir = workdir
        self.loaders = dataloaders or {}
        os.makedirs(workdir, exist_ok=True)
        pretrain = os.path.join(workdir, "log", "pretrain_weights")
        scratch = os.path.join(workdir, "log", "scratch_weights")
        self.ckpt_dir = (pretrain if latest_epoch(pretrain) is not None
                         else scratch)
        self.generator = torch.Generator().manual_seed(seed)
        self.state = create_train_state(cfg, device=device,
                                        generator=self.generator)
        self.device = next(self.state.model.parameters()).device
        self.lr_ctl = make_lr_controller(cfg)
        self.start_epoch = 1
        restored = load_checkpoint(self.ckpt_dir, self.state)
        if restored is not None:
            _, extra, ep = restored
            self.lr_ctl.load_state_dict(extra.get("lr_ctl", {}))
            self.start_epoch = ep + 1
            log.info("resumed from epoch %d (%s)", ep, self.ckpt_dir)
        self.best_valid = float("inf")

    def _prep(self, batch):
        mix = batch.mixture
        if self.cfg.engine.mvn:
            mix = apply_cmvn(mix)
        return torch.from_numpy(mix), torch.from_numpy(batch.sources)

    # -- phases ------------------------------------------------------------

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        loader = self.loaders["train"]
        loader.set_epoch(epoch)
        crit = self.cfg.criterion
        alpha = progressive_alpha(epoch, crit.alpha,
                                  crit.alpha_decay_start_epoch,
                                  crit.alpha_decay_factor,
                                  crit.alpha_decay_every)
        spks = self.cfg.model.num_spks
        every = self.cfg.engine.log_every_steps
        # the losses stay 0-d device tensors until a log line or the end
        # of the epoch, so no step waits on the card
        time_losses, mag_losses = [], []
        for batch in loader:
            if epoch == 1:
                self.lr_ctl.warmup_step()  # per-iteration warmup
            mix, src = self._prep(batch)
            metrics = train_step(self.state, mix, src, self.lr_ctl.lr, alpha,
                                 self.generator)
            time_losses.append(metrics["time_loss"])
            mag_losses.append(metrics["mag_loss_mean"])
            n = len(time_losses)
            if every and n % every == 0:
                log.info("epoch %d step %d/%d: T_loss %.4f F_loss %.4f "
                         "lr %.2e", epoch, n, len(loader),
                         _host_sum(time_losses) / n / spks,
                         _host_sum(mag_losses) / n / spks, self.lr_ctl.lr)
        n = max(1, len(time_losses))
        return {"time_loss": _host_sum(time_losses) / spks / n,
                "mag_loss": _host_sum(mag_losses) / spks / n}

    def _validate(self) -> Dict[str, float]:
        time_losses, mag_losses = [], []
        for batch in self.loaders["valid"]:
            mix, src = self._prep(batch)
            metrics = eval_step(self.state, mix, src)
            time_losses.append(metrics["time_loss"])
            mag_losses.append(metrics["mag_loss_mean"])
        spks = self.cfg.model.num_spks
        n = max(1, len(time_losses))
        return {"time_loss": _host_sum(time_losses) / spks / n,
                "mag_loss": _host_sum(mag_losses) / spks / n}

    def _test(self, wav_dir: Optional[str] = None,
              compute_sdr: bool = True) -> Dict[str, float]:
        """Per-utterance SI-SNRi (+SDRi) with CSV dumps (engine.py:113-149).

        The forward takes the true lengths (masked eval), so bucket
        padding is invisible; the metrics run on the host at true length
        in float64, BSS-eval SDR on a thread pool beside the forwards."""
        model = self.state.model
        rows_sisnr, sdr_futures = [], []
        tot_sisnri, n = 0.0, 0
        pool = ThreadPoolExecutor(max_workers=4) if compute_sdr else None
        rate = self.cfg.dataset.sampling_rate
        for batch in self.loaders["test"]:
            mix = batch.mixture
            if self.cfg.engine.mvn:
                mix = apply_cmvn(mix, batch.input_sizes)
            with torch.inference_mode():
                audio = model(
                    torch.from_numpy(mix).to(self.device),
                    lengths=torch.as_tensor(np.asarray(batch.input_sizes),
                                            device=self.device), aux=False)
            audio = audio.cpu().numpy()
            for j in range(batch.batch_size):
                t = int(batch.input_sizes[j])
                key = batch.keys[j]
                est = audio[:, j, :t]
                src = batch.sources[:, j, :t]
                mixture = batch.mixture[j, :t]
                mean_i, per_src = pit_sisnri_np(est, src, mixture)
                rows_sisnr.append([key, mean_i, *per_src])
                tot_sisnri += mean_i
                if compute_sdr:
                    sdr_futures.append(
                        (key, pool.submit(sdri_np, est, src, mixture)))
                if wav_dir:
                    os.makedirs(wav_dir, exist_ok=True)
                    write_wav(os.path.join(wav_dir, f"{key}_mix.wav"),
                              peak_normalize(mixture, 0.5), rate)
                    for i in range(est.shape[0]):
                        write_wav(os.path.join(wav_dir, f"{key}_spk{i+1}.wav"),
                                  peak_normalize(est[i], 0.5), rate)
                n += 1
        rows_sdr, tot_sdri = [], 0.0
        if compute_sdr:
            for key, fut in sdr_futures:
                mean_s, per_s = fut.result()
                rows_sdr.append([key, mean_s, *per_s])
                tot_sdri += mean_s
            pool.shutdown()
        for name, rows in (("test_SISNRi_value.csv", rows_sisnr),
                           ("test_SDRi_value.csv", rows_sdr)):
            if rows:
                with open(os.path.join(self.workdir, name), "w",
                          newline="") as f:
                    csv.writer(f).writerows(rows)
        out = {"sisnri": float(tot_sisnri) / max(1, n)}
        if compute_sdr:
            out["sdri"] = float(tot_sdri) / max(1, n)
        log.info("test: %s over %d utterances", out, n)
        return out

    def infer_sample(self, sample_file: str, out_dir: Optional[str] = None,
                     chunk_seconds: Optional[float] = None) -> List[str]:
        """Separate one wav file (engine.py:152-172) and write
        ``<stem>_in.wav`` and ``<stem>_out_<i>.wav``, peak-normalized to
        0.9, into ``out_dir`` (default: the file's directory).  The whole
        file goes through one forward, padded to the encoder stride, unless
        it is longer than ``chunk_seconds``: then it is separated in
        overlapping chunks (``serving.separate_chunked``).  Returns the
        output paths."""
        out_dir = out_dir or os.path.dirname(os.path.abspath(sample_file))
        rate = self.cfg.dataset.sampling_rate
        wav, sr = read_wav(sample_file, sr=rate)
        if self.cfg.engine.mvn:
            wav = apply_cmvn(wav[None])[0]
        stride = self.cfg.model.enc_stride

        def forward(batch: np.ndarray) -> np.ndarray:   # -> [spks, N, T]
            with torch.inference_mode():
                audio = self.state.model(
                    torch.from_numpy(batch).to(self.device), aux=False)
            return audio.cpu().numpy()

        def full_context(wav: np.ndarray) -> np.ndarray:
            t = len(wav)
            x = np.pad(wav, (0, (-t) % stride))[None].astype(np.float32)
            return forward(x)[:, 0, :t]

        audio = separate_long(
            lambda batch: forward(batch).transpose(1, 0, 2), full_context,
            wav, chunk_seconds, rate, stride)
        stem = os.path.splitext(os.path.basename(sample_file))[0]
        os.makedirs(out_dir, exist_ok=True)
        write_wav(os.path.join(out_dir, f"{stem}_in.wav"),
                  peak_normalize(wav, 0.9), sr)
        outs = []
        for i in range(audio.shape[0]):
            path = os.path.join(out_dir, f"{stem}_out_{i}.wav")
            write_wav(path, peak_normalize(audio[i], 0.9), sr)
            outs.append(path)
        return outs

    # -- main loop ---------------------------------------------------------

    def run(self, engine_mode: str = "train",
            out_wav_dir: Optional[str] = None) -> Dict[str, Any]:
        if "test" in engine_mode:
            return self._test(
                wav_dir=(out_wav_dir or os.path.join(self.workdir, "wav_out"))
                if engine_mode == "test_save" else None)
        check_trainable(self.cfg)
        eng = self.cfg.engine
        history = []
        session_initial_valid = None
        for epoch in range(self.start_epoch, eng.max_epoch):
            t0 = time.time()
            if (eng.strict_reference_best and session_initial_valid is None
                    and "valid" in self.loaders):
                # reference quirk (engine.py:187-194): the best tracker is
                # re-seeded from an initial validation pass every epoch
                session_initial_valid = self._validate()["time_loss"]
            train_m = self._train_epoch(epoch)
            valid_loss = self._validate()["time_loss"]
            if eng.strict_reference_best:
                self.best_valid = session_initial_valid
            if epoch > eng.start_scheduling:
                self.lr_ctl.plateau_step(valid_loss)
            if epoch in eng.test_epochs and "test" in self.loaders:
                self._test(compute_sdr=False)
            nth = eng.save_every_n_epochs
            if valid_loss < self.best_valid or (nth and epoch % nth == 0):
                # best-checkpoint policy (util_engine.py:80-111) plus the
                # reference's unused save_checkpoint_per_nth as an opt-in
                if valid_loss < self.best_valid:
                    self.best_valid = valid_loss
                save_checkpoint(self.ckpt_dir, epoch, self.state, extra={
                    "lr_ctl": self.lr_ctl.state_dict(),
                    "train_loss": train_m["time_loss"],
                    "valid_loss": valid_loss,
                })
            log.info("epoch %d: train %.4f valid %.4f lr %.2e (%.1fs)",
                     epoch, train_m["time_loss"], valid_loss, self.lr_ctl.lr,
                     time.time() - t0)
            history.append({"epoch": epoch, **train_m, "valid": valid_loss})
        return {"history": history}
