"""Deterministic synthetic token pipeline with background prefetch: the
JAX package's ``train/data.py``, its numpy draw bit for bit.

Determinism contract: ``batch_at(step)`` is a pure function of (seed,
step, shape), a Philox stream keyed by the seed at counter ``step``, so
after a restart step k yields bitwise the same batch, which makes resume
bitwise.  The draw stays in numpy (the reference's); tensors go to an
explicit device.  Encoder frames and image embeddings are drawn in
float32 and cast to the model dtype by torch, whose round-to-nearest-even
cast gives the bits of the reference's ``ml_dtypes`` cast.

The prefetcher double-buffers on a worker thread so host-side batch
synthesis overlaps the device step.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.common import ModelConfig
from ..models.params import torch_dtype


class SyntheticLMData:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 1234,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Tokens / labels int32 (B, S); enc_embeds / img_embeds in the
        model dtype, on this data's device."""
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=step))
        # a Zipf-ish skew so losses move like real text rather than uniform
        toks = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (toks % (self.cfg.vocab_size - 2)) + 1
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.is_encoder_decoder:
            out["enc_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.n_audio_frames, self.cfg.d_model),
                dtype=np.float32)
        if self.cfg.n_image_tokens:
            out["img_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.n_image_tokens, self.cfg.d_model),
                dtype=np.float32)
        dt = torch_dtype(self.cfg.dtype)
        return {k: torch.from_numpy(v).to(
                    dt if k.endswith("_embeds") else torch.int32
                ).to(self.device) for k, v in out.items()}


class Prefetcher:
    """Double-buffered background prefetch over ``data.batch_at``."""

    def __init__(self, data: SyntheticLMData, start_step: int = 0,
                 depth: int = 2):
        self.data = data
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.data.batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
