"""Deterministic synthetic data pipeline with per-host slicing and a
prefetcher (numpy), the port's copy of the reference's
``data/pipeline.py``.

Every batch is a pure function of (seed, step): the same seed and step
give the reference's arrays, array for array, for every modality
(``"text"``, ``"audio_frames"``, ``"image+text"``).  The token stream
has learnable affine structure plus noise; the audio frames and image
embeddings are the stub frontends' inputs, standard normal.
``local_slice`` cuts one rank's rows out of the global batch, and
``prefetch`` generates batches on a background thread.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticLM"]


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, *, structure: float = 0.7,
                 modality: str = "text", d_frontend: int = 0,
                 n_img_tokens: int = 0):
        if modality not in ("text", "audio_frames", "image+text"):
            raise ValueError(f"unknown modality {modality!r}")
        self.vocab = vocab
        self.seq = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.structure = structure
        self.modality = modality
        self.d_frontend = d_frontend
        self.n_img_tokens = n_img_tokens

    def batch(self, step: int) -> dict:
        """The full global batch for ``step``, numpy: int32 ``tokens``
        and ``labels`` (tokens shifted left by one, wrapping); for
        ``"audio_frames"`` float32 ``frames`` (B, S, d_frontend) with the
        tokens as ``labels`` and an all-ones int32 ``mask``; for
        ``"image+text"`` also float32 ``img_embed`` (B, n_img_tokens,
        d_frontend)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s, v = self.global_batch, self.seq, self.vocab
        # per-sequence arithmetic ramp t_i = t0 + c*i, mixed with noise
        c = rng.integers(1, min(v, 17), (b, 1))
        t0 = rng.integers(0, v, (b, 1))
        ar = np.arange(s)[None, :]
        toks = (t0 + c * ar) % v
        noise = rng.random((b, s)) > self.structure
        toks = np.where(noise, rng.integers(0, v, (b, s)), toks)
        toks = toks.astype(np.int32)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        out = {"tokens": toks, "labels": labels}
        if self.modality == "audio_frames":
            frames = rng.standard_normal(
                (b, s, self.d_frontend)).astype(np.float32)
            out = {"frames": frames, "labels": toks,
                   "mask": np.ones((b, s), np.int32)}
        elif self.modality == "image+text":
            out["img_embed"] = rng.standard_normal(
                (b, self.n_img_tokens, self.d_frontend)).astype(np.float32)
        return out

    def local_slice(self, step: int, rank: int, world: int) -> dict:
        """Rank ``rank``'s rows of ``batch(step)``, the global batch
        split evenly over ``world`` ranks."""
        if self.global_batch % world:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {world} ranks")
        per = self.global_batch // world
        full = self.batch(step)
        return {k: v[rank * per:(rank + 1) * per] for k, v in full.items()}

    def prefetch(self, start_step: int, n_steps: int, depth: int = 2,
                 rank: int = 0, world: int = 1):
        """Iterator of ``(step, local_slice(step, rank, world))`` for
        ``n_steps`` steps from ``start_step``, generated ``depth`` ahead
        on a background thread."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = object()

        def worker():
            for s in range(start_step, start_step + n_steps):
                q.put((s, self.local_slice(s, rank, world)))
            q.put(stop)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        th.join()
