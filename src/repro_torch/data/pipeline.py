"""Deterministic synthetic token batches (numpy), the port's copy of the
reference's ``data/pipeline.py`` for the ``"text"`` modality.

Every batch is a pure function of (seed, step): the same seed and step
give the reference's tokens array for array.  The token stream has
learnable affine structure plus noise.  Per-host slicing and the
background prefetcher come with the trainer (ROADMAP A.11).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticLM"]


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, *, structure: float = 0.7,
                 modality: str = "text"):
        if modality != "text":
            raise NotImplementedError(
                f"modality {modality!r} is not ported yet (ROADMAP A.11); "
                f"the port serves text")
        self.vocab = vocab
        self.seq = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.structure = structure
        self.modality = modality

    def batch(self, step: int) -> dict:
        """The full global batch for ``step``: int32 ``tokens`` and
        ``labels`` (tokens shifted left by one, wrapping), numpy."""
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
        return {"tokens": toks, "labels": labels}
