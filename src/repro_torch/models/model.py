"""Top-level LM: embedding or modality frontend + block stack + final
norm + head, and the serving and scoring entry points.

The counterpart of the reference's ``models/model.py`` for all ten
architectures.  ``LM`` is an ``nn.Module`` holding the parameters, named
as the reference's tree (``embed.table``, ``frontend.w``,
``stack.blocks.<l>.{ln1,mamba,attn,xgate,ln2,ffn,moe}``,
``ln_f.scale``, ``head.w``); ``build_model`` draws them from a seeded
``torch.Generator`` on the model's device.  The methods mirror the
reference's pure functions:

  forward(batch)                 -> (logits, aux)     full-sequence;
                                    aux: the MoE losses summed over layers
  loss(batch)                    -> (scalar, metrics) train objective
  score(batch)                   -> logits
  init_cache(batch, max_len)     -> cache (one dict a layer)
  prefill(batch, max_len=None)   -> (last-position logits, cache)
  decode_step(cache, tokens, pos) -> (logits, cache)

``batch`` is ``{"tokens": (B, S) int}`` for text;
``{"frames": (B, S, d_frontend) float}`` for ``"audio_frames"`` (hubert:
no token embedding, the frames go through the stub frontend, one
linear ``d_frontend -> d_model``); ``{"tokens", "img_embed": (B,
n_img_tokens, d_frontend) float}`` for ``"image+text"`` (llama-3.2-
vision: the same frontend projects the stub image embeddings, which
the cross-attention blocks read).  With ``tie_embeddings`` there is no
head: the logits are ``h @ embed.table.T`` in the compute dtype.  An
encoder-only model (``causal=False``) scores and has no decode step.
``loss`` is the reference's train objective: the token NLL (masked for
audio frames) plus the MoE losses, through the sequence-chunked
cross-entropy when the full (B, S, V) logits would be large.  The
reference's ``shard_activation`` annotations are kept at its places
(no-ops unless sharding rules are installed).

A model cut to one rank's shards (``parallel.tensor_parallel
.shard_model`` over a ``(data, model)`` mesh) has its ``parallel`` set;
every method then runs the sharded forward: the top-level leaves
gathered over the data group where FSDP splits them, the vocab-parallel
embedding, the stack over the mesh and the vocab-parallel head (and
cross-entropy).  ``loss`` takes this rank's rows (the trainer splits
the batch).  ``forward``, ``score``, ``prefill`` and ``decode_step``
take the global batch, as the reference's jitted functions do, and
each rank keeps its rows of it where the data group divides them (the
reference's ``_batch_axis``); the logits come back whole on every rank
(each rank's vocabulary block gathered over the model group, its rows
over the data group), so a greedy argmax picks the same first maximum
everywhere.  The decode cache is this rank's part of the reference's
``_cache_shardings`` (``init_cache`` builds it, ``prefill`` fills it;
``models.layers``' docstring has the layouts).  Every rank of the mesh
calls these methods together.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..parallel.sharding import shard_activation as shard
from . import layers as L
from . import transformer as T

__all__ = ["LM", "build_model", "param_count"]

MODALITIES = ("text", "audio_frames", "image+text")


class LM(nn.Module):
    """The parameters, uninitialised until ``init`` (or a load)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        if cfg.modality not in MODALITIES:
            raise ValueError(f"unknown modality {cfg.modality!r}; the "
                             f"reference has {MODALITIES}")
        if cfg.tie_embeddings and cfg.modality == "audio_frames":
            raise ValueError(f"{cfg.name}: tied embeddings need a token "
                             f"embedding, which audio frames do not have")
        dev = resolve_device(device)
        self.cfg = cfg
        #: the mesh context of a sharded model (``shard_model``)
        self.parallel = None
        if cfg.modality != "audio_frames":
            self.embed = L.Embed(cfg.vocab, cfg.d_model, cfg.param_dtype,
                                 device=dev)
        if cfg.modality != "text":
            self.frontend = L.Linear(cfg.d_frontend, cfg.d_model,
                                     cfg.param_dtype, device=dev)
        self.stack = T.Stack(cfg, device=dev)
        self.ln_f = L.RMSNorm(cfg.d_model, device=dev)
        if not cfg.tie_embeddings:
            self.head = L.Head(cfg, device=dev)

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    def init(self, generator: torch.Generator) -> "LM":
        """Draw every random parameter in place from ``generator`` (on
        the model's device): the embedding, the frontend, each layer,
        the head."""
        if hasattr(self, "embed"):
            L.embed_init(self.embed, generator)
        if hasattr(self, "frontend"):
            L.linear_init(self.frontend, generator)
        T.stack_init(self.stack, self.cfg, generator)
        if hasattr(self, "head"):
            L.head_init(self.head, self.cfg, generator)
        return self

    def param_axes(self) -> dict:
        """Each parameter's logical axes by its name: the reference's
        ``init`` axes tree, each stacked ``("layers", ...)`` leaf given
        per block without its ``"layers"`` axis."""
        cfg = self.cfg
        tree = {"ln_f": L.NORM_AXES}
        if hasattr(self, "embed"):
            tree["embed"] = L.EMBED_AXES
        if hasattr(self, "frontend"):
            tree["frontend"] = L.FRONTEND_AXES
        if hasattr(self, "head"):
            tree["head"] = L.HEAD_AXES
        for i, blk in enumerate(self.stack.blocks):
            tree[f"stack.blocks.{i}"] = T.block_axes(cfg, blk.kind)
        out = {}

        def walk(t, prefix):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{prefix}{k}.")
            else:
                out[prefix[:-1]] = t
        walk(tree, "")
        names = {n for n, _ in self.named_parameters()}
        if set(out) != names:
            raise AssertionError(f"axes and parameters differ: "
                                 f"{sorted(set(out) ^ names)}")
        return {n: out[n] for n, _ in self.named_parameters()}

    def _leaf(self, p: torch.Tensor) -> torch.Tensor:
        """A top-level parameter as the forward reads it: gathered over
        the data group where FSDP splits it."""
        return p if self.parallel is None else self.parallel.fsdp(p)

    def _head_w(self) -> torch.Tensor:
        """``head.w``, or ``embed.table.T`` when tied (gathered over the
        data group under FSDP; over a model axis, this rank's block of
        vocab ids)."""
        if self.cfg.tie_embeddings:
            return self._leaf(self.embed.table).T
        return self._leaf(self.head.w)

    def _head_raw(self, h: torch.Tensor, w=None) -> torch.Tensor:
        """The head projection WITHOUT the final norm (a pre-normed
        input): ``h @ w`` (default ``_head_w()``) in the compute dtype,
        padded vocab ids masked.  Over a model axis ``h`` enters through
        *f* and the logits are this rank's vocab block."""
        cfg = self.cfg
        par = self.parallel
        w = self._head_w() if w is None else w
        offset = 0
        if par is not None:
            h = par.copy(h)
            offset = par.tp_rank * w.shape[1]
        logits = L.mask_padded_vocab(L.linear(w, h, cfg.compute_dtype),
                                     cfg.vocab, offset)
        return shard(logits, ("batch", None, "vocab")) \
            if logits.dim() == 3 else logits

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        ln_f = self.ln_f if self.parallel is None \
            else self.parallel.view(self.ln_f)
        return self._head_raw(L.rmsnorm(ln_f, h, self.cfg.norm_eps))

    def _rows(self, batch: dict) -> dict:
        """This rank's rows of a global ``batch`` (all of it on one
        device)."""
        par = self.parallel
        if par is None:
            return batch
        n = next(iter(batch.values())).shape[0]
        return {k: v[par.rows(n)] for k, v in batch.items()}

    def _whole_logits(self, logits: torch.Tensor, n: int) -> torch.Tensor:
        """The global batch's logits (``n`` rows, every vocab id) from
        this rank's block of them."""
        par = self.parallel
        if par is None:
            return logits
        return par.whole_rows(par.gather(logits, -1), n)

    def _embed_inputs(self, batch: dict):
        """``(h (B, S, D), positions 0..S-1 of every row (B, S), img)``:
        token embeddings or projected frames, and the projected image
        tokens (B, n_img, D) for ``"image+text"`` (else None)."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        if cfg.modality == "audio_frames":
            h = L.linear(self._leaf(self.frontend.w), batch["frames"], cd)
        else:
            emb = self.embed if self.parallel is None \
                else self.parallel.view(self.embed)
            h = L.embed(emb, batch["tokens"], cd, self.parallel)
        img = None
        if cfg.modality == "image+text":
            img = L.linear(self._leaf(self.frontend.w), batch["img_embed"],
                           cd)
            img = shard(img, ("batch", None, "embed"))
        B, S = h.shape[:2]
        h = shard(h, ("batch", "seq_sp", "embed"))
        return h, torch.arange(S, device=h.device).expand(B, S), img

    def forward(self, batch: dict):
        """``(logits (B, S, V), aux)``; on a sharded model the aux sums
        are averaged over the data group where the rows split (the
        global batch's)."""
        par = self.parallel
        n = next(iter(batch.values())).shape[0]
        h, positions, img = self._embed_inputs(self._rows(batch))
        h, aux = T.stack_apply(self.stack, self.cfg, h, positions, img,
                               par)
        logits = self._whole_logits(self._head(h), n)
        if par is not None and h.shape[0] != n:
            aux = {k: par.data_mean(v) for k, v in aux.items()}
        return logits, aux

    def _loss_chunk(self, S: int) -> int:
        """Positions a cross-entropy chunk (0: no chunking):
        ``cfg.loss_chunk`` when set (-1 turns chunking off), else 256
        where S > 512 and the vocab is at least 32768, as the
        reference's auto rule."""
        cfg = self.cfg
        if cfg.loss_chunk == -1:
            return 0
        if cfg.loss_chunk > 0:
            return cfg.loss_chunk
        return 256 if (S > 512 and cfg.vocab >= 32768) else 0

    def loss(self, batch: dict):
        """``(total, metrics)``: the mean token NLL over ``batch
        ["labels"]`` (weighted by ``batch["mask"]`` where given) plus the
        MoE aux and z losses; ``metrics`` holds ``nll``, ``aux_loss``,
        ``z_loss``, ``drop_frac`` and ``loss`` (the total), float32
        scalars."""
        cfg = self.cfg
        par = self.parallel
        mask = batch.get("mask")
        labels = batch["labels"]
        chunk = self._loss_chunk(labels.shape[1])
        h, positions, img = self._embed_inputs(batch)
        h, aux = T.stack_apply(self.stack, cfg, h, positions, img, par)
        ln_f = self.ln_f if par is None else par.view(self.ln_f)
        h = L.rmsnorm(ln_f, h, cfg.norm_eps)
        # the head weight gathered once, outside the chunks' checkpoints
        w = self._head_w()
        if chunk:
            nll = L.chunked_cross_entropy(
                lambda hc: self._head_raw(hc, w), h, labels, mask, chunk,
                par)
        else:
            nll = L.cross_entropy(self._head_raw(h, w), labels, mask, par)
        total = nll + aux["aux_loss"] + aux["z_loss"]
        metrics = {"nll": nll, "aux_loss": aux["aux_loss"],
                   "z_loss": aux["z_loss"], "drop_frac": aux["drop_frac"],
                   "loss": total}
        return total, metrics

    def score(self, batch: dict) -> torch.Tensor:
        """Full-sequence logits (no cache): an encoder's scoring."""
        return self.forward(batch)[0]

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """Zeros for ``batch_size`` rows and ``max_len`` positions; on
        a sharded model this rank's part (its rows, its heads, slots or
        channels)."""
        par = self.parallel
        if par is not None:
            rows = par.rows(batch_size)
            batch_size = rows.stop - rows.start
        return T.init_cache(self.cfg, batch_size, max_len,
                            device=self.device, par=par)

    def prefill(self, batch: dict, max_len=None):
        """Returns (logits for the last position (B, 1, V), decode
        cache)."""
        n = next(iter(batch.values())).shape[0]
        h, positions, img = self._embed_inputs(self._rows(batch))
        h, cache = T.stack_prefill(self.stack, self.cfg, h, positions, img,
                                   max_len=max_len, par=self.parallel)
        return self._whole_logits(self._head(h[:, -1:]), n), cache

    def decode_step(self, cache: list, tokens: torch.Tensor, pos):
        """tokens: (B, 1) int; pos: (B,) absolute positions."""
        cfg = self.cfg
        par = self.parallel
        if not cfg.causal:
            raise ValueError(f"{cfg.name} is encoder-only (causal=False): "
                             f"it is scored (LM.score), not decoded")
        n = tokens.shape[0]
        if par is not None:
            rows = par.rows(n)
            tokens = tokens[rows]
            pos = torch.as_tensor(pos, device=tokens.device)[rows]  # torchlint: disable=TL002 (pos is a device tensor)
        emb = self.embed if par is None else par.view(self.embed)
        h = shard(L.embed(emb, tokens, cfg.compute_dtype, par),
                  ("batch", None, "embed"))
        h, cache = T.stack_decode(self.stack, cfg, h, pos, cache, par)
        return self._whole_logits(self._head(h), n), cache


def build_model(cfg, *, seed: int = 0, device=None) -> LM:
    """An ``LM`` on ``device`` (``None``: the CUDA card) with parameters
    drawn from ``torch.Generator(device).manual_seed(seed)``; one seed
    gives one model per device type (CPU and CUDA generators differ).
    On ``meta`` nothing is drawn: the parameters have shapes and dtypes
    only, and no generator is made."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return LM(cfg, device=dev)
    return LM(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
