"""Roofline over the dry-run's records, on the H100's data-sheet figures:
the LM half of the reference's ``benchmarks/roofline.py``.

Reads ``experiments/dryrun_torch/<arch>--<shape>--<mesh>[--tag].json``
(``launch.dryrun``; per-device numbers) and derives, a cell:

  compute term    = flops a device / PEAK_FLOPS
  memory term     = bytes a device / HBM_BW
  collective term = the sum, over the mesh axes a device's collectives
                    span (``collectives_by_axis``), of their bytes over
                    the rate of that axis's group: LINK_BW when the
                    group's global ranks lie in one host of
                    HOST_CARDS cards (ranks row-major, 8 a host), else
                    HOST_BW

plus MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) and the useful
share of the counted flops.  The dry-run traces every collective a
rank issues, so each term is the rank's own.  A record without
``collectives_by_axis`` (a one-device cell, which has none) prices its
collective bytes at LINK_BW.

The constants are NVIDIA H100 80GB HBM3 SXM data-sheet figures (dense,
at the 700 W limit), none measured here and none a TPU's:

  PEAK_FLOPS  989e12 FLOP/s, bf16 on the tensor cores;
  HBM_BW      3.35e12 B/s;
  LINK_BW     450e9 B/s, one direction of NVLink 4 (900 GB/s both
              ways), between the 8 cards of one NVLink-switched host;
  HOST_BW     50e9 B/s, a 400 Gb/s NIC a card, between hosts (on the
              16 x 16 pod both of a rank's groups span hosts).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs.base import ALL_SHAPES, get_config
from ..device import H100
from ..models.layers import padded_vocab
from ..models.transformer import pattern_for
from .dryrun import OUT_DIR

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "HOST_BW", "HOST_CARDS",
           "DRYRUN_DIR", "link_rate", "analyze_cell", "load_cells", "table",
           "_active_params", "_ssm_state_flops_per_token"]

PEAK_FLOPS = H100["bf16_flops_s"]  # bf16 / card (data sheet)
HBM_BW = H100["hbm_bytes_s"]       # B/s (data sheet)
LINK_BW = 450e9                    # B/s a direction: NVLink 4 (data sheet)
HOST_BW = 50e9                     # B/s a card: a 400 Gb/s NIC (data sheet)
HOST_CARDS = 8                     # cards a host, NVLink-switched

DRYRUN_DIR = OUT_DIR


def _active_params(arch: str) -> float:
    """Parameters a token passes through (N for MODEL_FLOPS): the
    reference's count, the top-k experts of an MoE layer only."""
    cfg = get_config(arch)
    D, L, V = cfg.d_model, cfg.n_layers, padded_vocab(cfg.vocab)
    H, Kv, dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff

    def attn_p():
        return D * H * dh + 2 * D * Kv * dh + H * dh * D

    def ffn_p():
        gated = cfg.act in ("silu", "gelu") and cfg.family != "encoder"
        return (3 if gated else 2) * D * F

    def moe_active():
        m = cfg.moe
        return m.top_k * 3 * D * F + D * m.num_experts

    def mamba_p():
        m = cfg.mamba
        d_in = m.expand * D
        R = cfg.dt_rank
        return (D * 2 * d_in + m.d_conv * d_in + d_in * (R + 2 * m.d_state)
                + R * d_in + d_in * D)

    pat = pattern_for(cfg)
    per_period = 0.0
    for kind in pat:
        if kind.startswith("attn") or kind.startswith("xattn"):
            per_period += attn_p()
        else:
            per_period += mamba_p()
        if kind.endswith("_ffn"):
            per_period += ffn_p()
        elif kind.endswith("_moe"):
            per_period += moe_active()
    body = per_period * (L // len(pat))
    embed = V * D + (0 if cfg.tie_embeddings else D * V)
    return body + embed


def _ssm_state_flops_per_token(arch: str) -> float:
    """The selective scan's state arithmetic that 6·N·D does not count:
    ~9 multiply-adds per (d_inner x d_state) element a token a Mamba
    layer (discretise, recurrence, output contraction), x3 for the
    forward, the backward and the recompute."""
    cfg = get_config(arch)
    if cfg.mamba is None:
        return 0.0
    pat = pattern_for(cfg)
    n_mamba = sum(1 for k in pat if k.startswith("mamba")) * (
        cfg.n_layers // len(pat))
    d_in = cfg.mamba.expand * cfg.d_model
    return 9.0 * 3.0 * n_mamba * d_in * cfg.mamba.d_state


def link_rate(ranks) -> float:
    """B/s of a collective over the global ``ranks``: LINK_BW within
    one host, HOST_BW across hosts."""
    return LINK_BW if len({r // HOST_CARDS for r in ranks}) <= 1 \
        else HOST_BW


def analyze_cell(rec: dict) -> dict:
    """The record with its three terms, the dominant one, the bound time
    and the compute share of it; for a train cell, MODEL_FLOPS and the
    useful share of the counted flops (with the scan's state arithmetic
    added for SSMs).  A record that says its collectives are incomplete
    (a dry-run older than the rank's trace) is refused."""
    if "collectives_incomplete" in rec:
        raise ValueError(f"{rec['arch']}--{rec['shape']}: a record without "
                         f"the model axis's and FSDP's collectives; trace "
                         f"the cell again (launch.dryrun)")
    n_dev = rec["n_devices"]
    flops_dev = rec["flops"]
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = rec["bytes_accessed"] / HBM_BW
    by_axis = rec.get("collectives_by_axis")
    if by_axis is None:
        t_coll = rec.get("collective_bytes_total", 0.0) / LINK_BW
    else:
        t_coll = sum(a["bytes"] / link_rate(a["ranks"] or ())
                     for a in by_axis.values())
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    out = dict(rec)
    out.update({
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "bound_time_s": bound,
        "roofline_fraction": t_compute / bound if bound > 0 else 0.0,
    })
    if rec["kind"] == "train":
        sh = ALL_SHAPES[rec["shape"]]
        tokens = sh.global_batch * sh.seq_len
        model_flops = 6.0 * _active_params(rec["arch"]) * tokens
        counted = max(flops_dev * n_dev, 1.0)
        out["model_flops_global"] = model_flops
        out["useful_ratio"] = model_flops / counted
        ssm = _ssm_state_flops_per_token(rec["arch"])
        if ssm:
            out["useful_ratio_ssm_adjusted"] = \
                (model_flops + ssm * tokens) / counted
    return out


def load_cells(mesh="pod", tag=None, dryrun_dir=DRYRUN_DIR) -> list:
    """Every record of ``mesh`` (and ``tag``) in ``dryrun_dir``,
    analysed."""
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        if path.endswith(".ops.json"):
            continue
        with open(path) as f:
            rec = json.load(f)
        if rec.get("mesh_kind") != mesh:
            continue
        base = os.path.basename(path)[:-5].split("--")
        if (tag or "") != (base[3] if len(base) > 3 else ""):
            continue
        cells.append(analyze_cell(rec))
    return cells


def table(cells) -> str:
    """A markdown table a cell."""
    hdr = ["arch", "shape", "dominant", "t_comp(ms)", "t_mem(ms)",
           "t_coll(ms)", "roofline", "useful"]
    lines = ["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr)]
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"])):
        coll = f"{c['t_collective_s'] * 1e3:.2f}"
        lines.append("| " + " | ".join([
            c["arch"], c["shape"], c["dominant"],
            f"{c['t_compute_s'] * 1e3:.2f}", f"{c['t_memory_s'] * 1e3:.2f}",
            coll, f"{c['roofline_fraction']:.2f}",
            f"{c['useful_ratio']:.2f}" if "useful_ratio" in c else "-",
        ]) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.roofline")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--tag", default=None)
    ap.add_argument("--dir", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    print(table(load_cells(args.mesh, args.tag, args.dir)))


if __name__ == "__main__":
    main()
