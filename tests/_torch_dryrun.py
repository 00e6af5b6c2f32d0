"""Shared by the dry-run parity tests (``test_torch_dryrun_parity*.py``):
the reference's ``lower_cell`` and ``hlo_cost.analyze`` on one smoke
architecture at small shapes, run once a module in a child process with
forced host devices, and the port's meta trace of the same cells.

The reference's ``make_production_mesh`` builds its mesh with
``jax.make_mesh`` and no axis types, which JAX 0.9 makes Explicit, and
every cell then raises ``ShardingTypeError`` (ROADMAP queue C).  The
snippet builds its (1, 1) and (2, 2) meshes through the reference's own
``repro.parallel.compat.make_mesh(..., axis_types=(AXIS_TYPE_AUTO,) *
2)``, as ``_torch_dp`` does; the small shapes are added to the child's
copy of the reference's shape table.  Nothing of the reference is
edited.

Imported as ``_torch_dryrun`` (the tests directory is on the path).
"""

from __future__ import annotations

import dataclasses
import functools
import json

from tests._subproc import run_with_devices

#: small cells of each kind: (name, seq_len, global_batch, kind)
SHAPES = (("train_s", 64, 8, "train"), ("prefill_s", 128, 4, "prefill"),
          ("decode_s", 128, 8, "decode"))
#: the meshes each cell is lowered on
MESHES = {"1x1": (1, 1), "2x2": (2, 2)}
#: cells also lowered with sequence parallelism
#: (``RunConfig(seq_parallel=True)``), by architecture: ``(shape, mesh)``
SP_CELLS = {"granite_3_2b": (("train_s", "2x2"),)}

REF = r"""
import dataclasses, json, sys
import repro.launch.dryrun as D     # forces 512 host devices
from repro.configs import base as B
from repro.configs.base import RunConfig, get_config, get_smoke_config
from repro.launch import hlo_cost
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh

arch, SHAPES, MESHES, SP = {arch!r}, {shapes!r}, {meshes!r}, {sp!r}
smoke = get_smoke_config(arch)
over = {{f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}}
new = [B.ShapeConfig(*s) for s in SHAPES]
for s in new:
    B.ALL_SHAPES[s.name] = s
    D.ALL_SHAPES[s.name] = s
D.shapes_for = lambda cfg, _f=B.shapes_for: _f(cfg) + new
out = {{}}
cells = [(s.name, mname, False) for mname in MESHES for s in new] + \
    [(s, mname, True) for s, mname in SP]
for sname, mname, sp in cells:
    mesh = make_mesh(tuple(MESHES[mname]), ("data", "model"),
                     axis_types=(AXIS_TYPE_AUTO,) * 2)
    lowered, meta = D.lower_cell(arch, sname, mesh,
                                 RunConfig(seq_parallel=sp), over)
    compiled = lowered.compile()
    cost = hlo_cost.analyze(compiled.as_text())
    mem = compiled.memory_analysis()
    out[f"{{sname}}/{{mname}}" + ("/sp" if sp else "")] = {{
        "flops": cost["flops"], "bytes_accessed": cost["bytes_accessed"],
        "collectives": cost["collectives"],
        "argument_size_in_bytes": mem.argument_size_in_bytes}}
print("REF-JSON" + json.dumps(out))
"""


@functools.cache
def reference(arch: str) -> dict:
    """The reference's numbers a cell, ``"<shape>/<mesh>"`` (and
    ``"<shape>/<mesh>/sp"`` for the ``SP_CELLS`` of ``arch``)."""
    code = REF.format(arch=arch, shapes=SHAPES,
                      meshes={k: list(v) for k, v in MESHES.items()},
                      sp=list(SP_CELLS.get(arch, ())))
    out = run_with_devices(code, n_devices=512, timeout=600)
    line = [ln for ln in out.splitlines() if ln.startswith("REF-JSON")][-1]
    return json.loads(line[len("REF-JSON"):])


def port(arch: str, shape: str, mesh: str, run_cfg=None) -> tuple:
    """The port's ``(cost result, meta, memory)`` of the same cell,
    traced on ``meta``."""
    from repro_torch.configs import base as B
    from repro_torch.launch import dryrun
    from repro_torch.parallel.compat import Mesh
    smoke = B.get_smoke_config(arch)
    over = {f.name: getattr(smoke, f.name)
            for f in dataclasses.fields(smoke)}
    spec = {s[0]: B.ShapeConfig(*s) for s in SHAPES}[shape]
    rows, cols = MESHES[mesh]
    return dryrun.trace_cell(arch, spec, Mesh({"data": rows, "model": cols}),
                             run_cfg or B.RunConfig(), over)


#: per-device flops on the 2 x 2 mesh are held to this relative
#: tolerance (ROADMAP queue C): the counter gives a result the union of
#: its operands' mesh axes, where XLA's partitioner may replicate a
#: small product (the MoE router after a decode step's attention,
#: 0.2 % of the smoke MoE cells)
DEVICE_TOL = 0.01


def _shape(name: str):
    return {s[0]: s for s in SHAPES}[name]


def known_gap(cfg, shape: str, mesh: str) -> float:
    """The reference's flops minus the port's on a cell, from its known
    causes (ROADMAP queue C), by hand:

    * prefill, 2 x 2: the reference's ``stack_prefill`` projects each
      self-attention layer's k and v a second time for its cache; XLA
      merges the copies on one device but not under the 2 x 2 sharding
      (2 products of 2·B·S·D·K·dh a layer, divided over the 4 devices);
    * every Mamba layer: the reference's causal conv is a
      ``conv_general_dilated`` (2·B·S·d_in·k a pass) and its scan's
      ``y = h·C`` an einsum, a dot of 2·B·S·d_in·N a pass, where the port
      runs shifted elementwise products and B7; in training both run in
      the forward, the recompute and the backward (the conv's input
      gradient over the padded S + k - 1 positions), and the conv's
      weight gradient is a convolution with ``batch_group_count`` =
      d_in, which ``hlo_cost``'s rule (2 x output x kernel elements /
      feature groups) counts as 2·(k·d_in²)·(B·S·d_in), d_in and B the
      device's share."""
    _, S, B, kind = _shape(shape)
    tp = dp = MESHES[mesh][0]
    dev = dp * tp
    from repro_torch.models.transformer import _kinds
    kinds = _kinds(cfg)
    n_attn = sum(k.startswith("attn") for k in kinds)
    n_mamba = sum(k.startswith("mamba") for k in kinds)
    gap = 0.0
    if kind == "prefill" and dev > 1:
        gap += n_attn * 2 * (2 * B * S * cfg.d_model * cfg.n_kv_heads
                             * cfg.d_head) / dev
    if n_mamba:
        d, N, k = (cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state,
                   cfg.mamba.d_conv)
        if kind == "train":
            per = (2 * (2 * B * S * d * k) + 2 * B * (S + k - 1) * d * k
                   + 3 * (2 * B * S * d * N)) / dev
            per += 2 * (k * (d // tp) ** 2) * ((B // dp) * S * (d // tp))
        elif kind == "prefill":
            per = (2 * B * S * d * k + 2 * B * S * d * N) / dev
        else:
            per = (2 * B * d * k + 2 * B * d * N) / dev
        gap += n_mamba * per
    return gap
