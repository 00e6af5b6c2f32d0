"""``chip_smoke.py``'s serving cells name the configurations they claim:
each ``LM_CELLS`` argv parses through ``serve._parser`` and
``serve.setup``'s config step to the published widths of its
architecture, at the depth its ``reduced`` entry states (every layer
where it states none), at 4 x 2048 prompts and 32 generated tokens.
The models are built on ``meta``, so nothing is drawn or allocated."""

import importlib.util
import pathlib

import pytest

from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.models.model import build_model, param_count

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CELLS = {c[0]: c for c in CS.LM_CELLS}

#: (d_model, heads, kv heads, d_head, d_ff, vocab, layers served, float32
#: parameters served) of the minitron, qwen3 and moonshot cells
NEW = {"serve_minitron_8b": (4096, 32, 8, 128, 16384, 256000, 32,
                             7_734_562_816),
       "serve_qwen3_14b": (5120, 40, 8, 128, 17408, 151936, 40,
                           14_768_307_200),
       "serve_moonshot_v1_16b_a3b_l16": (2048, 16, 16, 128, 1408, 163840,
                                         16, 9_800_058_880)}


def _served_cfg(argv):
    """The config ``serve.setup`` builds from ``argv``."""
    args = serve._parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    return args, cfg


@pytest.mark.parametrize("label", sorted(NEW))
def test_new_cells_parse_to_their_published_widths(label):
    _, argv, reduced, scans, xgate, _, rows, keep = CELLS[label]
    args, cfg = _served_cfg(argv)
    d, h, k, dh, ff, vocab, layers, params = NEW[label]
    full = get_config(args.arch)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
            cfg.vocab) == (d, h, k, dh, ff, vocab) == (
        full.d_model, full.n_heads, full.n_kv_heads, full.d_head, full.d_ff,
        full.vocab)
    assert cfg.n_layers == layers
    if reduced is None:
        assert layers == full.n_layers
    else:
        assert reduced == {"n_layers": [full.n_layers, layers]}
    assert (args.batch, args.prompt_len, args.gen, args.seed) == (4, 2048,
                                                                  32, 0)
    assert not args.smoke and args.device is None
    assert (scans, xgate, rows, keep) == (0, None, 1, None)
    assert param_count(build_model(cfg, device="meta")) == params


def test_new_cells_exercise_their_paths():
    """minitron's squared ReLU and untied head, qwen3's qk-norm,
    moonshot's 64 experts top-6; moonshot's first MoE layer is also
    run on the host."""
    _, m = _served_cfg(CELLS["serve_minitron_8b"][1])
    _, q = _served_cfg(CELLS["serve_qwen3_14b"][1])
    _, s = _served_cfg(CELLS["serve_moonshot_v1_16b_a3b_l16"][1])
    assert m.act == "relu2" and not m.tie_embeddings and m.moe is None
    assert q.qk_norm and q.moe is None
    assert (s.moe.num_experts, s.moe.top_k) == (64, 6)
    assert CS.DISPATCH_VS_HOST == ("serve_moonshot_v1_16b_a3b_l16",)
