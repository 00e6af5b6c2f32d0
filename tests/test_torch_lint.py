"""The port's hot-path lint (``repro_torch.analysis.lint``): each rule
fires on a seeded violation and is quiet on its fix, the pragmas and
``skip-file``, the CLI's exit codes, and the tree gate: no finding over
``src/repro_torch``."""

import pathlib

import pytest

from repro_torch.analysis import lint

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "TL001": [
        ("def decode_step(x):\n    return x.sum().item()\n",
         "def decode_step(x):\n    return x.sum()\n"),
        ("def train_step(x):\n    return float(torch.max(x))\n",
         "def train_step(x):\n    return torch.max(x)\n"),
        ("def forward(x):\n    if torch.any(x > 0):\n        x = -x\n"
         "    return x\n",
         "def forward(x):\n    return torch.where(x > 0, -x, x)\n"),
        ("def scan_launch(t):\n    return t.cpu()\n",
         "def scan_launch(t):\n    return t\n"),
    ],
    "TL002": [
        ("def decode_step(x, p):\n"
         "    return x + torch.tensor(p, device=x.device)\n",
         "def decode_step(x, p):\n    return x + p\n"),
        ("def build(xs, dev):\n    for x in xs:\n"
         "        x.add_(torch.full((1,), 2.0, device=dev))\n",
         "def build(xs, dev):\n    for x in xs:\n        x.add_(2.0)\n"),
    ],
}


@pytest.mark.parametrize("rule,bad,good", [
    (r, b, g) for r, cases in CASES.items() for b, g in cases])
def test_rule_fires_and_fix_is_quiet(rule, bad, good):
    got = lint.lint_source(bad)
    assert [f.rule for f in got] == [rule], got
    assert lint.lint_source(good) == []


def test_cold_paths_and_host_state_are_quiet():
    src = ("def setup(x, dev):\n    n = int(torch.sum(x))\n"
           "    t = torch.tensor(1.0, device=dev)\n    return n, t\n"
           "def apply(x):\n    if torch.is_grad_enabled():\n"
           "        return x\n    return x\n")
    assert lint.lint_source(src) == []


def test_pragmas_and_skip_file():
    bad = "def decode_step(x):\n    return x.item()"
    assert lint.lint_source(bad + "  # torchlint: disable=TL001 (why)\n") \
        == []
    assert lint.lint_source(bad + "  # torchlint: disable\n") == []
    assert [f.rule for f in lint.lint_source(
        bad + "  # torchlint: disable=TL002\n")] == ["TL001"]
    assert lint.lint_source("# torchlint: skip-file\n" + bad) == []
    assert lint.lint_source("def f(:\n")[0].rule == "TL000"


def test_cli_exit_codes(tmp_path, capsys):
    bad, good = tmp_path / "bad.py", tmp_path / "good.py"
    bad.write_text("def decode_step(x):\n    return x.item()\n")
    good.write_text("def decode_step(x):\n    return x\n")
    assert lint.main([str(good)]) == 0
    assert lint.main([str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "bad.py:2:11: TL001" in out and "1 finding(s)" in out


def test_port_tree_is_clean():
    """The gate: no finding over the port; every intended sync carries
    a pragma saying why."""
    findings = lint.lint_paths([ROOT / "src" / "repro_torch"])
    assert findings == [], "\n".join(map(str, findings))
