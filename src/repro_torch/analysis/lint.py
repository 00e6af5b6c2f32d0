"""AST lint for the PyTorch pitfalls the port keeps out of its hot paths:
the counterpart of the reference's ``analysis/jaxlint.py``.

Two rules, each an invariant the port's chip runs taught (PERF.md §6)
and the ``meta`` dry-run now depends on:

``TL001`` **host sync on a hot path** — ``.item()``, ``.tolist()`` or
    ``.cpu()``, ``float()`` / ``int()`` / ``bool()`` of an expression
    that calls into ``torch``, or an ``if`` / ``while`` / conditional
    expression whose condition calls into ``torch``, inside a function
    whose name marks a step, forward, prefill, decode, loss, update,
    reduction, scan or kernel-wrapper path (``HOT_NAME``).  On the card
    each one waits for the device and copies to the host, so the host
    stops issuing work; on ``meta`` (the dry-run) there is no value to
    read and the trace fails.

``TL002`` **device tensor from a Python number on a hot path** —
    ``torch.tensor(...)``, ``torch.full(...)`` or ``torch.as_tensor(...)``
    with a ``device=`` argument, inside such a function or inside a
    loop.  ``torch.tensor`` and ``torch.as_tensor`` copy host memory to
    the device and stall the host (a per-call copy halved granite-3-2b's
    decode speed until removed); ``torch.full`` launches a fill each
    call, which a hot loop should hoist.

The reference's JX003 (jit static arguments) has no counterpart: the
port keys its runners on flow mode and burst bound by design.

Suppression: trailing ``# torchlint: disable=TL001`` (comma-separate for
several, bare ``disable`` for all) on the flagged line, which should say
why the sync is intended, or ``# torchlint: skip-file`` anywhere in the
file.

CLI::

    python -m repro_torch.analysis.lint src/repro_torch

exits 1 when any finding survives suppression.  Pure stdlib ``ast``:
nothing is imported or executed.
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

__all__ = ["LintFinding", "RULES", "HOT_NAME", "lint_source", "lint_paths",
           "main"]

RULES = {
    "TL001": "host sync (a device read) on a hot path",
    "TL002": "device tensor built from a Python number on a hot path",
}

#: function names that mark a hot path
HOT_NAME = re.compile(r"step|forward|prefill|decode|loss|update|reduce|"
                      r"scan|encode|attention|apply|launch")

_SYNC_METHODS = ("item", "tolist", "cpu")
_SYNC_CASTS = ("float", "int", "bool")
_FACTORIES = ("torch.tensor", "torch.full", "torch.as_tensor")

_PRAGMA = re.compile(r"#\s*torchlint:\s*disable(?:=([A-Z0-9,\s]+))?")
_SKIP_FILE = re.compile(r"#\s*torchlint:\s*skip-file")


@dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chains as a dotted string (None otherwise)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


#: calls into ``torch`` that read host-side state, not a device value
_HOST_STATE = re.compile(r"torch\.(is_|are_|get_|cuda\.)")


def _torch_call(node: ast.AST) -> ast.Call | None:
    """The first call into ``torch`` inside ``node`` that can return a
    device value, if any."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            d = _dotted(sub.func)
            if d is not None and d.startswith("torch.") and \
                    not _HOST_STATE.match(d):
                return sub
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list[LintFinding] = []
        self._hot: list[str] = []       # enclosing hot function names
        self._loops = 0

    def _add(self, node: ast.AST, rule: str, message: str):
        self.findings.append(LintFinding(
            self.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), rule, message))

    def _where(self) -> str:
        return f"in {self._hot[-1]}()"

    # ---- scopes -------------------------------------------------------

    def visit_FunctionDef(self, node):
        hot = HOT_NAME.search(node.name) is not None
        loops, self._loops = self._loops, 0
        if hot:
            self._hot.append(node.name)
        self.generic_visit(node)
        if hot:
            self._hot.pop()
        self._loops = loops

    visit_AsyncFunctionDef = visit_FunctionDef

    def _loop(self, node):
        self._loops += 1
        self.generic_visit(node)
        self._loops -= 1

    visit_For = visit_AsyncFor = _loop

    # ---- TL001: host syncs --------------------------------------------

    def _branch(self, node, test, kind: str):
        hit = _torch_call(test) if self._hot else None
        if hit is not None:
            self._add(node, "TL001",
                      f"{kind} condition calls {_dotted(hit.func)}(...) "
                      f"{self._where()}: branching on a device value "
                      f"syncs the host (keep the branch on the device, "
                      f"torch.where, or hoist it to set-up time)")

    def visit_If(self, node):
        self._branch(node, node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        self._branch(node, node.test, "while")
        self._loop(node)

    def visit_IfExp(self, node):
        self._branch(node, node.test, "conditional-expression")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        d = _dotted(node.func)
        if self._hot:
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS and not node.args:
                self._add(node, "TL001",
                          f".{node.func.attr}() {self._where()} reads a "
                          f"device value back to the host")
            elif d in _SYNC_CASTS and node.args and \
                    _torch_call(node.args[0]) is not None:
                self._add(node, "TL001",
                          f"{d}() of a torch expression {self._where()} "
                          f"reads a device value back to the host")
        if d in _FACTORIES and (self._hot or self._loops) and any(
                kw.arg == "device" for kw in node.keywords):
            where = self._where() if self._hot else "in a loop"
            self._add(node, "TL002",
                      f"{d}(..., device=...) {where} builds a device "
                      f"tensor from a Python value each call (a host copy "
                      f"or a fill launch): hoist it, or keep the value a "
                      f"Python scalar operand")
        self.generic_visit(node)


def _suppressed(finding: LintFinding, lines: list[str]) -> bool:
    if not 1 <= finding.line <= len(lines):
        return False
    m = _PRAGMA.search(lines[finding.line - 1])
    if m is None:
        return False
    if m.group(1) is None:
        return True  # bare "disable": all rules
    return finding.rule in {c.strip() for c in m.group(1).split(",")}


def lint_source(source: str, path: str = "<string>") -> list[LintFinding]:
    """Lint one source string; returns findings after pragma filtering."""
    if _SKIP_FILE.search(source):
        return []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as err:
        return [LintFinding(path, err.lineno or 0, err.offset or 0,
                            "TL000", f"syntax error: {err.msg}")]
    visitor = _Visitor(path)
    visitor.visit(tree)
    lines = source.splitlines()
    out = [f for f in visitor.findings if not _suppressed(f, lines)]
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_paths(paths: Iterable[str | Path]) -> list[LintFinding]:
    """Lint every ``*.py`` under the given files/directories."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings: list[LintFinding] = []
    for f in files:
        findings.extend(lint_source(f.read_text(encoding="utf-8"), str(f)))
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="PyTorch hot-path lint (TL001 host sync, TL002 device "
                    "tensor from a Python number)")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the summary line")
    args = ap.parse_args(argv)
    findings = lint_paths(args.paths)
    for f in findings:
        print(f)
    if not args.quiet:
        print(f"torchlint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
