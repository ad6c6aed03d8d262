"""Atomic-write rules: RPR001 (supervisor-polled JSON must go through
``write_json_atomic``) and RPR005 (``CellQueue`` may never open a ticket
path with O_CREAT after the claim rename).

Counterpart of ``repro/analysis/rules/atomic_writes.py``, copied, scoped
to the port's ``launch/``, ``train/checkpoint.py`` and ``launch/scheduler.py``.

Both rules share the same exemption: the write-to-tmp-then-rename idiom.
A path expression that visibly mentions ``tmp`` (name, attribute, or
string constant anywhere in its subtree) is the *first half* of an atomic
write and is legal; the rename that publishes it is what readers see.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from repro_torch.analysis.rules import (Finding, Rule, dotted_name,
                                        enclosing_defs, subtree_mentions_tmp)

#: functions whose body IS the atomic-write implementation; their
#: internal .write_text is the sanctioned tmp write
_IMPL_FUNCS = {"write_json_atomic"}

#: classes that form the filesystem-primitive layer: their methods wrap
#: raw os calls by design and are the enforcement boundary, not a
#: violation site (LocalFS in scheduler.py, MemFS in the race explorer)
_FS_PRIMITIVE_CLASSES = {"LocalFS", "MemFS"}


def _contains_json_dumps(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and dotted_name(n.func) in (
                "json.dumps", "json.dump"):
            return True
    return False


def _contains_json_literal(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and n.value.endswith(".json"):
            return True
    return False


def _open_mode(call: ast.Call, mode_pos: int) -> Optional[str]:
    """The literal mode string of an open()-style call, if present."""
    if len(call.args) > mode_pos:
        arg = call.args[mode_pos]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


def _is_writing_mode(mode: Optional[str]) -> bool:
    return mode is not None and any(c in mode for c in "wax+")


class NonAtomicJsonWrite(Rule):
    """RPR001 — JSON artifacts in the campaign tree are polled by
    concurrent readers (the orchestrator tails ``progress.json``; resumed
    campaigns re-read reports and leaderboards), so every JSON write in
    ``repro_torch.launch`` and the checkpoint manifest must be tmp-write +
    atomic-rename (``repro_torch.launch.ioutil.write_json_atomic``),
    never an in-place ``write_text``/``json.dump``/``open('w')``."""

    id = "RPR001"
    title = "non-atomic JSON artifact write"
    contract = ("JSON artifacts under repro_torch.launch (and the checkpoint "
                "manifest) must be written via write_json_atomic, never "
                "in-place")

    def applies(self, f) -> bool:
        return (f.rel.startswith("src/repro_torch/launch/")
                or f.rel == "src/repro_torch/train/checkpoint.py")

    def check(self, f, project) -> Iterator[Finding]:
        scopes = enclosing_defs(f.tree)

        def exempt(node: ast.AST) -> bool:
            return any(s in _IMPL_FUNCS for s in scopes.get(node, ()))

        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            # json.dump(obj, fh) — the file handle came from a plain
            # open(); a reader can see the torn prefix
            if name == "json.dump":
                if not exempt(node):
                    yield self.finding(
                        f, node,
                        "json.dump() writes in place; build the payload "
                        "and call write_json_atomic() instead")
                continue
            if not isinstance(node.func, ast.Attribute):
                # builtin open(path, "w") with a *.json literal path
                if isinstance(node.func, ast.Name) \
                        and node.func.id == "open" and node.args \
                        and _is_writing_mode(_open_mode(node, 1)) \
                        and _contains_json_literal(node.args[0]) \
                        and not subtree_mentions_tmp(node.args[0]) \
                        and not exempt(node):
                    yield self.finding(
                        f, node,
                        "open(...'w') on a .json path writes in place; "
                        "use write_json_atomic()")
                continue
            recv = node.func.value
            if node.func.attr == "write_text" \
                    and any(_contains_json_dumps(a) for a in node.args) \
                    and not subtree_mentions_tmp(recv) \
                    and not exempt(node):
                yield self.finding(
                    f, node,
                    ".write_text(json.dumps(...)) is not atomic; a "
                    "concurrent reader can see a torn file — use "
                    "write_json_atomic()")
            elif node.func.attr == "open" \
                    and _is_writing_mode(_open_mode(node, 0)) \
                    and _contains_json_literal(recv) \
                    and not subtree_mentions_tmp(recv) \
                    and not exempt(node):
                yield self.finding(
                    f, node,
                    ".open('w') on a .json path writes in place; use "
                    "write_json_atomic()")


class CreatingWriteInQueue(Rule):
    """RPR005 — after ``CellQueue``'s claim rename, the loser of a race
    holds a path that no longer exists; any O_CREAT-capable write on its
    side would *resurrect* the ticket as a duplicate. Inside
    ``scheduler.py``, post-claim content writes must therefore be
    never-creating (``rewrite_nocreate``: O_WRONLY without O_CREAT);
    creating writes (``.write_text``, ``open('w')``, ``os.open`` with
    O_CREAT) are only legal on tmp-named paths that are subsequently
    renamed into place."""

    id = "RPR005"
    title = "O_CREAT-capable write in CellQueue"
    contract = ("scheduler.py may only create files at tmp paths; ticket "
                "content rewrites must be O_WRONLY-without-O_CREAT")

    def applies(self, f) -> bool:
        return f.rel == "src/repro_torch/launch/scheduler.py"

    def check(self, f, project) -> Iterator[Finding]:
        scopes = enclosing_defs(f.tree)

        def in_primitive_layer(node: ast.AST) -> bool:
            return any(s in _FS_PRIMITIVE_CLASSES
                       for s in scopes.get(node, ()))

        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name == "os.open":
                if any("O_CREAT" == getattr(n, "attr", None)
                       for arg in node.args for n in ast.walk(arg)) \
                        and not in_primitive_layer(node):
                    yield self.finding(
                        f, node,
                        "os.open with O_CREAT can resurrect a ticket the "
                        "claim rename already moved; use the fs seam's "
                        "rewrite_nocreate")
                continue
            if isinstance(node.func, ast.Name) and node.func.id == "open" \
                    and node.args and _is_writing_mode(_open_mode(node, 1)) \
                    and not subtree_mentions_tmp(node.args[0]) \
                    and not in_primitive_layer(node):
                yield self.finding(
                    f, node,
                    "creating open() in CellQueue outside a tmp path; "
                    "write to tmp + rename, or rewrite_nocreate")
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr == "write_text":
                # two call shapes: path.write_text(text) and the fs-seam
                # form fs.write_text(path, text) where the path is arg 0
                recv_name = dotted_name(node.func.value)
                path_expr: ast.AST = node.func.value
                if recv_name.split(".")[-1].endswith("fs") and node.args:
                    path_expr = node.args[0]
                if not subtree_mentions_tmp(path_expr) \
                        and not in_primitive_layer(node):
                    yield self.finding(
                        f, node,
                        "write_text in CellQueue creates files; only tmp "
                        "paths (later renamed) may be created")
            elif node.func.attr == "open" \
                    and _is_writing_mode(_open_mode(node, 0)) \
                    and not subtree_mentions_tmp(node.func.value) \
                    and not in_primitive_layer(node):
                yield self.finding(
                    f, node,
                    ".open('w') in CellQueue creates files; only tmp "
                    "paths (later renamed) may be created")


__all__: List[str] = ["NonAtomicJsonWrite", "CreatingWriteInQueue"]
