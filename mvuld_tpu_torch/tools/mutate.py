"""Semantic-preserving C code mutations — the TXL-augmentation equivalent.

The reference augments training data with 14 semantic-preserving mutations
via the external TXL engine (reference: baselines/scripts/transform.py:19-104).
TXL is unavailable here; this module implements a self-contained subset of
the classic transformations in pure Python over the framework's lexer:

  * rename-identifiers      — consistent alpha-renaming of local identifiers
  * compound-assign         — ``x = x + e`` ⇄ ``x += e``
  * add-braces              — single-statement if/else/loop bodies get braces
  * swap-commutative        — ``a + b`` / ``a * b`` operand swap (literals)
  * incr-rewrite            — ``i++`` ⇄ ``i += 1``

Each mutation preserves program semantics, so labels carry over — the same
contract the reference's TXL pipeline relies on.

A copy of ``mvuld_tpu/tools/mutate.py`` (the port imports nothing of the JAX
package); pandas is imported only in ``augment_dataframe``.
"""

from __future__ import annotations

import random
import re
from typing import Callable, Dict, List

from mvuld_tpu_torch.tools.cpg import C_KEYWORDS, TYPE_KEYWORDS

_IDENT_RE = re.compile(r"\b[A-Za-z_][A-Za-z0-9_]*\b")


def _local_identifiers(code: str) -> List[str]:
    """Identifiers that are not keywords/types/known calls — safe to rename."""
    seen = []
    calls = set(re.findall(r"\b([A-Za-z_][A-Za-z0-9_]*)\s*\(", code))
    for m in _IDENT_RE.finditer(code):
        t = m.group()
        if (t in C_KEYWORDS or t in TYPE_KEYWORDS or t in calls
                or t in seen):
            continue
        seen.append(t)
    return seen


def rename_identifiers(code: str, rng: random.Random) -> str:
    idents = _local_identifiers(code)
    if not idents:
        return code
    mapping: Dict[str, str] = {}
    for i, ident in enumerate(idents):
        if rng.random() < 0.7:
            mapping[ident] = f"v{i}_{rng.randrange(100)}"

    def sub(m):
        return mapping.get(m.group(), m.group())

    return _IDENT_RE.sub(sub, code)


_COMPOUND_RE = re.compile(
    r"\b([A-Za-z_][A-Za-z0-9_]*)\s*=\s*\1\s*([+\-*/|&^])\s*([^;=]+);")


def to_compound_assign(code: str, rng: random.Random) -> str:
    return _COMPOUND_RE.sub(lambda m: f"{m.group(1)} {m.group(2)}= {m.group(3).strip()};",
                            code)


_FROM_COMPOUND_RE = re.compile(
    r"\b([A-Za-z_][A-Za-z0-9_]*)\s*([+\-*/|&^])=\s*([^;=]+);")


def from_compound_assign(code: str, rng: random.Random) -> str:
    return _FROM_COMPOUND_RE.sub(
        lambda m: f"{m.group(1)} = {m.group(1)} {m.group(2)} {m.group(3).strip()};",
        code)


_INCR_RE = re.compile(r"\b([A-Za-z_][A-Za-z0-9_]*)\+\+")


def incr_rewrite(code: str, rng: random.Random) -> str:
    # only statement-position increments (followed by ';' or ')')
    def sub(m):
        return f"{m.group(1)} += 1" if code[m.end():m.end() + 1] == ";" else m.group()
    return _INCR_RE.sub(sub, code)


def add_braces(code: str, rng: random.Random) -> str:
    """Wrap single-statement if/while/for bodies in braces (line-based)."""
    lines = code.split("\n")
    out = []
    i = 0
    hdr = re.compile(r"^\s*(if|while|for)\s*\(.*\)\s*$")
    while i < len(lines):
        line = lines[i]
        if hdr.match(line) and i + 1 < len(lines):
            body = lines[i + 1]
            if (body.strip() and not body.strip().startswith("{")
                    and body.strip().endswith(";")):
                indent = line[: len(line) - len(line.lstrip())]
                out.append(line + " {")
                out.append(body)
                out.append(indent + "}")
                i += 2
                continue
        out.append(line)
        i += 1
    return "\n".join(out)


_FOR_RE = re.compile(
    r"for\s*\(\s*([^;()]*);\s*([^;()]*);\s*([^;()]*)\)\s*\{")


def for_to_while(code: str, rng: random.Random) -> str:
    """``for (init; cond; step) { body }`` → ``init; while (cond) { body
    step; }`` — only braced, side-effect-local loops are rewritten."""
    lines = code.split("\n")
    out = []
    depth_stack = []
    for line in lines:
        m = _FOR_RE.search(line)
        # only non-nested loops (one active rewrite at a time)
        if m and line.strip().endswith("{") and not depth_stack:
            init, cond, step = (s.strip() for s in m.groups())
            indent = line[: len(line) - len(line.lstrip())]
            if init:
                out.append(indent + init + ";")
            out.append(indent + f"while ({cond or '1'}) {{")
            depth_stack.append((1, indent, step))
            continue
        if depth_stack:
            d, indent, step = depth_stack[-1]
            d += line.count("{") - line.count("}")
            if d <= 0:
                if step:
                    out.append(indent + "    " + step + ";")
                depth_stack.pop()
            else:
                depth_stack[-1] = (d, indent, step)
        out.append(line)
    return "\n".join(out)


_WHILE_RE = re.compile(r"\bwhile\s*\(")


def while_to_for(code: str, rng: random.Random) -> str:
    """``while (cond)`` → ``for (; cond ;)`` (exactly equivalent)."""
    out, i = [], 0
    for m in _WHILE_RE.finditer(code):
        start = m.end()               # after '('
        depth, j = 1, start
        while j < len(code) and depth:
            depth += {"(": 1, ")": -1}.get(code[j], 0)
            j += 1
        cond = code[start:j - 1]
        out.append(code[i:m.start()] + f"for (; {cond.strip()} ;)")
        i = j
    out.append(code[i:])
    return "".join(out)


_TERNARY_RE = re.compile(
    r"^(\s*)([A-Za-z_][A-Za-z0-9_\[\]\.\->]*)\s*=\s*([^?;]+)\?\s*([^:;]+):\s*([^;]+);\s*$")


def ternary_to_if(code: str, rng: random.Random) -> str:
    """``x = c ? a : b;`` → ``if (c) { x = a; } else { x = b; }``"""
    out = []
    for line in code.split("\n"):
        m = _TERNARY_RE.match(line)
        if m:
            ind, lhs, c, a, b = (g if i == 0 else g.strip()
                                 for i, g in enumerate(m.groups()))
            out.append(f"{ind}if ({c}) {{ {lhs} = {a}; }} "
                       f"else {{ {lhs} = {b}; }}")
        else:
            out.append(line)
    return "\n".join(out)


_DECL_RE = re.compile(
    r"^(\s*)(int|long|short|char|float|double|unsigned|size_t|uint32_t|"
    r"int32_t|uint64_t|int64_t|uint8_t|int8_t)\s+"
    r"([A-Za-z_][A-Za-z0-9_]*)\s*=\s*([^;,]+);\s*$")


def split_declaration(code: str, rng: random.Random) -> str:
    """``int x = e;`` → ``int x; x = e;`` (single declarator only)."""
    out = []
    for line in code.split("\n"):
        m = _DECL_RE.match(line)
        if m:
            ind, ty, name, expr = m.groups()
            out.append(f"{ind}{ty} {name}; {name} = {expr.strip()};")
        else:
            out.append(line)
    return "\n".join(out)


_IF_COND_RE = re.compile(r"\bif\s*\(")


def _extract_paren(code: str, start: int):
    depth, j = 1, start
    while j < len(code) and depth:
        depth += {"(": 1, ")": -1}.get(code[j], 0)
        j += 1
    return code[start:j - 1], j


def explicit_compare(code: str, rng: random.Random) -> str:
    """``if (x)`` → ``if ((x) != 0)`` when the condition has no comparison
    or logical operator (valid for integers and pointers alike)."""
    out, i = [], 0
    for m in _IF_COND_RE.finditer(code):
        if m.start() < i:
            continue
        cond, j = _extract_paren(code, m.end())
        if re.search(r"[<>!=&|]|\bcall\b", cond) is None and cond.strip():
            out.append(code[i:m.start()] + f"if (({cond.strip()}) != 0)")
            i = j
    out.append(code[i:])
    return "".join(out)


_REL_RE = re.compile(
    r"\b([A-Za-z_][A-Za-z0-9_]*|\d+)\s*(<=|>=|<|>)\s*([A-Za-z_][A-Za-z0-9_]*|\d+)\b")
_REL_FLIP = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}


def flip_relational(code: str, rng: random.Random) -> str:
    """``a < b`` → ``b > a`` for simple identifier/literal operands."""
    return _REL_RE.sub(
        lambda m: f"{m.group(3)} {_REL_FLIP[m.group(2)]} {m.group(1)}", code)


def dead_var_insert(code: str, rng: random.Random) -> str:
    """Insert an unused local after the function's opening brace."""
    i = code.find("{")
    if i < 0:
        return code
    return (code[: i + 1] + f"\n    int __rm_unused_{rng.randrange(100)} = 0;"
            + code[i + 1:])


def paren_condition(code: str, rng: random.Random) -> str:
    """``while (c)`` → ``while ((c))`` — redundant parentheses."""
    out, i = [], 0
    for m in _WHILE_RE.finditer(code):
        cond, j = _extract_paren(code, m.end())
        out.append(code[i:m.start()] + f"while (({cond.strip()}))")
        i = j
    out.append(code[i:])
    return "".join(out)


def _match_brace(code: str, open_idx: int) -> int:
    """Index one past the '}' matching the '{' at ``open_idx``."""
    depth, k = 1, open_idx + 1
    while k < len(code) and depth:
        depth += {"{": 1, "}": -1}.get(code[k], 0)
        k += 1
    return k


def swap_if_else(code: str, rng: random.Random) -> str:
    """``if (c) { A } else { B }`` → ``if (!(c)) { B } else { A }`` —
    both branches must be braced and on recognizable boundaries."""
    pat = re.compile(r"\bif\s*\(")
    out, i = [], 0
    while True:
        m = pat.search(code, i)
        if not m:
            break
        cond, j = _extract_paren(code, m.end())
        brace_m = re.match(r"\s*\{", code[j:])
        if not brace_m:
            out.append(code[i:j])
            i = j
            continue
        a_open = j + brace_m.end() - 1
        a_close = _match_brace(code, a_open)
        body_a = code[a_open + 1:a_close - 1]
        else_m = re.match(r"\s*else\s*\{", code[a_close:])
        if not else_m:
            out.append(code[i:j])
            i = j
            continue
        b_open = a_close + else_m.end() - 1
        b_close = _match_brace(code, b_open)
        body_b = code[b_open + 1:b_close - 1]
        out.append(code[i:m.start()]
                   + f"if (!({cond.strip()})) {{{body_b}}} else {{{body_a}}}")
        i = b_close
    out.append(code[i:])
    return "".join(out)


# the reference's TXL suite exposes 14 semantic-preserving transformations
# (mutation.sh actions 0-13, transform.py:26); action 0 is the identity.
# This registry provides 14 self-contained equivalents.
MUTATIONS: Dict[str, Callable[[str, random.Random], str]] = {
    "rename_identifiers": rename_identifiers,
    "to_compound_assign": to_compound_assign,
    "from_compound_assign": from_compound_assign,
    "incr_rewrite": incr_rewrite,
    "add_braces": add_braces,
    "for_to_while": for_to_while,
    "while_to_for": while_to_for,
    "ternary_to_if": ternary_to_if,
    "split_declaration": split_declaration,
    "explicit_compare": explicit_compare,
    "flip_relational": flip_relational,
    "dead_var_insert": dead_var_insert,
    "paren_condition": paren_condition,
    "swap_if_else": swap_if_else,
}


def mutate(code: str, seed: int = 0, ops: List[str] | None = None) -> str:
    rng = random.Random(seed)
    for name in (ops or list(MUTATIONS)):
        if rng.random() < 0.6:
            code = MUTATIONS[name](code, rng)
    return code


def augment_dataframe(df, seed: int = 0, id_offset: int = 190000):
    """Add mutated twins of every row (the reference adds patched variants
    with _id+190000, process_dataset.py mix_patch:111-130 — same id scheme)."""
    import pandas as pd
    rows = []
    for _, row in df.iterrows():
        rows.append({"_id": int(row._id) + id_offset,
                     "func_before": mutate(row.func_before, seed + int(row._id)),
                     "vul": row.vul,
                     **({"label": row.label} if "label" in row else {})})
    return pd.concat([df, pd.DataFrame(rows)], ignore_index=True)
