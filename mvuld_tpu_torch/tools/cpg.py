"""Self-contained line-level code-property-graph extractor for C functions.

The reference shells out to Joern (JVM) to build a CPG, then collapses it to
ONE NODE PER SOURCE LINE via ``ne_groupnodes`` (longest-code node per line,
reference: mvuld/data/data_list.py:319-339) with AST/CFG/CDG/REACHING_DEF
edges between lines (reference: mvuld/sastvd/helpers/joern.py get_node_edges:
252-354, rdg:455-489). Joern is not available in this environment, so this
module computes the same line-level graph directly from source:

  * a comment/string-aware tokenizer,
  * a recursive-descent statement parser (if/else/for/while/do/switch/case/
    goto/labels/blocks),
  * structural AST edges (block containment),
  * a classical control-flow graph (branches, loop back-edges, break/
    continue/goto/return),
  * control-dependence edges (nearest enclosing predicate — exact for
    structured code),
  * reaching-definition edges via worklist dataflow over the CFG.

Node types use the reference's 32-label vocabulary with the same precedence
the per-line collapse induces (assignment node code ⊇ call code ⊇ operand
code, so Assignment ≻ Call ≻ Comparison ≻ ...; reference: joern.py
type_2_type:605-666 + ne_groupnodes longest-code rule).

For users who DO have Joern output JSON, ``mvuld_tpu/tools/joern_json.py``
parses it into the identical (nodes, edges) format.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from mvuld_tpu_torch.tools.vocab import GRAPH_TYPE_EDGES, SENSITIVE_APIS

# --------------------------------------------------------------------------- #
# lexing
# --------------------------------------------------------------------------- #

C_KEYWORDS = {
    "auto", "break", "case", "char", "const", "continue", "default", "do",
    "double", "else", "enum", "extern", "float", "for", "goto", "if", "inline",
    "int", "long", "register", "restrict", "return", "short", "signed",
    "sizeof", "static", "struct", "switch", "typedef", "union", "unsigned",
    "void", "volatile", "while", "bool", "true", "false", "NULL", "nullptr",
}

TYPE_KEYWORDS = {
    "void", "char", "short", "int", "long", "float", "double", "signed",
    "unsigned", "bool", "struct", "union", "enum", "const", "static",
    "register", "volatile", "auto", "extern", "inline", "size_t", "ssize_t",
    "wchar_t", "int8_t", "int16_t", "int32_t", "int64_t", "uint8_t",
    "uint16_t", "uint32_t", "uint64_t", "intptr_t", "uintptr_t", "ptrdiff_t",
    "FILE", "DIR", "time_t", "off_t", "pid_t", "uid_t", "gid_t", "DWORD",
    "WORD", "BYTE", "BOOL", "HANDLE", "LPSTR", "LPCSTR", "UINT", "ULONG",
}


@dataclasses.dataclass
class Tok:
    kind: str   # id | num | str | chr | op | punc
    text: str
    line: int


_TOKEN_RE = re.compile(
    r"""
    (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<num>0[xX][0-9a-fA-F]+|\d+\.\d*(?:[eE][+-]?\d+)?[fFlL]*|\.\d+|\d+[uUlL]*)
  | (?P<op><<=|>>=|\.\.\.|->|\+\+|--|<<|>>|<=|>=|==|!=|&&|\|\||[+\-*/%&|^!<>=]=?|[~?:.,])
  | (?P<punc>[;{}()\[\]])
    """,
    re.VERBOSE,
)


def clean_code(code: str) -> List[str]:
    """Strip comments and blank string/char literal bodies, preserving line
    numbers (reference behavior: comments removed upstream in the cleaning
    step, baselines/utils/utils.py:30-58)."""
    out: List[str] = []
    i, n = 0, len(code)
    state = "code"  # code | line_comment | block_comment | string | char
    buf: List[str] = []
    while i < n:
        ch = code[i]
        nxt = code[i + 1] if i + 1 < n else ""
        if state == "code":
            if ch == "/" and nxt == "/":
                state = "line_comment"; i += 2; continue
            if ch == "/" and nxt == "*":
                state = "block_comment"; i += 2; continue
            if ch == '"':
                state = "string"; buf.append('""'[0]); i += 1; continue
            if ch == "'":
                state = "char"; buf.append("'"); i += 1; continue
            buf.append(ch); i += 1
        elif state == "line_comment":
            if ch == "\n":
                state = "code"; buf.append(ch)
            i += 1
        elif state == "block_comment":
            if ch == "*" and nxt == "/":
                state = "code"; i += 2; continue
            if ch == "\n":
                buf.append("\n")
            i += 1
        elif state == "string":
            if ch == "\\":
                i += 2; continue
            if ch == '"':
                buf.append('"'); state = "code"
            elif ch == "\n":   # unterminated; bail to code
                buf.append("\n"); state = "code"
            i += 1
        elif state == "char":
            if ch == "\\":
                i += 2; continue
            if ch == "'":
                buf.append("'"); state = "code"
            elif ch == "\n":
                buf.append("\n"); state = "code"
            i += 1
    return "".join(buf).split("\n")


def tokenize(lines: Sequence[str]) -> List[Tok]:
    toks: List[Tok] = []
    for ln, line in enumerate(lines, start=1):
        if line.lstrip().startswith("#"):
            continue  # preprocessor directives carry no CPG statement
        for m in _TOKEN_RE.finditer(line):
            kind = m.lastgroup
            toks.append(Tok(kind, m.group(), ln))
    return toks


# --------------------------------------------------------------------------- #
# statement parsing
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class Stmt:
    kind: str                   # method|if|else|for|while|do|switch|case|label|
                                # goto|break|continue|return|expr|block
    line: int                   # first source line of the header
    header: List[Tok] = dataclasses.field(default_factory=list)
    body: List["Stmt"] = dataclasses.field(default_factory=list)
    orelse: List["Stmt"] = dataclasses.field(default_factory=list)
    label: str = ""             # goto target / label name


class _Parser:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, k: int = 0) -> Optional[Tok]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Optional[Tok]:
        t = self.peek()
        self.i += 1
        return t

    def at(self, text: str) -> bool:
        t = self.peek()
        return t is not None and t.text == text

    def skip_parens(self) -> List[Tok]:
        """Consume a balanced (...) group, returning inner tokens."""
        inner: List[Tok] = []
        if not self.at("("):
            return inner
        depth = 0
        while (t := self.next()) is not None:
            if t.text == "(":
                depth += 1
                if depth == 1:
                    continue
            elif t.text == ")":
                depth -= 1
                if depth == 0:
                    return inner
            inner.append(t)
        return inner

    def parse_stmt_list(self, stop_at_brace: bool = True) -> List[Stmt]:
        out: List[Stmt] = []
        while (t := self.peek()) is not None:
            if t.text == "}" and stop_at_brace:
                return out
            s = self.parse_stmt()
            if s is not None:
                out.append(s)
        return out

    def parse_block_or_single(self) -> List[Stmt]:
        if self.at("{"):
            self.next()
            body = self.parse_stmt_list()
            if self.at("}"):
                self.next()
            return body
        s = self.parse_stmt()
        return [s] if s is not None else []

    def parse_stmt(self) -> Optional[Stmt]:
        t = self.peek()
        if t is None:
            return None
        tx = t.text

        if tx == ";":
            self.next(); return None
        if tx == "{":
            self.next()
            body = self.parse_stmt_list()
            if self.at("}"):
                self.next()
            return Stmt("block", t.line, body=body)
        if tx == "}":
            self.next(); return None

        if tx == "if":
            self.next()
            header = self.skip_parens()
            body = self.parse_block_or_single()
            node = Stmt("if", t.line, header=header, body=body)
            if self.at("else"):
                e = self.next()
                if self.at("if"):
                    nested = self.parse_stmt()
                    node.orelse = [nested] if nested else []
                else:
                    els_body = self.parse_block_or_single()
                    node.orelse = [Stmt("else", e.line, body=els_body)]
            return node

        if tx in ("while", "for", "switch"):
            self.next()
            header = self.skip_parens()
            body = self.parse_block_or_single()
            return Stmt(tx, t.line, header=header, body=body)

        if tx == "do":
            self.next()
            body = self.parse_block_or_single()
            node = Stmt("do", t.line, body=body)
            if self.at("while"):
                w = self.next()
                cond = self.skip_parens()
                if self.at(";"):
                    self.next()
                node.header = cond
                node.label = str(w.line)   # line of the trailing while
            return node

        if tx in ("case", "default"):
            self.next()
            header = [t]
            while (p := self.peek()) is not None and p.text != ":":
                header.append(self.next())
            if self.at(":"):
                self.next()
            return Stmt("case", t.line, header=header)

        if tx in ("break", "continue"):
            self.next()
            if self.at(";"):
                self.next()
            return Stmt(tx, t.line)

        if tx == "goto":
            self.next()
            target = self.next()
            if self.at(";"):
                self.next()
            return Stmt("goto", t.line, label=target.text if target else "")

        if tx == "return":
            self.next()
            header = [t]
            while (p := self.peek()) is not None and p.text != ";":
                if p.text in "{}":
                    break
                header.append(self.next())
            if self.at(";"):
                self.next()
            return Stmt("return", t.line, header=header)

        if tx == "else":   # stray else (shouldn't happen with well-formed ifs)
            self.next()
            body = self.parse_block_or_single()
            return Stmt("else", t.line, body=body)

        # goto label:  ident ':' not inside ternary — lookahead
        nt = self.peek(1)
        if (t.kind == "id" and nt is not None and nt.text == ":"
                and t.text not in C_KEYWORDS):
            self.next(); self.next()
            return Stmt("label", t.line, label=tx)

        # plain expression / declaration statement up to ';'
        header = []
        depth = 0
        while (p := self.peek()) is not None:
            if p.text == "(":
                depth += 1
            elif p.text == ")":
                depth -= 1
            elif depth <= 0 and p.text in (";", "{", "}"):
                break
            header.append(self.next())
        if self.at(";"):
            self.next()
        if not header:
            if self.at("{") or self.at("}"):
                # handled at next iteration
                return None
            self.next()
            return None
        return Stmt("expr", t.line, header=header)


def parse_function(code: str) -> Tuple[Optional[Stmt], List[Stmt], List[str]]:
    """Split a C function into (signature stmt, body stmts, cleaned lines)."""
    lines = clean_code(code)
    toks = tokenize(lines)
    # signature = tokens up to the first top-level '{'
    depth = 0
    split = None
    for idx, t in enumerate(toks):
        if t.text == "(":
            depth += 1
        elif t.text == ")":
            depth -= 1
        elif t.text == "{" and depth == 0:
            split = idx
            break
    if split is None:
        return None, [], lines
    sig_toks = toks[:split]
    sig_line = sig_toks[0].line if sig_toks else 1
    sig = Stmt("method", sig_line, header=sig_toks)
    parser = _Parser(toks[split + 1:])
    body = parser.parse_stmt_list(stop_at_brace=True)
    return sig, body, lines


# --------------------------------------------------------------------------- #
# node typing
# --------------------------------------------------------------------------- #

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<=", ">>="}
_CMP_OPS = {"<", ">", "<=", ">=", "==", "!="}
_LOGIC_OPS = {"&&", "||", "!"}
_ARITH_OPS = {"+", "-", "*", "/", "%", "++", "--"}
_ACCESS_OPS = {"->", ".", "["}

KIND_TO_NTYPE = {
    "method": "METHOD", "if": "IF", "else": "ELSE", "for": "FOR",
    "while": "WHILE", "do": "DO", "switch": "SWITCH", "case": "JUMP_TARGET",
    "label": "JUMP_TARGET", "goto": "GOTO", "break": "BREAK",
    "continue": "CONTINUE", "return": "RETURN", "block": "BLOCK",
}


def _call_names(toks: List[Tok]) -> List[str]:
    names = []
    for i, t in enumerate(toks[:-1]):
        if (t.kind == "id" and t.text not in C_KEYWORDS
                and toks[i + 1].text == "("):
            names.append(t.text)
    return names


def classify_expr(toks: List[Tok]) -> str:
    """Node-type bucket for an expression/declaration statement.

    Precedence mirrors the longest-code-per-line collapse: the outermost
    operator node owns the line (assignment ≻ call ≻ cast ≻ logical ≻
    comparison ≻ access ≻ arithmetic), then declarations, identifiers,
    literals (reference semantics: type_2_type + ne_groupnodes).
    """
    texts = [t.text for t in toks]
    if any(x in _ASSIGN_OPS for x in texts):
        return "Assignment Operator"
    calls = _call_names(toks)
    if calls:
        if any(c in SENSITIVE_APIS for c in calls):
            return "Builtin Function Call"
        return "External Function Call"
    # declaration without initializer: type ident [, ident]* ;
    if toks and (toks[0].text in TYPE_KEYWORDS
                 or (len(toks) >= 2 and toks[0].kind == "id" and toks[1].kind == "id")):
        if not any(x in _CMP_OPS | _LOGIC_OPS for x in texts):
            return "LOCAL"
    if len(texts) >= 2 and texts[0] == "(" :
        return "Cast Operator"
    if any(x in _LOGIC_OPS for x in texts):
        return "Logical Operator"
    if any(x in _CMP_OPS for x in texts):
        return "Comparison Operator"
    if any(x in _ACCESS_OPS for x in texts):
        return "Access Operator"
    if any(x in _ARITH_OPS for x in texts):
        return "Arithmetic Operator"
    if len(toks) == 1 and toks[0].kind == "id":
        return "IDENTIFIER"
    if len(toks) == 1 and toks[0].kind in ("num", "str", "chr"):
        return "LITERAL"
    if toks:
        return "Other Operator"
    return "UNKNOWN"


# --------------------------------------------------------------------------- #
# graph construction
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class LineCPG:
    nodes: List[Tuple[int, str, str]]            # (lineno, code, ntype)
    edges: List[Tuple[int, int, str]]            # (src_line, dst_line, etype)

    def filtered(self, gtype: str = "all") -> "LineCPG":
        """Apply the reference's graph-type edge filter (rdg) + lone-node drop."""
        admit = GRAPH_TYPE_EDGES[gtype]
        edges = [e for e in self.edges if e[2] in admit]
        keep = {e[0] for e in edges} | {e[1] for e in edges}
        nodes = [n for n in self.nodes if n[0] in keep]
        return LineCPG(nodes, edges)

    def to_arrays(self):
        import numpy as np
        linenos = np.array([n[0] for n in self.nodes], dtype=np.int32)
        codes = [n[1] for n in self.nodes]
        ntypes = [n[2] for n in self.nodes]
        idx = {ln: i for i, ln in enumerate(linenos.tolist())}
        src = np.array([idx[e[0]] for e in self.edges], dtype=np.int32)
        dst = np.array([idx[e[1]] for e in self.edges], dtype=np.int32)
        et = [e[2] for e in self.edges]
        return linenos, codes, ntypes, src, dst, et


class _GraphBuilder:
    def __init__(self, sig: Stmt, body: List[Stmt], lines: List[str]):
        self.sig = sig
        self.body = body
        self.lines = lines
        self.ast: Set[Tuple[int, int]] = set()
        self.cfg: Set[Tuple[int, int]] = set()
        self.cdg: Set[Tuple[int, int]] = set()
        self.ntype: Dict[int, str] = {}
        self.header_toks: Dict[int, List[Tok]] = {}
        self.labels: Dict[str, int] = {}
        self.gotos: List[Tuple[int, str]] = []
        self.stmts_by_line: Dict[int, Stmt] = {}

    # ---- pass 1: nodes, AST containment, labels -----------------------------
    def collect(self, stmts: List[Stmt], parent_line: int, ctrl_line: Optional[int]):
        for s in stmts:
            if s.kind == "block":
                self.collect(s.body, parent_line, ctrl_line)
                continue
            self._add_node(s)
            if s.line != parent_line:
                self.ast.add((parent_line, s.line))
            if ctrl_line is not None and ctrl_line != s.line:
                self.cdg.add((ctrl_line, s.line))
            if s.kind == "label":
                self.labels[s.label] = s.line
            if s.kind == "goto":
                self.gotos.append((s.line, s.label))
            inner_ctrl = s.line if s.kind in ("if", "for", "while", "do", "switch") else (
                ctrl_line if s.kind not in ("else",) else ctrl_line)
            if s.kind == "else":
                # else body is controlled by the matching if's predicate, which
                # is the parent passed in via orelse handling below
                pass
            self.collect(s.body, s.line, inner_ctrl if s.kind != "else" else ctrl_line)
            if s.kind == "if" and s.orelse:
                for o in s.orelse:
                    if o.kind == "else":
                        self._add_node(o)
                        if o.line != s.line:
                            self.ast.add((s.line, o.line))
                            self.cdg.add((s.line, o.line))
                        self.collect(o.body, o.line, s.line)
                    else:  # else-if chain
                        self.collect([o], s.line, s.line)

    def _add_node(self, s: Stmt):
        ln = s.line
        if s.kind == "expr":
            ntype = classify_expr(s.header)
        elif s.kind == "return" and len(s.header) > 1:
            ntype = "RETURN"
        else:
            ntype = KIND_TO_NTYPE.get(s.kind, "UNKNOWN")
        prev = self.ntype.get(ln)
        if prev is None or _line_code_len(self.lines, ln) >= 0 and prev in ("UNKNOWN", "BLOCK"):
            self.ntype[ln] = ntype
        elif prev is not None and s.kind != "expr":
            pass  # keep first (outermost) statement's type for the line
        self.stmts_by_line.setdefault(ln, s)
        if s.header:
            self.header_toks.setdefault(ln, []).extend(s.header)

    # ---- pass 2: control flow ------------------------------------------------
    def wire(self, stmts: List[Stmt], follow: Optional[int],
             brk: Optional[int], cont: Optional[int]):
        flat = [s for s in stmts if s.kind != "block"] or []
        # expand blocks transparently
        seq: List[Stmt] = []
        for s in stmts:
            if s.kind == "block":
                seq.extend(s.body)
            else:
                seq.append(s)
        for i, s in enumerate(seq):
            nxt = self._first_line(seq[i + 1:]) if i + 1 < len(seq) else follow
            self._wire_stmt(s, nxt, brk, cont)
        del flat

    def _first_line(self, stmts: List[Stmt]) -> Optional[int]:
        for s in stmts:
            if s.kind == "block":
                ln = self._first_line(s.body)
                if ln is not None:
                    return ln
                continue
            return s.line
        return None

    def _edge(self, a: Optional[int], b: Optional[int]):
        if a is not None and b is not None and a != b:
            self.cfg.add((a, b))

    def _wire_stmt(self, s: Stmt, nxt: Optional[int], brk: Optional[int],
                   cont: Optional[int]):
        k = s.kind
        if k in ("expr", "label", "case"):
            self._edge(s.line, nxt)
            if k in ("label", "case"):
                pass
        elif k == "goto":
            tgt = self.labels.get(s.label)
            self._edge(s.line, tgt if tgt is not None else nxt)
        elif k == "break":
            self._edge(s.line, brk if brk is not None else nxt)
        elif k == "continue":
            self._edge(s.line, cont if cont is not None else nxt)
        elif k == "return":
            self._edge(s.line, self.sig.line)   # METHOD_RETURN collapses to sig line
        elif k == "if":
            then_first = self._first_line(s.body)
            self._edge(s.line, then_first if then_first is not None else nxt)
            self.wire(s.body, nxt, brk, cont)
            if s.orelse:
                for o in s.orelse:
                    if o.kind == "else":
                        self._edge(s.line, o.line)
                        first = self._first_line(o.body)
                        self._edge(o.line, first if first is not None else nxt)
                        self.wire(o.body, nxt, brk, cont)
                    else:
                        self._edge(s.line, o.line)
                        self._wire_stmt(o, nxt, brk, cont)
            else:
                self._edge(s.line, nxt)
        elif k in ("while", "for"):
            first = self._first_line(s.body)
            self._edge(s.line, first if first is not None else s.line)
            self._edge(s.line, nxt)
            self.wire(s.body, s.line, nxt, s.line)
        elif k == "do":
            first = self._first_line(s.body)
            cond_line = int(s.label) if s.label else s.line
            self._edge(s.line, first if first is not None else cond_line)
            self.wire(s.body, cond_line if cond_line != s.line else s.line, nxt, cond_line)
            self._edge(cond_line, first if first is not None else s.line)
            self._edge(cond_line, nxt)
            if cond_line != s.line and s.header:
                self.ntype.setdefault(cond_line, "WHILE")
                self.header_toks.setdefault(cond_line, []).extend(s.header)
        elif k == "switch":
            seq = []
            for c in s.body:
                seq.extend(c.body) if c.kind == "block" else seq.append(c)
            case_lines = [c.line for c in seq if c.kind == "case"]
            for cl in case_lines:
                self._edge(s.line, cl)
            if not case_lines:
                first = self._first_line(s.body)
                self._edge(s.line, first if first is not None else nxt)
            self._edge(s.line, nxt)  # no-match / default fallthrough
            self.wire(s.body, nxt, nxt, cont)
        elif k == "else":
            first = self._first_line(s.body)
            self._edge(s.line, first if first is not None else nxt)
            self.wire(s.body, nxt, brk, cont)


def _line_code_len(lines: List[str], ln: int) -> int:
    if 1 <= ln <= len(lines):
        return len(lines[ln - 1].strip())
    return 0


# ---- reaching definitions -------------------------------------------------- #

def _defs_uses(toks: List[Tok]) -> Tuple[Set[str], Set[str]]:
    """Heuristic per-statement def/use sets over identifier tokens."""
    defs: Set[str] = set()
    uses: Set[str] = set()
    texts = [t.text for t in toks]
    n = len(toks)
    for i, t in enumerate(toks):
        if t.kind != "id" or t.text in C_KEYWORDS or t.text in TYPE_KEYWORDS:
            continue
        nxt = texts[i + 1] if i + 1 < n else ""
        prv = texts[i - 1] if i > 0 else ""
        if nxt == "(":
            continue  # call name
        # assignment target: ident [subscript/member...] ASSIGN
        j = i + 1
        depth = 0
        while j < n:
            x = texts[j]
            if x == "[":
                depth += 1
            elif x == "]":
                depth -= 1
            elif depth == 0:
                break
            j += 1
        tail = texts[j] if j < n else ""
        if depth == 0 and tail in _ASSIGN_OPS:
            defs.add(t.text)
            if tail != "=" or j > i + 1:   # compound assign / element write also reads
                uses.add(t.text)
            continue
        if nxt in ("++", "--") or prv in ("++", "--"):
            defs.add(t.text); uses.add(t.text)
            continue
        # declaration introduces a def even without initializer
        if prv in TYPE_KEYWORDS or (i >= 1 and toks[i - 1].kind == "id"
                                    and toks[i - 1].text in TYPE_KEYWORDS):
            defs.add(t.text)
            continue
        uses.add(t.text)
    return defs, uses


def _param_names(sig_toks: List[Tok]) -> Set[str]:
    """Parameter identifiers: last identifier before each ',' or the ')'."""
    try:
        lp = next(i for i, t in enumerate(sig_toks) if t.text == "(")
    except StopIteration:
        return set()
    names: Set[str] = set()
    current: Optional[str] = None
    for t in sig_toks[lp + 1:]:
        if t.text in (",",):
            if current:
                names.add(current)
            current = None
        elif t.kind == "id" and t.text not in C_KEYWORDS and t.text not in TYPE_KEYWORDS:
            current = t.text
    if current:
        names.add(current)
    return names


def _reaching_defs(node_lines: List[int], cfg: Set[Tuple[int, int]],
                   gen: Dict[int, Set[str]], use: Dict[int, Set[str]],
                   entry: int) -> Set[Tuple[int, int]]:
    """Worklist reaching-definitions; returns (def_line, use_line) edges."""
    preds: Dict[int, List[int]] = {ln: [] for ln in node_lines}
    for a, b in cfg:
        if b in preds and a in preds:
            preds[b].append(a)
    # IN[l] ⊆ {(var, def_line)}
    IN: Dict[int, Set[Tuple[str, int]]] = {ln: set() for ln in node_lines}
    OUT: Dict[int, Set[Tuple[str, int]]] = {ln: set() for ln in node_lines}
    order = sorted(node_lines)
    changed = True
    iters = 0
    while changed and iters < 200:
        changed = False
        iters += 1
        for ln in order:
            new_in = set()
            for p in preds[ln]:
                new_in |= OUT[p]
            kill_vars = gen.get(ln, set())
            new_out = {(v, d) for (v, d) in new_in if v not in kill_vars}
            new_out |= {(v, ln) for v in kill_vars}
            if new_in != IN[ln] or new_out != OUT[ln]:
                IN[ln], OUT[ln] = new_in, new_out
                changed = True
    edges: Set[Tuple[int, int]] = set()
    for ln in order:
        for v in use.get(ln, set()):
            for (var, dline) in IN[ln]:
                if var == v and dline != ln:
                    edges.add((dline, ln))
    return edges


# --------------------------------------------------------------------------- #
# public API
# --------------------------------------------------------------------------- #

def extract_line_cpg(code: str) -> Optional[LineCPG]:
    """Extract the per-line CPG of a single C function.

    Returns None when no function body is found (mirrors get_node_edges
    returning None on unparseable input, joern.py:278-281).
    """
    sig, body, lines = parse_function(code)
    if sig is None or not body:
        return None

    gb = _GraphBuilder(sig, body, lines)
    gb.ntype[sig.line] = "METHOD"
    gb.header_toks[sig.line] = list(sig.header)
    gb.stmts_by_line[sig.line] = sig
    gb.collect(body, sig.line, None)

    # CFG: entry = signature → first body statement
    first = gb._first_line(body)
    gb._edge(sig.line, first)
    gb.wire(body, None, None, None)

    node_lines = sorted(gb.ntype)
    codes = {ln: " ".join(lines[ln - 1].split()) if ln <= len(lines) else ""
             for ln in node_lines}

    # reaching definitions over the CFG
    gen: Dict[int, Set[str]] = {}
    use: Dict[int, Set[str]] = {}
    params = _param_names(sig.header)
    gen[sig.line] = set(params)
    use[sig.line] = set()
    for ln in node_lines:
        toks = gb.header_toks.get(ln, [])
        d, u = _defs_uses(toks)
        gen[ln] = gen.get(ln, set()) | d
        use[ln] = use.get(ln, set()) | u
    rd_edges = _reaching_defs(node_lines, gb.cfg, gen, use, sig.line)

    nodes = [(ln, codes[ln], gb.ntype[ln]) for ln in node_lines]
    edges: List[Tuple[int, int, str]] = []
    edges += [(a, b, "AST") for (a, b) in sorted(gb.ast)]
    edges += [(a, b, "CFG") for (a, b) in sorted(gb.cfg)]
    edges += [(a, b, "CDG") for (a, b) in sorted(gb.cdg)]
    edges += [(a, b, "REACHING_DEF") for (a, b) in sorted(rd_edges)]
    edges = [(a, b, t) for (a, b, t) in edges
             if a in gb.ntype and b in gb.ntype]
    return LineCPG(nodes=nodes, edges=edges)


def dep_context_lines(cpg: "LineCPG", linenos, lines: List[str],
                      max_ctx: int = 6, sep: str = " ; ") -> List[str]:
    """Per-node line text augmented with its dependency-source lines.

    For each requested line number, returns the line's own text followed by
    the text of its REACHING_DEF / CDG / CFG predecessor lines (sorted,
    deduped, capped at ``max_ctx``). This is the cross-site context
    IVDetect's data-/control-dependency channels carry per statement
    (reference: ivdetect/dataset.py:122-301) — it makes a relation between
    literals at distant sites (a buffer declaration and its guard bound) a
    LOCAL token-sequence feature the per-line encoder can compare with
    attention, instead of a multi-hop message-passing problem.
    Enabled by ``DATA.NODE_CONTEXT="deps"``.
    """
    ctx_of: Dict[int, Set[int]] = {}
    for (a, b, t) in cpg.edges:
        if t in ("REACHING_DEF", "CDG", "CFG") and a != b:
            ctx_of.setdefault(b, set()).add(a)
    out = []
    for ln in linenos:
        ln = int(ln)
        base = lines[ln - 1] if 1 <= ln <= len(lines) else ""
        srcs = sorted(s for s in ctx_of.get(ln, ())
                      if 1 <= s <= len(lines))[:max_ctx]
        out.append(sep.join([base] + [lines[s - 1] for s in srcs]))
    return out


_NUM_RE = re.compile(r"\b\d+\b")


def numeric_literal_feats(cpg: "LineCPG", linenos, lines: List[str],
                          k: int = 2, max_ctx: int = 6) -> "np.ndarray":
    """Per-node numeric-magnitude features: log1p of the first ``k`` integer
    literals on the node's own line, then the first ``k`` from its
    dependency-source lines (REACHING_DEF/CDG/CFG predecessors, in line
    order — the same context set as dep_context_lines). [len(linenos), 2k]
    float32, zero-padded.

    Subword LMs are notoriously weak at comparing numeral MAGNITUDES from
    token identity alone (numeracy literature); on value-binding
    vulnerabilities (a buffer size vs its guard bound) the label is exactly
    such a comparison. These scalars give the fusion tower the magnitudes
    directly; enabled by DATA.NODE_NUMERIC=k (0 = off, the parity default).
    """
    import numpy as np

    ctx_of: Dict[int, Set[int]] = {}
    for (a, b, t) in cpg.edges:
        if t in ("REACHING_DEF", "CDG", "CFG") and a != b:
            ctx_of.setdefault(b, set()).add(a)

    def lits(ln: int) -> List[float]:
        if not (1 <= ln <= len(lines)):
            return []
        return [float(m.group(0)) for m in _NUM_RE.finditer(lines[ln - 1])]

    out = np.zeros((len(linenos), 2 * k), np.float32)
    for i, ln in enumerate(linenos):
        ln = int(ln)
        own = lits(ln)[:k]
        ctx: List[float] = []
        for s in sorted(ctx_of.get(ln, ()))[:max_ctx]:
            ctx.extend(lits(s))
        ctx = ctx[:k]
        for j, v in enumerate(own):
            out[i, j] = np.log1p(v)
        for j, v in enumerate(ctx):
            out[i, k + j] = np.log1p(v)
    return out
