"""Synthetic Big-Vul-like corpus generator.

There is no network egress in the build environment, so the framework ships a
deterministic generator of small C functions with injected vulnerability
patterns. It produces the same *shape* of data as the reference's cleaned
Big-Vul pickle (columns ``_id``, ``func_before``, ``vul``, ``label`` —
reference: baselines/scripts/process_dataset.py:22-174) so every downstream
stage (CPG extraction, rendering, tokenization, training) runs end-to-end.

Vulnerable variants inject classic CWE patterns: unbounded strcpy/sprintf,
missing length check before memcpy, off-by-one loop bounds, unchecked
malloc deref, format-string misuse, use-after-free. The clean twin of each
function performs the guarded/bounded equivalent, so the text/graph/image
signal is learnable but not trivial.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

_NAMES = ["buf", "dst", "src", "data", "msg", "tmp", "out", "line", "path", "name"]
_FUNCS = ["process", "handle", "parse", "copy", "read", "load", "fmt", "recv"]
_TYPES = ["char", "unsigned char"]


def _mk(rng: random.Random):
    v = {
        "fn": f"{rng.choice(_FUNCS)}_{rng.choice(_NAMES)}_{rng.randrange(1000)}",
        "buf": rng.choice(_NAMES),
        "src": rng.choice([n for n in _NAMES if n != "buf"]),
        "n": rng.choice([16, 32, 64, 128, 256]),
        "t": rng.choice(_TYPES),
        "i": rng.choice(["i", "j", "k"]),
    }
    v["big"] = v["n"] * 2
    return v


# each template: (vulnerable_body, fixed_body) — headers/footers shared
_TEMPLATES: List[Tuple[str, str]] = [
    # CWE-120 unbounded strcpy vs strncpy
    ("""int {fn}(const char *{src})
{{
    {t} {buf}[{n}];
    if ({src} == 0)
        return -1;
    strcpy({buf}, {src});
    printf("%s", {buf});
    return 0;
}}""",
     """int {fn}(const char *{src})
{{
    {t} {buf}[{n}];
    if ({src} == 0)
        return -1;
    strncpy({buf}, {src}, {n} - 1);
    {buf}[{n} - 1] = 0;
    printf("%s", {buf});
    return 0;
}}"""),
    # CWE-119 memcpy without bounds check vs with check
    ("""int {fn}(char *{src}, int len)
{{
    {t} {buf}[{n}];
    int {i};
    {i} = 0;
    memcpy({buf}, {src}, len);
    for ({i} = 0; {i} < len; {i}++) {{
        {buf}[{i}] = {buf}[{i}] + 1;
    }}
    return {buf}[0];
}}""",
     """int {fn}(char *{src}, int len)
{{
    {t} {buf}[{n}];
    int {i};
    {i} = 0;
    if (len > {n})
        return -1;
    memcpy({buf}, {src}, len);
    for ({i} = 0; {i} < len; {i}++) {{
        {buf}[{i}] = {buf}[{i}] + 1;
    }}
    return {buf}[0];
}}"""),
    # CWE-787 off-by-one loop bound
    ("""void {fn}(int *{src}, int count)
{{
    int {buf}[{n}];
    int {i};
    for ({i} = 0; {i} <= {n}; {i}++) {{
        {buf}[{i}] = {src}[{i} % count];
    }}
    while (count > 0) {{
        count--;
    }}
}}""",
     """void {fn}(int *{src}, int count)
{{
    int {buf}[{n}];
    int {i};
    for ({i} = 0; {i} < {n}; {i}++) {{
        {buf}[{i}] = {src}[{i} % count];
    }}
    while (count > 0) {{
        count--;
    }}
}}"""),
    # CWE-476 unchecked malloc deref
    ("""int {fn}(int size)
{{
    char *{buf};
    {buf} = malloc(size);
    {buf}[0] = 1;
    if (size > {n}) {{
        {buf}[size - 1] = 2;
    }}
    free({buf});
    return 0;
}}""",
     """int {fn}(int size)
{{
    char *{buf};
    {buf} = malloc(size);
    if ({buf} == 0)
        return -1;
    {buf}[0] = 1;
    if (size > {n}) {{
        {buf}[size - 1] = 2;
    }}
    free({buf});
    return 0;
}}"""),
    # CWE-134 format string
    ("""void {fn}(const char *{src})
{{
    char {buf}[{big}];
    snprintf({buf}, sizeof({buf}), "%s", "hdr");
    printf({src});
    fprintf(stderr, {src});
}}""",
     """void {fn}(const char *{src})
{{
    char {buf}[{big}];
    snprintf({buf}, sizeof({buf}), "%s", "hdr");
    printf("%s", {src});
    fprintf(stderr, "%s", {src});
}}"""),
    # CWE-416 use after free
    ("""int {fn}(int flag)
{{
    char *{buf};
    {buf} = malloc({n});
    if ({buf} == 0)
        return -1;
    {buf}[0] = 7;
    if (flag) {{
        free({buf});
    }}
    return {buf}[0];
}}""",
     """int {fn}(int flag)
{{
    char *{buf};
    {buf} = malloc({n});
    if ({buf} == 0)
        return -1;
    {buf}[0] = 7;
    if (flag) {{
        free({buf});
        return 0;
    }}
    return {buf}[0];
}}"""),
    # CWE-190 integer overflow before allocation
    ("""char *{fn}(int count)
{{
    char *{buf};
    int total;
    total = count * {n};
    {buf} = malloc(total);
    if ({buf} == 0) {{
        return 0;
    }}
    memset({buf}, 0, total);
    return {buf};
}}""",
     """char *{fn}(int count)
{{
    char *{buf};
    int total;
    if (count > 1024 / {n})
        return 0;
    total = count * {n};
    {buf} = malloc(total);
    if ({buf} == 0) {{
        return 0;
    }}
    memset({buf}, 0, total);
    return {buf};
}}"""),
    # CWE-129 unchecked array index
    ("""int {fn}(int idx, int *{src})
{{
    int {buf}[{n}];
    int {i};
    for ({i} = 0; {i} < {n}; {i}++) {{
        {buf}[{i}] = {i};
    }}
    {buf}[idx] = {src}[0];
    return {buf}[idx];
}}""",
     """int {fn}(int idx, int *{src})
{{
    int {buf}[{n}];
    int {i};
    for ({i} = 0; {i} < {n}; {i}++) {{
        {buf}[{i}] = {i};
    }}
    if (idx < 0 || idx >= {n})
        return -1;
    {buf}[idx] = {src}[0];
    return {buf}[idx];
}}"""),
]


# ---- hard mode: value-binding vulnerabilities --------------------------
#
# In the default templates the vulnerable/fixed twins differ in SURFACE
# tokens (strcpy vs strncpy, the presence of a guard statement), so any
# bag-of-local-patterns detector keys the label — measured on the default
# 600-function corpus: Devign/ReVeal/IVDetect reach 0.97–1.00 test F1
# (NOTES_r4.md "Baseline detectors"). Hard mode removes every surface key:
# each family emits the IDENTICAL statement sequence for both classes
# (same CPG shape, same API calls, operators and literals drawn from the
# same pools), and safety is a RELATION between literals at distant sites
# — guard bound vs declared size, loop operator vs bound vs array extent,
# index reach vs allocation. The same operator/literal is safe in one
# sampled function and vulnerable in another (e.g. `len > n` as a memcpy
# guard is safe, `idx > n` as an index guard is off-by-one vulnerable),
# so a detector must bind values across statements to label correctly.


# The five hard-family source templates, shared by _hard_function (random
# parameterization → derived label) and hard_twin (paired vulnerable/patched
# parameterizations of the SAME function — the synthetic analog of the
# reference's func_before/func_after columns, eval_patches.py:38-615).
_HARD_SRC = [
    """int {fn}(char *{src}, int len)
{{
    {t} {buf}[{n}];
    if (len {op} {bound})
        return -1;
    memcpy({buf}, {src}, len);
    {buf}[0] = {buf}[0] + 1;
    return {buf}[0];
}}""",
    """void {fn}(int *{src}, int count)
{{
    int {buf}[{n}];
    int {i};
    for ({i} = 0; {i} {op} {bound}; {i}++) {{
        {buf}[{i}] = {src}[{i} % count];
    }}
}}""",
    """int {fn}(int idx, int *{src})
{{
    int {buf}[{n}];
    if (idx < 0 || idx {op} {bound})
        return -1;
    {buf}[idx] = {src}[0];
    return {buf}[idx];
}}""",
    """int {fn}(const char *{src})
{{
    {t} {buf}[{decl}];
    strncpy({buf}, {src}, {bound});
    {buf}[{term}] = 0;
    printf("%s", {buf});
    return 0;
}}""",
    """int {fn}(int count)
{{
    int *{buf};
    {buf} = malloc({alloc} * sizeof(int));
    if ({buf} == 0)
        return -1;
    {buf}[{idx}] = 7;
    {buf}[0] = {buf}[{idx}] + count;
    free({buf});
    return 0;
}}""",
]


def hard_twin(rng: random.Random) -> Tuple[str, str]:
    """Return (vulnerable_src, patched_src): the SAME hard-family function
    rendered with a vulnerable parameterization and with its minimal safe
    patch — only the guard operator / bound / index literals change, exactly
    like a real security fix. Does not perturb ``_hard_function``'s RNG
    sequence (committed corpora are seed-reproducible)."""
    v = _mk(rng)
    n = 8 * rng.randrange(3, 61)
    big = 2 * n
    v["n"], v["big"] = n, big
    fam = rng.randrange(5)
    if fam == 0:
        # guarded memcpy: any accepted len > n overflows; patch tightens
        # the guard to (len > n)
        op, bound = rng.choice([(">", big), (">=", big)])
        vul = _HARD_SRC[0].format(op=op, bound=bound, **v)
        fix = _HARD_SRC[0].format(op=">", bound=n, **v)
    elif fam == 1:
        # loop bound: max index must stay ≤ n-1; patch is (i < n)
        op, bound = rng.choice([("<", big), ("<", big - 1),
                                ("<=", n), ("<=", big), ("<=", big - 1)])
        vul = _HARD_SRC[1].format(op=op, bound=bound, **v)
        fix = _HARD_SRC[1].format(op="<", bound=n, **v)
    elif fam == 2:
        # index guard: accepted max must exclude idx == n; patch (idx >= n)
        op, bound = rng.choice([(">", n), (">", big), (">=", big)])
        vul = _HARD_SRC[2].format(op=op, bound=bound, **v)
        fix = _HARD_SRC[2].format(op=">=", bound=n, **v)
    elif fam == 3:
        # strncpy: copy length/terminator exceed the declared size; patch
        # clamps both to the declaration
        decl = n
        bound, term = rng.choice([(big, n - 1), (n, big - 1), (big, big - 1)])
        vul = _HARD_SRC[3].format(decl=decl, bound=bound, term=term, **v)
        fix = _HARD_SRC[3].format(decl=decl, bound=decl, term=decl - 1, **v)
    else:
        # heap write past the allocation; patch writes the last valid slot
        alloc = n
        idx = rng.choice([n, big - 1])
        vul = _HARD_SRC[4].format(alloc=alloc, idx=idx, **v)
        fix = _HARD_SRC[4].format(alloc=alloc, idx=alloc - 1, **v)
    return vul, fix


def _hard_function(rng: random.Random) -> Tuple[str, int]:
    v = _mk(rng)
    # sizes come from a WIDE pool (multiples of 8 in [24, 480]) instead of
    # the default mode's five canonical sizes: with a small pool the
    # (decl, bound) literal pairs are a finite set a detector can memorize
    # from the train split; with ~58 sizes most test-split pairs are
    # unseen, so only the size relation itself generalizes
    n = 8 * rng.randrange(3, 61)
    big = 2 * n
    v["n"], v["big"] = n, big
    fam = rng.randrange(5)
    if fam == 0:
        # guarded memcpy: accepted len must not exceed the declared size
        op = rng.choice([">", ">="])
        bound = rng.choice([n, big])
        max_len = bound if op == ">" else bound - 1
        vul = int(max_len > n)
        src = _HARD_SRC[0].format(op=op, bound=bound, **v)
    elif fam == 1:
        # loop bound: operator AND bound must respect the array extent
        op = rng.choice(["<", "<="])
        bound = rng.choice([n, n - 1, big, big - 1])
        max_idx = bound - 1 if op == "<" else bound
        vul = int(max_idx > n - 1)
        src = _HARD_SRC[1].format(op=op, bound=bound, **v)
    elif fam == 2:
        # index guard: the REJECTING comparison must exclude idx == n
        # (note: `len > n` in family 0 is safe; `idx > n` here is not)
        op = rng.choice([">", ">="])
        bound = rng.choice([n - 1, n, big])
        accepted_max = bound - 1 if op == ">=" else bound
        vul = int(accepted_max > n - 1)
        src = _HARD_SRC[2].format(op=op, bound=bound, **v)
    elif fam == 3:
        # strncpy: copy length and terminator index vs the declared size
        decl = rng.choice([n, big])
        bound = rng.choice([n, big])
        term = rng.choice([n - 1, big - 1])
        vul = int(bound > decl or term > decl - 1)
        src = _HARD_SRC[3].format(decl=decl, bound=bound, term=term, **v)
    else:
        # heap write: index reach vs allocation size
        alloc = rng.choice([n, big])
        idx = rng.choice([n - 1, n, big - 1])
        vul = int(idx > alloc - 1)
        src = _HARD_SRC[4].format(alloc=alloc, idx=idx, **v)
    return src, vul


def generate_function(rng: random.Random,
                      hard: bool = False) -> Tuple[str, int]:
    """Return (source, vul_label)."""
    if hard:
        return _hard_function(rng)
    vul_body, fix_body = _TEMPLATES[rng.randrange(len(_TEMPLATES))]
    v = _mk(rng)
    if rng.random() < 0.5:
        return vul_body.format(**v), 1
    return fix_body.format(**v), 0


def generate_dataset(n: int, seed: int = 42, vul_ratio: float | None = None,
                     hard: bool = False):
    """Generate a DataFrame with columns _id, func_before, vul.

    With ``vul_ratio`` set, resamples labels to that positive rate (the
    Big-Vul natural rate is ≈4%; the reference balances train 1:1,
    getImages.py rebalanceData:80-99). With ``hard`` the corpus uses the
    value-binding families above instead of the token-separable twins.
    """
    import pandas as pd
    rng = random.Random(seed)
    rows: List[Dict] = []
    while len(rows) < n:
        src, vul = generate_function(rng, hard=hard)
        if vul_ratio is not None:
            want_vul = rng.random() < vul_ratio
            if bool(vul) != want_vul:
                continue
        rows.append({"_id": len(rows) + 1, "func_before": src, "vul": vul})
    return pd.DataFrame(rows)
