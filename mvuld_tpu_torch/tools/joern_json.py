"""Parser for Joern CPG JSON exports → the framework's LineCPG format.

A copy of ``mvuld_tpu/tools/joern_json.py`` onto the port's
``tools/cpg.LineCPG`` and ``tools/vocab`` (the port imports nothing of the
JAX package); host code, no torch.

Users who run real Joern (the reference's extraction tool) get byte-format
compatibility: this module consumes the ``{file}.nodes.json`` /
``{file}.edges.json`` pairs produced by the reference's Scala script
(baselines/storage/external/get_func_graph.sc — ``run_joern`` writes the
equivalent ``JOERN_SCRIPT`` to tools/joern/get_func_graph.sc) and reproduces the reference parse exactly
(mvuld/sastvd/helpers/joern.py get_node_edges:252-354 + ne_groupnodes
data_list.py:319-339):

  * drop META/COMMENT/FILE nodes and the <global> method,
  * drop CONTAINS/SOURCE_FILE/DOMINATE/POST_DOMINATE edges,
  * attach line numbers; keep edges touching at least one line,
  * collapse to ONE node per line — the node with the longest code wins,
  * node-type canonicalization via the reference's operator-name buckets
    (type_2_type, joern.py:605-666).

The result is a ``LineCPG`` — identical downstream handling to our native
extractor (``tools/cpg.py``).
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional, Tuple

from mvuld_tpu_torch.tools.cpg import LineCPG
from mvuld_tpu_torch.tools.vocab import EDGE_TYPE_MAP, SENSITIVE_APIS

_DROP_NODE_LABELS = {"COMMENT", "FILE"}
_DROP_EDGE_TYPES = {"CONTAINS", "SOURCE_FILE", "DOMINATE", "POST_DOMINATE"}


def joern_type_to_bucket(label: str, name: str, control_structure_type: str
                         ) -> str:
    """Canonical node-type bucket (reference: type_2_type joern.py:605-666)."""
    if label == "CALL":
        if "<operator>" in name:
            if "assignment" in name:
                return "Assignment Operator"
            if any(k in name for k in ("addition", "subtraction", "division",
                                       "Plus", "Minus", "minus", "plus",
                                       "modulo", "multiplication")):
                return "Arithmetic Operator"
            if any(k in name for k in ("lessThan", "greaterThan", "EqualsThan",
                                       "equals")):
                return "Comparison Operator"
            if any(k in name for k in ("FieldAccess", "IndexAccess",
                                       "fieldAccess", "indexAccess")):
                return "Access Operator"
            if any(k in name for k in ("logical", "<operator>.not",
                                       "<operator>.or", "<operator>.and",
                                       "conditional")):
                return "Logical Operator"
            if "<operator>.cast" in name:
                return "Cast Operator"
            return "Other Operator"
        if name in SENSITIVE_APIS:
            return "Builtin Function Call"
        return "External Function Call"
    if label == "CONTROL_STRUCTURE":
        return control_structure_type or "UNKNOWN"
    return label


def parse_joern_json(nodes_path: str, edges_path: str) -> Optional[LineCPG]:
    """Parse one function's Joern export into a line-level CPG."""
    with open(edges_path) as f:
        raw_edges = json.load(f)
    with open(nodes_path) as f:
        raw_nodes = json.load(f)

    nodes: Dict[int, dict] = {}
    for n in raw_nodes:
        label = n.get("_label", "")
        if "META" in label or label in _DROP_NODE_LABELS:
            continue
        if n.get("name") == "<global>":
            continue
        code = n.get("code", "") or ""
        if code == "<empty>":
            code = ""
        if not code:
            code = n.get("name", "") or ""
        ln = n.get("lineNumber")
        nodes[int(n["id"])] = {
            "label": label, "name": n.get("name", "") or "", "code": code,
            "line": int(ln) if ln not in (None, "") else None,
            "cst": n.get("controlStructureType", "") or "",
        }
    if not nodes:
        return None

    # edges: rows are [innode, outnode, etype, dataflow]; flow outnode→innode
    # (reference: dgl.graph((eo, ei)), data_list.py:280)
    line_edges: List[Tuple[int, int, str]] = []
    for e in raw_edges:
        innode, outnode, etype = int(e[0]), int(e[1]), str(e[2])
        if etype in _DROP_EDGE_TYPES:
            continue
        if etype not in EDGE_TYPE_MAP:
            continue
        src = nodes.get(outnode)
        dst = nodes.get(innode)
        if src is None or dst is None:
            continue
        if src["line"] is None or dst["line"] is None:
            continue
        line_edges.append((src["line"], dst["line"], etype))

    # one node per line: longest code wins (ne_groupnodes)
    per_line: Dict[int, dict] = {}
    for n in nodes.values():
        if n["line"] is None:
            continue
        cur = per_line.get(n["line"])
        if cur is None or len(n["code"]) > len(cur["code"]):
            per_line[n["line"]] = n

    # drop lone lines (no edges touch them)
    connected = {a for (a, b, t) in line_edges} | {b for (a, b, t) in line_edges}
    out_nodes = []
    for ln in sorted(per_line):
        if ln not in connected:
            continue
        n = per_line[ln]
        ntype = joern_type_to_bucket(n["label"], n["name"], n["cst"])
        out_nodes.append((ln, " ".join(n["code"].split()), ntype))
    if not out_nodes:
        return None
    edges = sorted({(a, b, t) for (a, b, t) in line_edges
                    if a in per_line and b in per_line and a != b})
    return LineCPG(nodes=out_nodes, edges=edges)


def get_node_edges(c_file_path: str) -> Optional[LineCPG]:
    """Reference-style entry: reads {path}.nodes.json / {path}.edges.json."""
    return parse_joern_json(c_file_path + ".nodes.json",
                            c_file_path + ".edges.json")


JOERN_SCRIPT = """\
// Export one function's CPG as nodes/edges JSON (equivalent of the
// reference's get_func_graph.sc).
@main def exec(filename: String) = {
  importCode(inputPath = filename, projectName = filename)
  run.ossdataflow
  cpg.graph.E.map(e => List(e.inNode.id, e.outNode.id, e.label,
    e.propertyOption("VARIABLE").toString)).toJson |> s"$filename.edges.json"
  cpg.graph.V.map(node => node).toJson |> s"$filename.nodes.json"
  delete
}
"""


def run_joern(c_file_path: str, joern_bin: str = "joern",
              script_dir: Optional[str] = None) -> bool:
    """Invoke a local Joern install (if present) to produce the JSON pair
    (reference: full_run_joern, joern.py:388-397). Returns False when Joern
    is unavailable — callers fall back to the native extractor."""
    import shutil
    if shutil.which(joern_bin) is None:
        return False
    script_dir = script_dir or os.path.join(os.path.dirname(__file__), "joern")
    os.makedirs(script_dir, exist_ok=True)
    script = os.path.join(script_dir, "get_func_graph.sc")
    if not os.path.exists(script):
        with open(script, "w") as f:
            f.write(JOERN_SCRIPT)
    res = subprocess.run(
        [joern_bin, "--script", script, "--param", f"filename={c_file_path}"],
        capture_output=True, timeout=600)
    return (res.returncode == 0
            and os.path.exists(c_file_path + ".nodes.json")
            and os.path.exists(c_file_path + ".edges.json"))
