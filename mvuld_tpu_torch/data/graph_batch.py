"""Dense, statically-shaped graph batching for TPU.

The reference batches variable-size DGL graphs (dgl.batch) then pads/truncates
to max_node=100 inside the model (reference: mvuld/models/GraphModel.py
unbatch_features:30-54, 134). On TPU, dynamic graphs defeat XLA, so batching
happens once on the host into fixed-shape arrays:

  * node arrays  [B, N]     — line numbers, node-type ids, validity mask
  * pos features [B, N, 4]  — OCR/oracle normalized bboxes (data_list.py:282-290)
  * adjacency    [B, N, N]  — uint8 bitmask; bit e set ⟺ an edge of
                               EDGE_TYPE_MAP id e connects i→j. Any gtype
                               subset (rdg) is a bitwise test, no re-batching.
  * self-loops added on every valid node (reference: dgl.add_self_loop,
    data_list.py:311)

N defaults to 100 (DATA.MAX_NODES) — the reference's own pad length, so the
layout is parity-exact AND MXU-friendly (dense [B,N,·] matmuls; masked
segment ops are not needed at N=100).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from mvuld_tpu_torch.tools.cpg import LineCPG
from mvuld_tpu_torch.tools.vocab import EDGE_TYPE_MAP, GRAPH_TYPE_EDGES, NODE_TYPE_MAP


@dataclasses.dataclass
class PackedGraph:
    """One function's graph as dense arrays (host-side, numpy)."""
    lineno: np.ndarray        # [N] int32, 0 where padded
    ntype: np.ndarray         # [N] int32 node-type id
    mask: np.ndarray          # [N] float32 1/0 validity
    pos: np.ndarray           # [N, 4] float32 normalized bbox
    adj: np.ndarray           # [N, N] uint8 edge-type bitmask (src→dst)
    num_nodes: int


def pack_graph(cpg: LineCPG, max_nodes: int = 100,
               pos_dict: Optional[Dict[int, Sequence[float]]] = None,
               gtype: str = "all") -> PackedGraph:
    """Pack one LineCPG into fixed shapes.

    Truncation keeps the first ``max_nodes`` nodes in line order — the same
    order the reference's pad/truncate uses (GraphModel.py:134,182).
    """
    g = cpg.filtered(gtype)
    nodes = sorted(g.nodes)[:max_nodes]
    lineno = np.zeros(max_nodes, np.int32)
    ntype = np.zeros(max_nodes, np.int32)
    mask = np.zeros(max_nodes, np.float32)
    pos = np.zeros((max_nodes, 4), np.float32)
    adj = np.zeros((max_nodes, max_nodes), np.uint8)
    index = {}
    for i, (ln, _code, nt) in enumerate(nodes):
        index[ln] = i
        lineno[i] = ln
        ntype[i] = NODE_TYPE_MAP.get(nt, NODE_TYPE_MAP["UNKNOWN"])
        mask[i] = 1.0
        if pos_dict and int(ln) in pos_dict:
            pos[i] = np.asarray(pos_dict[int(ln)], np.float32)
    admit = GRAPH_TYPE_EDGES[gtype]
    for (a, b, t) in g.edges:
        if t in admit and a in index and b in index:
            adj[index[a], index[b]] |= np.uint8(1 << EDGE_TYPE_MAP[t])
    # self-loop on every valid node, flagged with all admitted edge bits so it
    # survives any later gtype mask (reference: dgl.add_self_loop)
    loop_bits = np.uint8(0)
    for t in admit:
        loop_bits |= np.uint8(1 << EDGE_TYPE_MAP[t])
    for i in range(len(nodes)):
        adj[i, i] |= loop_bits
    return PackedGraph(lineno, ntype, mask, pos, adj, num_nodes=len(nodes))


def batch_graphs(graphs: List[PackedGraph]) -> Dict[str, np.ndarray]:
    """Stack PackedGraphs → dict of [B, ...] arrays."""
    return {
        "lineno": np.stack([g.lineno for g in graphs]),
        "ntype": np.stack([g.ntype for g in graphs]),
        "node_mask": np.stack([g.mask for g in graphs]),
        "pos": np.stack([g.pos for g in graphs]),
        "adj": np.stack([g.adj for g in graphs]),
        "num_nodes": np.asarray([g.num_nodes for g in graphs], np.int32),
    }


def adjacency_for(batch_adj: np.ndarray, etypes: Sequence[str]) -> np.ndarray:
    """Boolean [B, N, N] adjacency admitting only the given edge types."""
    bits = 0
    for t in etypes:
        bits |= 1 << EDGE_TYPE_MAP[t]
    return (batch_adj & np.uint8(bits)) != 0


def per_etype_adjacency(batch_adj: np.ndarray, num_etypes: int = len(EDGE_TYPE_MAP)
                        ) -> np.ndarray:
    """[B, R, N, N] float32 one adjacency slice per edge type (for GGNN-style
    models with per-relation weights, e.g. the Devign baseline)."""
    B, N, _ = batch_adj.shape
    out = np.zeros((B, num_etypes, N, N), np.float32)
    for e in range(num_etypes):
        out[:, e] = ((batch_adj >> e) & 1).astype(np.float32)
    return out


def k_hop_neighbors(adj: np.ndarray, seeds: Sequence[int], hops: int = 1,
                    include_seeds: bool = True) -> np.ndarray:
    """Indices reachable from ``seeds`` within ``hops`` (undirected), for one
    [N, N] adjacency — the reference's sparse-matrix hop expansion
    (joern.py neighbour_nodes:409-453) over the dense layout."""
    und = (adj > 0) | (adj > 0).T
    frontier = np.zeros(und.shape[0], bool)
    frontier[list(seeds)] = True
    visited = frontier.copy()
    for _ in range(hops):
        frontier = und[frontier].any(axis=0) & ~visited
        visited |= frontier
    if not include_seeds:
        visited[list(seeds)] = False
    return np.where(visited)[0]
