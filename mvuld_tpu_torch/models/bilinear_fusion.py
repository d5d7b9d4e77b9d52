"""Bilinear multimodal pooling operators in PyTorch.

Counterpart of ``mvuld_tpu/models/bilinear_fusion.py`` (reference:
mvuld/models/fusion.py:7-662, from the block.bootstrap/VQA line of work):
LinearSum, ConcatMLP, MLB, MFB, MFH, Mutan, Tucker, Block, BlockTucker,
RelationalNetwork, registered under ``BILINEAR_FUSIONS`` with the JAX
keys, constructor defaults and parameter names (Dense ``linear0`` …, the
raw Tucker cores ``core`` / ``core_{c}``).

The pairwise operators take two inputs [B, D0], [B, D1] → [B, output_dim];
torch needs their widths up front, so they read ``input_dims`` (a JAX
field too). RelationalNetwork takes [B, N, D] sets → [B, output_dim] and an
``input_dim`` D, which JAX infers. ``forward(x, gen)`` draws dropout from
``gen`` at the JAX operators' places; ``gen=None`` is deterministic.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.core.registry import Registry
from mvuld_tpu_torch.models.dropout import dropout

BILINEAR_FUSIONS = Registry("bilinear_fusions")


def _pair(x: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if len(x) != 2:
        raise ValueError("fusion operators take exactly two inputs")
    return x[0], x[1]


def _signed_sqrt_l2(z: torch.Tensor) -> torch.Tensor:
    z = torch.sign(z) * torch.sqrt(torch.abs(z) + 1e-12)
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)


class _FusionBase(nn.Module):
    def __init__(self, input_dims: Tuple[int, int] = (512, 512),
                 output_dim: int = 512, mm_dim: int = 512,
                 dropout_input: float = 0.0, dropout_output: float = 0.0):
        super().__init__()
        self.input_dims, self.output_dim = tuple(input_dims), output_dim
        self.mm_dim, self.dropout_input = mm_dim, dropout_input
        self.dropout_output = dropout_output   # unused, as in JAX


@BILINEAR_FUSIONS.register("linear_sum")
class LinearSum(_FusionBase):
    """proj each → sum → proj out (reference: fusion.py LinearSum)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.linear0 = nn.Linear(self.input_dims[0], self.mm_dim)
        self.linear1 = nn.Linear(self.input_dims[1], self.mm_dim)
        self.linear_out = nn.Linear(self.mm_dim, self.output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x0, x1 = _pair(x)
        z = self.linear0(x0) + self.linear1(x1)
        return self.linear_out(dropout(z, self.dropout_input, gen))


@BILINEAR_FUSIONS.register("concat_mlp")
class ConcatMLP(_FusionBase):
    def __init__(self, hidden: int = 512, **kw):
        super().__init__(**kw)
        self.fc1 = nn.Linear(sum(self.input_dims), hidden)
        self.fc2 = nn.Linear(hidden, self.output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        z = F.relu(self.fc1(torch.cat(list(x), dim=-1)))
        return self.fc2(dropout(z, self.dropout_input, gen))


@BILINEAR_FUSIONS.register("mlb")
class MLB(_FusionBase):
    """Multimodal low-rank bilinear: elementwise product of projections."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.linear0 = nn.Linear(self.input_dims[0], self.mm_dim)
        self.linear1 = nn.Linear(self.input_dims[1], self.mm_dim)
        self.linear_out = nn.Linear(self.mm_dim, self.output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x0, x1 = _pair(x)
        z = torch.tanh(self.linear0(x0)) * torch.tanh(self.linear1(x1))
        return self.linear_out(dropout(z, self.dropout_input, gen))


@BILINEAR_FUSIONS.register("mfb")
class MFB(_FusionBase):
    """Multimodal factorized bilinear: expand ×factor, elementwise product,
    sum-pool factor groups, signed-sqrt + l2 normalize."""

    def __init__(self, factor: int = 2, **kw):
        super().__init__(**kw)
        self.factor = factor
        e = self.mm_dim * factor
        self.linear0 = nn.Linear(self.input_dims[0], e)
        self.linear1 = nn.Linear(self.input_dims[1], e)
        self.linear_out = nn.Linear(self.mm_dim, self.output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x0, x1 = _pair(x)
        z = dropout(self.linear0(x0) * self.linear1(x1), self.dropout_input,
                    gen)
        z = z.reshape(z.shape[0], self.mm_dim, self.factor).sum(-1)
        return self.linear_out(_signed_sqrt_l2(z))


@BILINEAR_FUSIONS.register("mfh")
class MFH(_FusionBase):
    """Two chained MFB stages, outputs concatenated (reference:
    fusion.py MFH:422-545)."""

    def __init__(self, factor: int = 2, **kw):
        super().__init__(**kw)
        self.factor = factor
        e = self.mm_dim * factor
        for i in (0, 1):
            self.add_module(f"linear0_{i}", nn.Linear(self.input_dims[0], e))
            self.add_module(f"linear1_{i}", nn.Linear(self.input_dims[1], e))
        self.out_0 = nn.Linear(self.mm_dim, self.output_dim // 2)
        self.out_1 = nn.Linear(self.mm_dim, self.output_dim // 2)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x0, x1 = _pair(x)
        inter1 = dropout(self.linear0_0(x0) * self.linear1_0(x1),
                         self.dropout_input, gen)
        inter2 = inter1 * self.linear0_1(x0) * self.linear1_1(x1)
        outs = []
        for inter, out in ((inter1, self.out_0), (inter2, self.out_1)):
            p = inter.reshape(inter.shape[0], self.mm_dim, self.factor).sum(-1)
            outs.append(out(_signed_sqrt_l2(p)))
        return torch.cat(outs, dim=-1)


@BILINEAR_FUSIONS.register("mutan")
class Mutan(_FusionBase):
    """Tucker with rank-R low-rank core (reference: fusion.py Mutan)."""

    def __init__(self, rank: int = 10, **kw):
        super().__init__(**kw)
        self.rank = rank
        self.linear0 = nn.Linear(self.input_dims[0], self.mm_dim)
        self.linear1 = nn.Linear(self.input_dims[1], self.mm_dim)
        self.merge0 = nn.Linear(self.mm_dim, self.mm_dim * rank)
        self.merge1 = nn.Linear(self.mm_dim, self.mm_dim * rank)
        self.linear_out = nn.Linear(self.mm_dim, self.output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x0, x1 = _pair(x)
        z0 = self.merge0(self.linear0(x0))
        z1 = self.merge1(self.linear1(x1))
        z = (z0 * z1).reshape(z0.shape[0], self.mm_dim, self.rank).sum(-1)
        return self.linear_out(dropout(z, self.dropout_input, gen))


@BILINEAR_FUSIONS.register("tucker")
class Tucker(_FusionBase):
    """Full Tucker core tensor (small mm dims only)."""

    def __init__(self, core_dim: int = 64, **kw):
        super().__init__(**kw)
        self.linear0 = nn.Linear(self.input_dims[0], core_dim)
        self.linear1 = nn.Linear(self.input_dims[1], core_dim)
        self.core = nn.Parameter(torch.empty(core_dim, core_dim, core_dim))
        nn.init.normal_(self.core, 0.0, 0.02)
        self.linear_out = nn.Linear(core_dim, self.output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x0, x1 = _pair(x)
        z = torch.einsum("bi,ijk,bj->bk", self.linear0(x0), self.core,
                         self.linear1(x1))
        return self.linear_out(dropout(z, self.dropout_input, gen))


@BILINEAR_FUSIONS.register("block")
class Block(_FusionBase):
    """Block-superdiagonal bilinear fusion (reference: fusion.py Block:31-110):
    project to mm_dim, split into ``chunks``, per-chunk rank-limited bilinear
    via expand→product→sum-pool, concat, signed-sqrt-l2."""

    def __init__(self, chunks: int = 8, rank: int = 4, **kw):
        super().__init__(**kw)
        self.chunks, self.rank = chunks, rank
        cs = self.mm_dim // chunks
        self.linear0 = nn.Linear(self.input_dims[0], self.mm_dim)
        self.linear1 = nn.Linear(self.input_dims[1], self.mm_dim)
        for c in range(chunks):
            self.add_module(f"merge0_{c}", nn.Linear(cs, cs * rank))
            self.add_module(f"merge1_{c}", nn.Linear(cs, cs * rank))
        self.linear_out = nn.Linear(cs * chunks, self.output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x0, x1 = _pair(x)
        z0 = dropout(self.linear0(x0), self.dropout_input, gen)
        z1 = dropout(self.linear1(x1), self.dropout_input, gen)
        cs = self.mm_dim // self.chunks
        outs = []
        for c in range(self.chunks):
            ea = getattr(self, f"merge0_{c}")(z0[:, c * cs:(c + 1) * cs])
            eb = getattr(self, f"merge1_{c}")(z1[:, c * cs:(c + 1) * cs])
            outs.append((ea * eb).reshape(-1, cs, self.rank).sum(-1))
        return self.linear_out(_signed_sqrt_l2(torch.cat(outs, dim=-1)))


@BILINEAR_FUSIONS.register("block_tucker")
class BlockTucker(_FusionBase):
    """Block with a Tucker core per chunk."""

    def __init__(self, chunks: int = 8, **kw):
        super().__init__(**kw)
        self.chunks = chunks
        cs = self.mm_dim // chunks
        self.linear0 = nn.Linear(self.input_dims[0], self.mm_dim)
        self.linear1 = nn.Linear(self.input_dims[1], self.mm_dim)
        for c in range(chunks):
            core = nn.Parameter(torch.empty(cs, cs, cs))
            nn.init.normal_(core, 0.0, 0.02)
            self.register_parameter(f"core_{c}", core)
        self.linear_out = nn.Linear(cs * chunks, self.output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x0, x1 = _pair(x)
        z0, z1 = self.linear0(x0), self.linear1(x1)
        cs = self.mm_dim // self.chunks
        outs = [torch.einsum("bi,ijk,bj->bk", z0[:, c * cs:(c + 1) * cs],
                             getattr(self, f"core_{c}"),
                             z1[:, c * cs:(c + 1) * cs])
                for c in range(self.chunks)]
        z = _signed_sqrt_l2(torch.cat(outs, dim=-1))
        return self.linear_out(dropout(z, self.dropout_input, gen))


@BILINEAR_FUSIONS.register("relational_network")
class RelationalNetwork(nn.Module):
    """Sum of a shared MLP over all object pairs (reference: fusion.py
    RelationalNetwork). Input [B, N, input_dim] → [B, output_dim]."""

    def __init__(self, input_dim: int, output_dim: int = 512,
                 hidden: int = 512):
        super().__init__()
        self.g1 = nn.Linear(2 * input_dim, hidden)
        self.g2 = nn.Linear(hidden, hidden)
        self.f1 = nn.Linear(hidden, hidden)
        self.f2 = nn.Linear(hidden, output_dim)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        B, N, D = x.shape
        a = x[:, :, None, :].expand(B, N, N, D)
        b = x[:, None, :, :].expand(B, N, N, D)
        pairs = torch.cat([a, b], dim=-1).reshape(B, N * N, 2 * D)
        h = F.relu(self.g2(F.relu(self.g1(pairs)))).sum(dim=1)
        return self.f2(F.relu(self.f1(h)))


def build_bilinear_fusion(name: str, **kwargs) -> nn.Module:
    return BILINEAR_FUSIONS.build(name, **kwargs)
