"""Clip-by-global-norm and AdamW over a list of fp32 tensors in one pass on
the card (``csrc/fused_adamw.cu``), with the plain versions beside it.

``sumsq(tensors)`` is Σ t² over the list as an fp32 device scalar; on the
card one ``sumsq_blocks`` launch per table of tensors writes a partial a
block and ``sumsq_finish`` adds them in a fixed order (fp64 throughout),
so two calls, or a graph replay and an eager step, agree to the bit.

``fused_adamw(ps, gs, ms, vs, decay, s, eps, wd)`` is one AdamW step in
place over parameters ``ps`` and their moments ``ms``, ``vs`` from the
gradients ``gs``: the clip by ``s["clip"]`` when given, then optax's
adamw arithmetic with the device fp32 coefficients of ``s`` (``neg_lr``,
``c1``, ``c2``, ``b1``, ``omb1``, ``b2``, ``omb2``; ``core/optim.py``
gates them under MultiSteps) and weight decay ``wd`` on the tensors whose
``decay`` flag is set. On the card each element is read once and written
once, with the `_foreach` chain's fp32 roundings in its order (the
source's header); ``adamw_plain`` is that chain, and the CPU path.

CPU tensors run the plain versions; CUDA tensors run the kernels, or raise
(fp32 and contiguous only): nothing falls back. A ``Plan`` holds what
stays fixed from step to step (sizes, the p, m, v pointers, the decay
flags), so that a call reads only the gradients' pointers.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

from mvuld_tpu_torch.ops import _build

_COEFS = ("clip", "neg_lr", "c1", "c2", "b1", "omb1", "b2", "omb2")


def sumsq_plain(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ‖t‖² in fp32, one product and sum a tensor, added in list order on
    the first tensor's device (optax.global_norm's square)."""
    dev = tensors[0].device
    return sum((t.float() * t.float()).sum().to(dev) for t in tensors)


def adamw_plain(ps, gs, ms, vs, decay: Sequence[bool],
                s: Dict[str, torch.Tensor], eps: float, wd: float) -> None:
    """The clip and AdamW step as ``torch._foreach_*`` calls over the lists
    (one device): g·clip, m = b1·m + omb1·g, v = b2·v + omb2·g²,
    u = (m/c1) / (√(v/c2) + eps) (+ wd·p where decayed), p += neg_lr·u."""
    if "clip" in s:
        gs = torch._foreach_mul(gs, s["clip"])
    dec = [j for j, d in enumerate(decay) if d]
    torch._foreach_mul_(ms, s["b1"])
    torch._foreach_add_(ms, torch._foreach_mul(gs, s["omb1"]))
    sq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(sq, s["omb2"])
    torch._foreach_mul_(vs, s["b2"])
    torch._foreach_add_(vs, sq)
    del sq
    den = torch._foreach_div(vs, s["c2"])
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(ms, s["c1"])
    torch._foreach_div_(upd, den)
    del den
    if dec:
        torch._foreach_add_([upd[j] for j in dec], [ps[j] for j in dec],
                            alpha=wd)
    torch._foreach_mul_(upd, s["neg_lr"])
    torch._foreach_add_(ps, upd)


def _fn(name):
    fn = getattr(_build.load("fused_adamw"), name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = {
            "optim_sumsq_slots": [I, P],
            "optim_sumsq": [I, P, P, P, P, P],
            "optim_adamw": [I] + [P] * 7 + [F, F, P],
        }[name]
        fn.restype = (ctypes.c_longlong if name == "optim_sumsq_slots"
                      else ctypes.c_int)
    return fn


def _ptrs(tensors) -> "ctypes.Array":
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what}: {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(the kernels take contiguous float32 on {dev})")


class Plan:
    """A list's launch tables that hold from step to step: the sizes and
    the partial slots of ``sumsq``; with ``ps``, ``ms``, ``vs`` and
    ``decay`` also their pointers and flags for ``fused_adamw`` (the
    optimizer updates them in place, so their addresses hold)."""

    def __init__(self, ps: Sequence[torch.Tensor], ms=None, vs=None,
                 decay: Optional[Sequence[bool]] = None):
        self.device = ps[0].device
        if self.device.type != "cuda":
            raise ValueError(f"Plan: unsupported device {self.device}")
        n = len(ps)
        self.sizes = [p.numel() for p in ps]
        self.numel = (ctypes.c_longlong * n)(*self.sizes)
        self.slots = _fn("optim_sumsq_slots")(n, self.numel)
        self.tables = None
        if ms is not None:
            for t in (*ps, *ms, *vs):
                _check(t, self.device, "fused_adamw")
            if [m.numel() for m in ms] != self.sizes or \
                    [v.numel() for v in vs] != self.sizes:
                raise ValueError("fused_adamw: moments and parameters differ "
                                 "in size")
            self.tables = (_ptrs(ps), _ptrs(ms), _ptrs(vs),
                           (ctypes.c_ubyte * n)(*[bool(d) for d in decay]))

    def grads(self, gs: Sequence[torch.Tensor], what: str) -> "ctypes.Array":
        """The gradients' pointers, each checked against its size."""
        if len(gs) != len(self.sizes):
            raise ValueError(f"{what}: {len(gs)} tensors, planned "
                             f"{len(self.sizes)}")
        for g, n in zip(gs, self.sizes):
            _check(g, self.device, what)
            if g.numel() != n:
                raise ValueError(f"{what}: a tensor of {g.numel()} values "
                                 f"where {n} were planned")
        return _ptrs(gs)


def sumsq(tensors: Sequence[torch.Tensor],
          plan: Optional[Plan] = None) -> torch.Tensor:
    """Σ‖t‖² over the list as an fp32 scalar on its device (module
    docstring); ``plan``: the list's sizes, if planned."""
    if tensors[0].device.type == "cpu":
        return sumsq_plain(tensors)
    plan = plan or Plan(tensors)
    ptrs = plan.grads(tensors, "sumsq")
    dev = plan.device
    part = torch.empty(max(plan.slots, 1), dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    err = _fn("optim_sumsq")(len(tensors), ptrs, plan.numel, part.data_ptr(),
                             out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    sumsq.launches += 1
    _build.check(err, "sumsq")
    return out


def fused_adamw(ps: List[torch.Tensor], gs: Sequence[torch.Tensor],
                ms: List[torch.Tensor], vs: List[torch.Tensor],
                decay: Sequence[bool], s: Dict[str, torch.Tensor],
                eps: float, wd: float, plan: Optional[Plan] = None) -> bool:
    """One AdamW step in place (module docstring); ``plan``: the lists'
    ``Plan``, built here if not given. Returns True where the kernel ran,
    False where the plain chain did (CPU tensors)."""
    if ps[0].device.type == "cpu":
        adamw_plain(ps, gs, ms, vs, decay, s, eps, wd)
        return False
    plan = plan or Plan(ps, ms, vs, decay)
    dev = plan.device
    gp = plan.grads(gs, "fused_adamw")
    coefs = []
    for k in _COEFS:
        t = s.get(k)
        if t is None and k != "clip":
            raise ValueError(f"fused_adamw: no coefficient {k!r}")
        if t is not None:
            _check(t, dev, f"fused_adamw coefficient {k}")
        coefs.append(None if t is None else t.data_ptr())
    p, m, v, dec = plan.tables
    err = _fn("optim_adamw")(
        len(ps), p, gp, m, v, plan.numel, dec,
        (ctypes.c_void_p * len(coefs))(*coefs), eps, wd,
        torch.cuda.current_stream(dev).cuda_stream)
    fused_adamw.launches += 1
    _build.check(err, "fused_adamw")
    return True


sumsq.launches = 0
fused_adamw.launches = 0
