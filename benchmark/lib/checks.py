"""The numbers that decide ``correct``, and how they are compared.

A training cell compares, against the reference that follows the same
steps from the same seed:

* ``loss1`` / ``loss3`` / ``loss``: the relative gap of the first checked
  step's loss / the widest over the first three / over all checked steps;
* ``grad1`` / ``grad1_med``: the first gradient as the optimizer gets it
  (clipped), taken leaf by leaf from the optimizer's first moment after one
  step: the worst leaf / the median leaf;
* ``update`` / ``update_med``: the parameters' change after the checked
  steps, the worst leaf / the median leaf;
* ``grad_rms`` / ``grad_rms_med``: ‖√v‖ of Adam's second moment after the
  checked steps (the gradients' weighted root mean square, as the
  optimizer got them), the worst leaf / the median leaf;
* ``bn1``: the BatchNorm running statistics' change after the first step,
  the worst buffer.

A leaf-by-leaf number is the worst leaf's gap between the two sides' norms,
over the reference's norm of that leaf or of the median leaf, whichever is
larger. ``update`` leaves out the leaves whose reference gradient is under
a thousandth of the median leaf's: their change is Adam's rounding noise
(a key bias under softmax has no gradient in exact arithmetic).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch

SMALL_GRAD = 1e-3


def norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
          ) -> Dict[str, float]:
    """{name: ‖t‖·scale} with one host transfer."""
    names = sorted(tensors)
    if not names:
        return {}
    v = torch.stack([tensors[k].detach().float().norm() for k in names])
    return {k: float(x) * scale for k, x in zip(names, v.tolist())}


def change_norms(now: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    return norms({k: now[k].detach().float() - start[k].float()
                  for k in start})


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    names = sorted(set(ref) if keep is None else set(keep))
    if set(names) - set(prog):
        raise KeyError(f"leaves missing on the program's side: "
                       f"{sorted(set(names) - set(prog))[:5]}")
    med = statistics.median(ref[k] for k in names)
    worst, at = 0.0, ""
    for k in names:
        base = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / base if base > 0 else abs(prog[k])
        if not math.isfinite(prog[k]):
            gap = math.inf
        if gap > worst or at == "":
            worst, at = gap, k
    return worst, at


def moving_leaves(grad1: Dict[str, float]) -> list:
    med = statistics.median(grad1.values())
    return [k for k, v in grad1.items() if v >= SMALL_GRAD * med]


def loss_gap(prog, ref) -> float:
    return max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
               for a, b in zip(prog, ref))


def median_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keep: Optional[Iterable[str]] = None) -> float:
    """The median over leaves of the same gap as ``worst_leaf``."""
    names = sorted(set(ref) if keep is None else set(keep))
    med = statistics.median(ref[k] for k in names)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) if math.isfinite(prog[k])
            else math.inf for k in names]
    return statistics.median(gaps)


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """Every number a training run can give, with the leaf that sets each
    leaf-by-leaf one; a cell's limits say which are compared."""
    out = {"loss1": {"value": loss_gap(prog["losses"][:1], ref["losses"][:1])},
           "loss3": {"value": loss_gap(prog["losses"][:3], ref["losses"][:3])},
           "loss": {"value": loss_gap(prog["losses"], ref["losses"])}}
    if prog.get("grad1") is not None:
        v, at = worst_leaf(prog["grad1"], ref["grad1"])
        out["grad1"] = {"value": v, "at": at}
        out["grad1_med"] = {"value": median_leaf(prog["grad1"],
                                                 ref["grad1"])}
    moving = moving_leaves(ref["grad1"])
    v, at = worst_leaf(prog["update"], ref["update"], moving)
    out["update"] = {"value": v, "at": at}
    out["update_med"] = {"value": median_leaf(prog["update"], ref["update"],
                                              moving)}
    if prog.get("grad_rms") is not None:
        v, at = worst_leaf(prog["grad_rms"], ref["grad_rms"])
        out["grad_rms"] = {"value": v, "at": at}
        out["grad_rms_med"] = {"value": median_leaf(prog["grad_rms"],
                                                    ref["grad_rms"])}
    if ref.get("bn1") and prog.get("bn1") is not None:
        v, at = worst_leaf(prog["bn1"], ref["bn1"])
        out["bn1"] = {"value": v, "at": at}
    return out


def judge(numbers: Dict[str, Dict], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a number that is not finite fails);
    a number without a limit is shown and not compared."""
    ok = bool(limits)
    for k, n in numbers.items():
        n["limit"] = limits.get(k)
        if n["limit"] is None:
            continue
        if not (math.isfinite(n["value"]) and n["value"] <= n["limit"]):
            ok = False
    return ok
