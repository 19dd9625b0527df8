"""The numbers that decide `correct`, and their limits.

Images: the program's uint8 image against the reference's float image
rounded to uint8 the same way (clamped to [-1, 1], (x + 1) * 127.5), both
as [-1, 1] values, as the relative L2 distance of each image, and the
worst image of the sample compared (`image_rel_l2`).

Training, over the first three steps: each step's loss as a relative gap
(`loss_rel`, the worst step); the norm of each trainable leaf's first
gradient (`grad_norm_gap`), of its change after the three steps
(`change_norm_gap`) and of its EMA shadow's change after them
(`ema_change_norm_gap`), each as the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
of the median leaf, the worst leaf. Leaves whose reference gradient is
under a thousandth of the median leaf's move by rounding alone and are
left out of both changes.

A limit file (`limits/<cell>.json`) holds, for each number, its limit and
the readings it was set from. A number that is not finite, or over its
limit, makes the run not correct.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence

import torch

def image_gaps(program_uint8: torch.Tensor, reference: torch.Tensor
               ) -> torch.Tensor:
    """Per image: ||p - r|| / ||r|| over [-1, 1] values."""
    p = program_uint8.float().reshape(program_uint8.shape[0], -1) / 127.5 - 1.0
    r = torch.round((torch.clamp(reference.float(), -1.0, 1.0) + 1.0) * 127.5)
    r = r.reshape(p.shape[0], -1) / 127.5 - 1.0
    return (p - r.to(p.device)).norm(dim=1) / r.norm(dim=1).to(p.device)


def image_numbers(gaps: Iterable[float]) -> Dict[str, float]:
    gaps = [float(g) for g in gaps]
    return {"image_rel_l2": max(gaps) if gaps else math.inf}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.float().norm()) for n, t in tensors.items()}


def _median(values: Sequence[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2] if s else 0.0


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Iterable[str]) -> float:
    """The worst leaf's |program norm - reference norm| over max(reference
    norm of the leaf, of the median leaf)."""
    med = _median(list(reference.values()))
    worst = 0.0
    for n in keep:
        den = max(reference[n], med)
        gap = abs(program[n] - reference[n]) / den if den > 0 else math.inf
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """`program` and `reference` each hold `losses` (floats), `grad_norms`,
    `change_norms` and `ema_change_norms` ({leaf: float})."""
    losses = [abs(a - b) / abs(b) if b else math.inf
              for a, b in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(math.inf)
    g_ref = reference["grad_norms"]
    med = _median(list(g_ref.values()))
    moved = [n for n in g_ref if g_ref[n] >= 1e-3 * med]
    return {
        "loss_rel": max(losses) if losses else math.inf,
        "grad_norm_gap": norm_gap(program["grad_norms"], g_ref, g_ref),
        "change_norm_gap": norm_gap(program["change_norms"],
                                    reference["change_norms"], moved),
        "ema_change_norm_gap": norm_gap(program["ema_change_norms"],
                                        reference["ema_change_norms"], moved),
    }


def reference_norms(ref: dict) -> dict:
    """`ldm.train_steps`' output as the norms `train_numbers` compares."""
    return {"losses": list(ref["losses"]),
            "grad_norms": _norms(ref["first_grad"]),
            "change_norms": _norms(ref["change"]),
            "ema_change_norms": _norms(ref["ema_change"])}


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, [(name, value, limit)]): every limited number finite and
    within its limit; a number without a limit decides nothing."""
    rows = [(n, float(numbers.get(n, math.inf)), float(v["limit"]))
            for n, v in sorted(limits.items())]
    ok = all(math.isfinite(x) and x <= lim for _, x, lim in rows)
    return ok, rows
