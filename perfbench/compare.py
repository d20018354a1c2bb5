"""How a training cell's readings are compared with the reference's: the
numbers that decide ``correct`` (``compare_train``) and what is looked at
beside them (``detail_train``).  Readings are ``{"losses": [...],
"grad_norms": {leaf: norm}, "delta_norms": {leaf: norm}}``: each checked
step's loss, each leaf's first gradient norm as the optimizer's moments
hold it, each leaf's change after the checked steps."""

from __future__ import annotations

import statistics
from typing import Dict

import torch


def compare_train(got: dict, want: dict) -> Dict[str, float]:
    """The training numbers, each a gap between the program's reading and
    the reference's: by the worst checked step, the loss (relative); by
    the worst leaf, the first gradient's norm and the change's norm after
    the checked steps; by the median leaf, the change's norm
    (``update_gap_median``); and each leaf's change gap on its own
    (``update_gap.<leaf>``).  A norm gap is taken against the reference's
    norm of the leaf or of the median leaf, whichever is larger.  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out of the change.  A cell
    compares the numbers its limits file names."""
    g = want["grad_norms"]
    gmed = statistics.median(g.values())
    updates = _update_gaps(got, want)
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
           "grad_gap": max(abs(got["grad_norms"][k] - v) / max(v, gmed) for k, v in g.items()),
           "update_gap": max(updates.values()),
           "update_gap_median": statistics.median(updates.values())}
    out.update({f"update_gap.{k}": v for k, v in updates.items()})
    return out


def codes_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """Algorithm 1's codes: how many (entity, codebook) entries the
    program's ``(n, m)`` codes and the reference's differ in (exact)."""
    return float((program.long().to(reference.device) != reference.long()).sum())


def _update_gaps(got: dict, want: dict) -> Dict[str, float]:
    g, d = want["grad_norms"], want["delta_norms"]
    gmed = statistics.median(g.values())
    moved = [k for k, v in g.items() if v >= 1e-3 * gmed]
    dmed = statistics.median(d[k] for k in moved)
    return {k: abs(got["delta_norms"][k] - d[k]) / max(d[k], dmed) for k in moved}


def detail_train(got: dict, want: dict) -> Dict[str, object]:
    """What the probe prints beside the numbers: every step's loss gap, and
    every leaf's gap of the first gradient's norm and of the change's
    norm."""
    g = want["grad_norms"]
    gmed = statistics.median(g.values())
    out: Dict[str, object] = {f"loss_gap_step{i + 1}": abs(a - b) / abs(b)
                              for i, (a, b) in enumerate(zip(got["losses"], want["losses"]))}
    out["grad_gaps"] = {k: abs(got["grad_norms"][k] - v) / max(v, gmed) for k, v in g.items()}
    out["update_gaps"] = _update_gaps(got, want)
    return out
