"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program's own training object through its first steps,
through the window's own call; the reference (``reference/``) is driven
through the same steps from the same inputs. A ``TrainRecorder`` on each
side keeps, without changing what the call computes:

* each step's loss;
* each parameter's first gradient as the optimizer got it, read from the
  optimizer's state after its first step (read, not compared: see
  ``training_checks``);
* each parameter's change over the steps followed;
* each parameter's largest gradient over those steps, as the optimizer got
  it (after the clip), which decides the leaves the change leaves out.

Norms are compared leaf by leaf as the gap between the program's norm and
the reference's, over the larger of the reference leaf's norm and the
median leaf's (some gradients are all but zero); the worst leaf is the
reading. The change leaves out leaves whose largest reference gradient is
under a thousandth of the median leaf's: they move by round-off alone.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

import torch


class TrainRecorder:
    """Attach to a net and its optimizer before the first step; call
    ``loss`` after each step and ``finish`` after the last one followed.
    ``first_grad(optimizer_state_of_p)`` gives the gradient the optimizer
    got at its first step from its state after that step."""

    def __init__(self, net: torch.nn.Module, optimizer,
                 first_grad: Callable[[dict], torch.Tensor]):
        self.net = net
        self.names = {p: k for k, p in net.named_parameters()}
        self.start = {k: p.detach().clone()
                      for k, p in net.named_parameters()}
        self.losses: List[torch.Tensor] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self._grad_max: Dict[str, torch.Tensor] = {}

        def first(opt, args, kwargs):
            self.grad = {self.names[p]: float(torch.linalg.vector_norm(
                first_grad(opt.state[p]))) for p in self.names
                if p in opt.state}
            self._first.remove()

        def largest(opt, args, kwargs):
            for p, k in self.names.items():
                if p.grad is not None:
                    n = torch.linalg.vector_norm(p.grad.detach())
                    m = self._grad_max.get(k)
                    self._grad_max[k] = n if m is None else torch.maximum(m, n)

        self._first = optimizer.register_step_post_hook(first)
        self._largest = optimizer.register_step_pre_hook(largest)

    def loss(self, value: torch.Tensor) -> None:
        self.losses.append(value.detach().float().reshape(()))

    def finish(self) -> dict:
        self._largest.remove()
        self.change = {
            k: float(torch.linalg.vector_norm(p.detach() - self.start[k]))
            for k, p in self.net.named_parameters()}
        self.start = {}
        return {"loss": [float(x) for x in self.losses], "grad": self.grad,
                "change": self.change,
                "grad_max": {k: float(v) for k, v in self._grad_max.items()}}


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want != 0 else (
        0.0 if got == 0 else float("inf"))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Optional[set] = None) -> List[float]:
    """Each leaf's gap of norms, over the larger of the reference leaf's
    norm and the median leaf's; a missing leaf reads infinite."""
    keys = [k for k in want if keep is None or k in keep]
    if set(got) != set(want):
        return [float("inf")]
    med = statistics.median(want[k] for k in keys)
    return [abs(got[k] - want[k]) / max(want[k], med) for k in keys]


# the statistic over the leaves' gaps: the worst leaf, or, where the worst
# leaf swings from seed to seed for a reason PERF.md gives, the median leaf
STATISTICS = {"worst": max, "median": statistics.median}


def moved_leaves(grad: Dict[str, float], change: Dict[str, float]) -> set:
    """The leaves of ``change`` whose largest reference gradient is at
    least a thousandth of the median leaf's (a copy ``ema.<leaf>`` goes
    with its leaf)."""
    med = statistics.median(grad.values())
    moved = {k for k, g in grad.items() if g >= 1e-3 * med}
    return {k for k in change if k.removeprefix("ema.") in moved}


def training_checks(prog: dict, ref: dict, limits: dict,
                    change: str) -> List[dict]:
    """The training bullet's numbers that a cell compares, each with its
    limit: the worst step's loss gap, and the ``change`` statistic
    (``STATISTICS``) of the leaves' change gaps, named ``change_gap`` for
    the worst leaf and ``change_gap_<statistic>`` otherwise. The first
    gradient is read (``grad_readings``) but compared by no cell: on
    neither cell does its gap separate the fp8 control from sound runs
    (PERF.md gives the readings)."""
    loss = max(rel_gap(g, w) for g, w in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    c_name = "change_gap" + ("" if change == "worst" else f"_{change}")
    moved = moved_leaves(ref["grad_max"], ref["change"])
    return [
        {"name": "loss_gap", "value": loss, "limit": limits["loss_gap"]},
        {"name": c_name, "value": STATISTICS[change](
            leaf_gaps(prog["change"], ref["change"], moved)),
         "limit": limits[c_name]},
    ]


def grad_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The first gradient's worst and median leaf gaps."""
    gaps = leaf_gaps(prog["grad"], ref["grad"])
    return {name: f(gaps) for name, f in STATISTICS.items()}


def diff_gap(got: torch.Tensor, want: torch.Tensor,
             scale: Optional[torch.Tensor] = None) -> float:
    """||got - want|| over ||scale|| (default ``want``), in float64."""
    got, want = got.double(), want.double()
    scale = want if scale is None else scale.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(scale))
