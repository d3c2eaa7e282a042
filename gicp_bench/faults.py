"""Faults planted under the timed path, to show that a broken program
comes out not correct: a step that returns its state unchanged, half of
the batch left out (half of a cloud's rows, or half of a fleet batch's
problems, the other half answered by the first), and an answer altered
where it is produced (1 cm along x). The cells run on one card, so no
exchange between cards can be left out.

``plant(driver, fault)`` patches the program for the cells of one driver
(``pair``, ``fleet`` or ``odometry``) and returns a function that undoes
the patch. The tests plant them at a tiny size on the CPU; ``calibrate.py
--fault`` reads them at a cell's own size on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

FAULTS = ("unchanged", "half", "altered")


def _pair(fault: str, orig):
    if fault == "unchanged":
        def align_impl(target, source, tree, init_T, *a, **k):
            res = orig(target, source, tree, init_T, *a, **k)
            return res.replace(T_target_source=torch.as_tensor(init_T).to(
                res.T_target_source))
    elif fault == "half":
        def align_impl(target, source, tree, init_T, *a, **k):
            half = source.replace(num_points=source.num_points // 2)
            return orig(target, half, tree, init_T, *a, **k)
    else:
        def align_impl(*a, **k):
            res = orig(*a, **k)
            T = res.T_target_source.clone()
            T[0, 3] += 0.01
            return res.replace(T_target_source=T)
    return align_impl


def _fleet(fault: str, orig):
    def align_fleet(targets, sources, init_Ts, pair_ids=None, **k):
        P = init_Ts.shape[0]
        if fault == "half":
            res = orig(targets, sources, init_Ts[:P // 2], pair_ids=pair_ids[:P // 2], **k)
            fields = {f.name: torch.cat([getattr(res, f.name), getattr(res, f.name)])
                      for f in dataclasses.fields(res)}
            fields["T_target_source"] = torch.cat([res.T_target_source, init_Ts[P // 2:]])
            return res.replace(**fields)
        res = orig(targets, sources, init_Ts, pair_ids=pair_ids, **k)
        T = init_Ts.clone() if fault == "unchanged" else res.T_target_source.clone()
        if fault == "altered":
            T[:, 0, 3] += 0.01
        return res.replace(T_target_source=T)
    return align_fleet


def _odometry(fault: str, orig):
    def step(carry, frame_points, frame_count, **k):
        if fault == "unchanged":
            return carry, carry[0]
        if fault == "half":
            return orig(carry, frame_points, frame_count // 2, **k)
        (T, d, vm, first), _ = orig(carry, frame_points, frame_count, **k)
        T = T.clone()
        T[0, 3] += 0.01
        return (T, d, vm, first), T
    return step


def plant(driver: str, fault: str) -> Callable[[], None]:
    """Patch the program with ``fault`` under the cells of ``driver``;
    returns the undo."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if driver == "pair":
        from small_gicp_tpu_torch.models import registration as mod
        name, make = "align_impl", _pair
    elif driver == "fleet":
        import small_gicp_tpu_torch as mod
        name, make = "align_fleet", _fleet
    elif driver == "odometry":
        from small_gicp_tpu_torch.models import odometry_scan as mod
        name, make = "odometry_scan_step", _odometry
    else:
        raise ValueError(f"no faults for driver {driver!r}")
    orig = getattr(mod, name)
    setattr(mod, name, make(fault, orig))
    return lambda: setattr(mod, name, orig)
