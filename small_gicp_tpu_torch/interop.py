"""numpy ↔ port conversions.

``cloud_from_numpy`` builds a PointCloud from arrays in the reference's
layout — for example the fields of a JAX-package cloud taken with
``np.asarray`` — so that both packages compute on identical inputs;
``result_to_numpy`` turns a RegistrationResult into plain numpy values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from small_gicp_tpu_torch.point_cloud import PointCloud, resolve_device
from small_gicp_tpu_torch.models.registration import RegistrationResult


def cloud_from_numpy(points, num_points, normals=None, covs=None,
                     device=None) -> PointCloud:
    """Padded [N,4] points (+ [N,4] normals, [N,3,3] covs) → PointCloud.

    The arrays are copied and keep their dtype and padding as given;
    ``device`` defaults to the card.
    """
    dev = resolve_device(device)

    def put(a) -> Optional[torch.Tensor]:
        return None if a is None else torch.tensor(np.asarray(a), device=dev)

    pts = put(points)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"points must be [N,4], got {tuple(pts.shape)}")
    return PointCloud(
        points=pts,
        num_points=torch.tensor(int(num_points), dtype=torch.int32, device=dev),
        normals=put(normals),
        covs=put(covs),
    )


def result_to_numpy(result: RegistrationResult) -> dict:
    """RegistrationResult → dict of numpy arrays and Python scalars; a
    fleet's [P]-batched result gives [P] arrays in place of the scalars."""
    batched = result.T_target_source.dim() == 3

    def get(t, scalar):
        a = t.detach().cpu().numpy()
        return a if batched else scalar(a)

    return {
        "T_target_source": result.T_target_source.detach().cpu().numpy(),
        "converged": get(result.converged, bool),
        "iterations": get(result.iterations, int),
        "num_inliers": get(result.num_inliers, int),
        "H": result.H.detach().cpu().numpy(),
        "b": result.b.detach().cpu().numpy(),
        "error": get(result.error, float),
    }
