"""Quaternion / rotation utilities (PyTorch, batched, differentiable).

Counterpart of ``edgegaussians_tpu/ops/transforms.py:13-104``. Quaternions
are wxyz.
"""

from __future__ import annotations

import torch


def normalize_quats(quats: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize [N,4] quaternions."""
    norm = torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    return quats / torch.clamp(norm, min=eps)


def rotmat_elements(quats: torch.Tensor):
    """wxyz quaternions [N,4] -> the 9 rotation-matrix elements as a 3x3
    nested list of [N] tensors (row-major)."""
    q = normalize_quats(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


def covariance6_from_quat_scale(quats: torch.Tensor, scales: torch.Tensor):
    """World covariance Sigma = R S S^T R^T as its 6 unique components
    (s00, s01, s02, s11, s12, s22), each [N]. ``scales`` are linear."""
    r = rotmat_elements(quats)
    m = [[r[i][k] * scales[:, k] for k in range(3)] for i in range(3)]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    return dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)


def major_directions(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Unit direction of each Gaussian's largest principal axis
    (transforms.py:43-69): the rotation-matrix column at the argmax of
    ``|scales|`` (linear scales), the first maximum on ties as
    ``jnp.argmax``. No gradient flows through the argmax."""
    r = rotmat_elements(quats)
    cols = torch.stack([torch.stack([r[0][c], r[1][c], r[2][c]], dim=-1)
                        for c in range(3)], dim=1)              # [N,3,3]
    amax = torch.argmax(torch.abs(scales), dim=-1)              # [N]
    return cols[torch.arange(cols.shape[0], device=cols.device), amax]
