"""Batched rigid Procrustes (Kabsch) alignment.

Counterpart of ``umetrack_tpu/models/procrustes.py``:

- :func:`procrustes_align_quat` (the default): Horn's quaternion method,
  the dominant eigenvector of a symmetric 4x4 found by a fixed 6-sweep
  cyclic Jacobi eigensolver, with the same sweep order and the same
  ``argmax``-on-the-diagonal eigenvector pick as the JAX package;
- :func:`procrustes_align_svd`: SVD Kabsch with the det-sign fix, kept as
  the oracle in tests.
"""
from __future__ import annotations

import torch


def _quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack(
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            dim=-1,
        ),
        torch.stack(
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            dim=-1,
        ),
        torch.stack(
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            dim=-1,
        ),
    ]
    return torch.stack(rows, dim=-2)


def _horn_n_matrix(m: torch.Tensor) -> torch.Tensor:
    """Horn's 4x4 N matrix from the 3x3 correlation S[i,j] = sum a_i b_j."""
    sxx, sxy, sxz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    syx, syy, syz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    szx, szy, szz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    rows = [
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], dim=-1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], dim=-1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _givens(p: int, q: int, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Batched 4x4 Givens rotation in the (p, q) plane."""
    j = torch.eye(4, dtype=c.dtype, device=c.device).repeat(*c.shape, 1, 1)
    j[..., p, p] = c
    j[..., q, q] = c
    j[..., p, q] = s
    j[..., q, p] = -s
    return j


_JACOBI_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _sym4_max_eigvec(a: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """Dominant eigenvector of batched symmetric 4x4 via cyclic Jacobi with
    a fixed sweep count."""
    v = torch.eye(4, dtype=a.dtype, device=a.device).expand_as(a)
    for _ in range(sweeps):
        for p, q in _JACOBI_PAIRS:
            apq = a[..., p, q]
            app = a[..., p, p]
            aqq = a[..., q, q]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            j = _givens(p, q, torch.cos(theta), torch.sin(theta))
            a = j.transpose(-1, -2) @ a @ j
            v = v @ j
    idx = torch.diagonal(a, dim1=-2, dim2=-1).argmax(dim=-1)  # first max
    vec = torch.gather(v, -1, idx[..., None, None].expand(*idx.shape, 4, 1))[..., 0]
    return vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)


def _dominant_rotation(m: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """Optimal proper rotation for correlation ``m`` (Horn's method)."""
    scale = torch.sqrt((m * m).sum(dim=(-2, -1)) + 1e-30)
    n = _horn_n_matrix(m / scale[..., None, None])
    return _quat_to_matrix(_sym4_max_eigvec(n, sweeps))


def _rigid(rot: torch.Tensor, from_mean: torch.Tensor, to_mean: torch.Tensor):
    trans = to_mean - (rot @ from_mean[..., None])[..., 0]
    out = torch.zeros(*rot.shape[:-2], 4, 4, dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = trans
    out[..., 3, 3] = 1.0
    return out


def _correlation(from_points, to_points):
    from_mean = from_points.mean(dim=1)
    to_mean = to_points.mean(dim=1)
    from_c = from_points - from_mean[:, None, :]
    to_c = to_points - to_mean[:, None, :]
    return from_c.transpose(-1, -2) @ to_c, from_mean, to_mean


def procrustes_align_quat(
    from_points: torch.Tensor,  # [B, N, 3]
    to_points: torch.Tensor,  # [B, N, 3]
    iters: int = 6,
) -> torch.Tensor:  # [B, 4, 4]
    m, from_mean, to_mean = _correlation(from_points, to_points)
    return _rigid(_dominant_rotation(m, iters), from_mean, to_mean)


def procrustes_align_svd(
    from_points: torch.Tensor,  # [B, N, 3]
    to_points: torch.Tensor,  # [B, N, 3]
) -> torch.Tensor:  # [B, 4, 4]
    m, from_mean, to_mean = _correlation(from_points, to_points)
    u, _, vh = torch.linalg.svd(m)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    w = torch.eye(3, dtype=m.dtype, device=m.device).repeat(m.shape[0], 1, 1)
    w[..., 2, 2] = det
    rot = v @ w @ u.transpose(-1, -2)
    return _rigid(rot, from_mean, to_mean)


def procrustes_align(
    from_points: torch.Tensor, to_points: torch.Tensor, method: str = "quat"
) -> torch.Tensor:
    """Dispatch: "quat" (default) or "svd" (oracle)."""
    if method == "quat":
        return procrustes_align_quat(from_points, to_points)
    if method == "svd":
        return procrustes_align_svd(from_points, to_points)
    raise ValueError(f"unknown procrustes method: {method}")
