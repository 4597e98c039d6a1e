"""The capsule ray-traced hand renderer of the benchmark's traffic.

A copy of the port's ``utils/render.py`` (fisheye views only), kept here
so that a change to the program cannot change what the benchmark feeds it:

- every hand is a soup of capsules around its skinned bone segments (the
  21-segment topology, with anatomical radii),
- each pixel's camera ray (fisheye62 unprojection, precomputed per camera)
  is intersected against ALL capsules of BOTH hands: a shared z-buffer, so
  self-occlusion between fingers and mutual occlusion between hands are
  exact,
- hits are Lambert + Blinn-Phong shaded with a per-sequence random light,
  plus a mild depth cue.

Every random draw comes from the caller's ``np.random.Generator``; the
trace runs on the given device and the frames stay there.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


BIG = 1e9

# Bone segments between landmarks, identical topology to synthetic._BONES:
# thumb chain, 4 fingers x 4 segments, wrist->palm.  Landmark order: 0-4
# fingertips, 5 wrist, 6-7 thumb frames, 8-19 finger frames, 20 palm center.
BONES = (
    (5, 6), (6, 7), (7, 0),
    (5, 8), (8, 9), (9, 10), (10, 1),
    (5, 11), (11, 12), (12, 13), (13, 2),
    (5, 14), (14, 15), (15, 16), (16, 3),
    (5, 17), (17, 18), (18, 19), (19, 4),
    (5, 20),
)
# Capsule radii (mm): half the stroke widths the 2-D renderer used
# (synthetic._BONE_WIDTH_MM), which were themselves anatomical diameters.
BONE_RADIUS_MM = (
    11.0, 9.0, 7.5,
    8.5, 7.5, 6.5, 5.5,
    9.0, 8.0, 7.0, 6.0,
    8.5, 7.5, 6.5, 5.5,
    7.0, 6.0, 5.5, 5.0,
    17.0,
)
# Per-bone albedo in [0, 1]: one band per finger (the stroke renderer's
# _BONE_GRAY), so digits stay visually distinguishable in mono.
BONE_ALBEDO = tuple(
    g / 255.0
    for g in (
        150, 150, 150,
        170, 170, 170, 170,
        190, 190, 190, 190,
        210, 210, 210, 210,
        230, 230, 230, 230,
        140,
    )
)


@lru_cache(maxsize=16)
def _fisheye_ray_grid_cached(params: tuple, h: int, w: int) -> np.ndarray:
    (fx, fy, cx, cy, k1, k2, k3, k4, p1, p2, k5, k6) = params

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    qx = (xs - cx) / fx
    qy = (ys - cy) / fy
    q = np.stack([qx, qy], axis=-1)  # distorted normalized coords

    # Invert the forward model (geometry/cameras.py fisheye62_distort):
    # forward is uv = u * radial(|u|^2), then
    # xd = uv + tangential(uv).  Inverse in two stages:
    # 1) tangential by fixed point (p1/p2 are ~1e-4 — contraction is fast):
    uv = q.copy()
    for _ in range(8):
        ux, uy = uv[..., 0], uv[..., 1]
        r2t = ux * ux + uy * uy
        tx = 2 * p2 * ux * uy + p1 * (r2t + 2 * ux * ux)
        ty = 2 * p1 * ux * uy + p2 * (r2t + 2 * uy * uy)
        uv = q - np.stack([tx, ty], axis=-1)
    # 2) radial by scalar Newton on the monotone g(s) = s * radial(s^2) = m
    # (plain fixed-point diverges where radial >> 1 — the outer 18% of the
    # image at these coefficients):
    m = np.linalg.norm(uv, axis=-1)
    s = np.minimum(m, 1.5)
    for _ in range(30):
        s2 = s * s
        radial = (
            1 + k1 * s2 + k2 * s2 ** 2 + k3 * s2 ** 3 + k4 * s2 ** 4
            + k5 * s2 ** 5 + k6 * s2 ** 6
        )
        dradial = (
            k1 + 2 * k2 * s2 + 3 * k3 * s2 ** 2 + 4 * k4 * s2 ** 3
            + 5 * k5 * s2 ** 4 + 6 * k6 * s2 ** 5
        )
        g = s * radial - m
        gp = radial + 2 * s2 * dradial
        s = np.clip(s - g / np.where(np.abs(gp) > 1e-9, gp, 1.0), 0.0, np.pi)
    with np.errstate(invalid="ignore"):
        u = uv * np.where(m > 1e-12, s / np.maximum(m, 1e-12), 0.0)[..., None]

    # convergence check through the forward model
    r2 = np.clip(np.sum(u * u, axis=-1), 0.0, np.pi ** 2)
    radial = (
        1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3 + k4 * r2 ** 4
        + k5 * r2 ** 5 + k6 * r2 ** 6
    )
    ux, uy = u[..., 0] * radial, u[..., 1] * radial
    r2t = ux * ux + uy * uy
    fwd = np.stack(
        [
            ux + 2 * p2 * ux * uy + p1 * (r2t + 2 * ux * ux),
            uy + 2 * p1 * ux * uy + p2 * (r2t + 2 * uy * uy),
        ],
        axis=-1,
    )
    ok = np.linalg.norm(fwd - q, axis=-1) < 1e-6

    # u is the arctan-projected point: |u| = angle from +z (equidistant).
    theta = np.linalg.norm(u, axis=-1)
    sin_t = np.sin(theta)
    dirs = np.where(
        theta[..., None] > 1e-12, u / np.maximum(theta, 1e-12)[..., None], 0.0
    )
    rays = np.stack(
        [sin_t * dirs[..., 0], sin_t * dirs[..., 1], np.cos(theta)], axis=-1
    )
    # nonconverged pixels (beyond the invertible image circle) get a
    # backward ray so they can never hit geometry in front of the camera
    rays = np.where(ok[..., None], rays, np.array([0.0, 0.0, -1.0]))
    return rays.astype(np.float32)


def fisheye_ray_grid(cam_js: dict, h: int | None = None,
                     w: int | None = None) -> np.ndarray:
    """Unit eye-space ray per pixel [h, w, 3] for a fisheye62 camera JSON
    (the raw_data schema); cached per camera."""
    h = int(cam_js["ImageSizeY"]) if h is None else h
    w = int(cam_js["ImageSizeX"]) if w is None else w
    params = tuple(
        float(cam_js[k])
        for k in ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4",
                  "p1", "p2", "k5", "k6")
    )
    return _fisheye_ray_grid_cached(params, h, w)


def capsules_from_landmarks(lm: np.ndarray, radius_scale: float = 1.0):
    """Landmarks [..., n_hands, 21, 3] -> capsule soup
    (a [..., C, 3], b [..., C, 3], radii [C], albedo [C]) with
    C = n_hands * len(BONES); numpy, world/mm units."""
    lm = np.asarray(lm, np.float32)
    bi = np.asarray(BONES, np.int64)
    a = lm[..., bi[:, 0], :]  # [..., n_hands, 20, 3]
    b = lm[..., bi[:, 1], :]
    n_hands = lm.shape[-3]
    a = a.reshape(*lm.shape[:-3], n_hands * len(BONES), 3)
    b = b.reshape(*lm.shape[:-3], n_hands * len(BONES), 3)
    radii = np.tile(
        np.asarray(BONE_RADIUS_MM, np.float32) * radius_scale, n_hands
    )
    albedo = np.tile(np.asarray(BONE_ALBEDO, np.float32), n_hands)
    return a, b, radii, albedo


def _dot3(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``d [..., h, w, 3] . v [..., 3]`` -> ``[..., h, w]``."""
    return torch.einsum("...hwi,...i->...hw", d, v)


def _ray_capsule(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor, r) -> torch.Tensor:
    """Nearest positive intersection of unit rays ``d [..., h, w, 3]`` from
    the origin with one capsule ``(a [..., 3], b [..., 3], r)`` per leading
    batch entry: ``t [..., h, w]``, BIG for a miss.  Quadratic body + sphere
    caps."""
    ba = b - a
    oa = -a

    def per_batch(x):  # [...] -> [..., 1, 1]
        return x[..., None, None]

    baba = per_batch((ba * ba).sum(-1))
    bard = _dot3(d, ba)
    baoa = per_batch((ba * oa).sum(-1))
    rdoa = _dot3(d, oa)
    oaoa = per_batch((oa * oa).sum(-1))

    qa = baba - bard * bard  # >= 0; ~0 when the ray parallels the axis
    qb = baba * rdoa - baoa * bard
    qc = baba * oaoa - baoa * baoa - r * r * baba
    h = qb * qb - qa * qc
    safe_a = torch.where(qa > 1e-6, qa, torch.ones_like(qa))
    t_body = (-qb - torch.sqrt(torch.clamp(h, min=0.0))) / safe_a
    y = baoa + t_body * bard
    body_ok = (qa > 1e-6) & (h >= 0) & (t_body > 0) & (y >= 0) & (y <= baba)

    def cap(center):
        oc = -center
        b2 = _dot3(d, oc)
        c2 = per_batch((oc * oc).sum(-1)) - r * r
        h2 = b2 * b2 - c2
        t = -b2 - torch.sqrt(torch.clamp(h2, min=0.0))
        return torch.where((h2 >= 0) & (t > 0), t, torch.full_like(t, BIG))

    t = torch.where(body_ok, t_body, torch.full_like(t_body, BIG))
    return torch.minimum(t, torch.minimum(cap(a), cap(b)))


def _trace(
    rays: torch.Tensor,  # [..., h, w, 3] unit eye rays
    cap_a: torch.Tensor,  # [..., C, 3] eye space
    cap_b: torch.Tensor,  # [..., C, 3]
    radii: torch.Tensor,  # [C]
    albedo: torch.Tensor,  # [C]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared z-buffer over all capsules: (depth [..., h, w] with BIG for
    misses, normal [..., h, w, 3], albedo [..., h, w]).  Of two capsules at
    one depth the earlier one wins."""
    rays, cap_a, cap_b = rays.float(), cap_a.float(), cap_b.float()
    radii, albedo = radii.float(), albedo.float()
    n_caps = cap_a.shape[-2]
    batch = torch.broadcast_shapes(rays.shape[:-3], cap_a.shape[:-2])
    hw = rays.shape[-3:-1]
    t_best = torch.full((*batch, *hw), BIG, dtype=torch.float32, device=rays.device)
    best = torch.zeros((*batch, *hw), dtype=torch.int64, device=rays.device)
    for c in range(n_caps):
        t = _ray_capsule(rays, cap_a[..., c, :], cap_b[..., c, :], radii[c])
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        best = torch.where(closer, torch.full_like(best, c), best)

    def of_best(per_capsule):  # [..., C, k] -> [..., h, w, k]
        k = per_capsule.shape[-1]
        table = per_capsule.expand(*batch, n_caps, k)
        idx = best.reshape(*batch, -1, 1).expand(*batch, hw[0] * hw[1], k)
        return torch.gather(table, -2, idx).reshape(*batch, *hw, k)

    # a ray that hit nothing keeps capsule 0's geometry: finite, and unused,
    # since the shader gives such a pixel its background
    a, ba = of_best(cap_a), of_best(cap_b - cap_a)
    r, alb = radii[best], albedo[best]

    pos = rays * t_best[..., None]
    baba = torch.clamp((ba * ba).sum(-1), min=1e-6)
    yfrac = torch.clamp(((pos - a) * ba).sum(-1) / baba, 0.0, 1.0)
    n = (pos - a - ba * yfrac[..., None]) / torch.clamp(r, min=1e-6)[..., None]
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-6)
    return t_best, n, alb


def _shade(rays, depth, normal, alb, bg, light_eye, amb, diff, spec, depth_gain):
    """Mono shading: Lambert + Blinn-Phong + a mild nearer-is-brighter depth
    cue.  ``light_eye [..., 3]`` broadcasts over the rays' batch dims."""
    hit = depth < BIG
    l = -light_eye[..., None, None, :]  # direction TOWARD the light
    lam = torch.clamp((normal * l).sum(-1), min=0.0)
    half = l - rays
    half = half / torch.clamp(torch.linalg.norm(half, dim=-1, keepdim=True), min=1e-6)
    sp = torch.clamp((normal * half).sum(-1), min=0.0) ** 16
    z = depth * rays[..., 2]  # eye-space z depth (mm)
    depth_cue = 1.0 + depth_gain * (450.0 - z) / 330.0
    col = (alb * (amb + diff * lam) * depth_cue + spec * sp) * 255.0
    return torch.where(hit, torch.clamp(col, 0.0, 255.0), bg)


# Frames traced at once: bounds the tracer's working set (a dozen float
# planes per frame and camera) whatever the sequence length.
_FRAME_BLOCK = 16


@torch.inference_mode()
def render_views(
    rays: torch.Tensor,  # [N, h, w, 3] unit eye rays per camera
    world_to_cam: torch.Tensor,  # [N, 4, 4]
    cap_a: torch.Tensor,  # [T, C, 3] world (mm)
    cap_b: torch.Tensor,  # [T, C, 3]
    radii: torch.Tensor,  # [C]
    albedo: torch.Tensor,  # [C]
    bg: torch.Tensor,  # [T, N, h, w] background, 0..255
    light_world: torch.Tensor,  # [3] unit
    shade_params: torch.Tensor,  # [4]: ambient, diffuse, specular, depth_gain
) -> torch.Tensor:  # [T, N, h, w] uint8
    """Render every (frame, camera) of a sequence on the tensors' device."""
    amb, diff, spec, depth_gain = shade_params.float().unbind()
    rot = world_to_cam[:, :3, :3].float()  # [N, 3, 3]
    tr = world_to_cam[:, :3, 3].float()  # [N, 3]
    light_eye = rot @ light_world.float()  # [N, 3]
    rays = rays.float()
    out = []
    for t0 in range(0, cap_a.shape[0], _FRAME_BLOCK):
        sl = slice(t0, t0 + _FRAME_BLOCK)
        # [F, 1, C, 3] @ [N, 3, 3]^T + [N, 1, 3] -> [F, N, C, 3]
        a_eye = cap_a[sl, None].float() @ rot.transpose(-1, -2) + tr[:, None]
        b_eye = cap_b[sl, None].float() @ rot.transpose(-1, -2) + tr[:, None]
        depth, normal, alb = _trace(rays, a_eye, b_eye, radii, albedo)
        col = _shade(
            rays, depth, normal, alb, bg[sl].float(), light_eye, amb, diff, spec, depth_gain
        )
        out.append(torch.clamp(col + 0.5, 0.0, 255.0).to(torch.uint8))
    return torch.cat(out)


def _render(landmarks_world, cam_poses, rays, bg, rng, radius_scale, device) -> torch.Tensor:
    """Capsules and the per-sequence shading randomization (light direction,
    ambient/diffuse/specular levels, albedo jitter: the model must read pose
    from geometry, not from a fixed exposure), then the trace on ``device``."""
    world_to_cam = np.stack(
        [np.linalg.inv(np.asarray(p, np.float64)) for p in cam_poses]
    ).astype(np.float32)
    a, b, radii, albedo = capsules_from_landmarks(landmarks_world, radius_scale)
    albedo = albedo * rng.uniform(0.85, 1.15)
    # light from the hemisphere behind/above the cameras (z < 0 world side)
    ld = rng.standard_normal(3)
    ld[2] = -abs(ld[2]) - 0.3
    ld = (ld / np.linalg.norm(ld)).astype(np.float32)
    shade = np.asarray(
        [
            rng.uniform(0.30, 0.50),  # ambient
            rng.uniform(0.55, 0.85),  # diffuse
            rng.uniform(0.05, 0.35),  # specular
            rng.uniform(0.10, 0.30),  # depth gain
        ],
        np.float32,
    )

    def dev(x):
        return torch.as_tensor(x).to(device)

    out = render_views(
        dev(rays), dev(world_to_cam), dev(a), dev(b), dev(radii.astype(np.float32)),
        dev(albedo.astype(np.float32)), dev(bg), dev(ld), dev(shade),
    )
    return out


def render_sequence(
    landmarks_world: np.ndarray,  # [T, n_hands, 21, 3] mm
    cam_poses: np.ndarray,  # [N, 4, 4] camera-to-world
    cam_jss,  # list of N fisheye camera JSON dicts
    bg,  # [T, N, h, w] uint8 background (numpy or tensor)
    rng: np.random.Generator,
    radius_scale: float = 1.0,
    device="cuda",
) -> torch.Tensor:  # [T, N, h, w] uint8 on ``device``
    """Render a sequence into its fisheye views on ``device``."""
    h, w = bg.shape[2:]
    rays = np.stack([fisheye_ray_grid(cam_jss[c], h, w) for c in range(bg.shape[1])])
    return _render(landmarks_world, cam_poses, rays, bg, rng, radius_scale, device)
