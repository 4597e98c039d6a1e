"""Port parity: geometry (affine, fisheye62 cameras, crop-camera fit) of
``umetrack_torch`` against ``umetrack_tpu`` on the same numpy inputs."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from umetrack_tpu.geometry import affine as jaffine
from umetrack_tpu.geometry import cameras as jcams
from umetrack_tpu.geometry.crop import gen_crop_camera_from_points as jfit
from umetrack_torch.geometry import affine, cameras
from umetrack_torch.geometry.crop import gen_crop_camera_from_points

# float32 on both sides; the closed forms agree to a few ulps of their
# magnitudes (rotations ~1, translations ~1e2-1e3 mm).
ATOL = 1e-5


def _rigid(rng, n):
    r = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(n)])
    r *= np.sign(np.linalg.det(r))[:, None, None]
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = r
    m[:, :3, 3] = rng.uniform(-300, 300, (n, 3))
    return m.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_affine_matches_jax():
    rng = np.random.default_rng(0)
    m = _rigid(rng, 5)
    v = rng.uniform(-100, 100, (5, 3)).astype(np.float32)
    aa = np.concatenate(
        [rng.standard_normal((4, 3)), np.zeros((1, 3))]  # incl. the zero rotation
    ).astype(np.float32)
    deg = rng.uniform(-180, 180, 5).astype(np.float32)
    _close(affine.rigid_inverse(_t(m)), jaffine.rigid_inverse(jnp.asarray(m)), atol=1e-4)
    _close(affine.transform3(_t(m), _t(v)), jaffine.transform3(jnp.asarray(m), jnp.asarray(v)), atol=1e-3)
    _close(affine.transform_vec3(_t(m), _t(v)), jaffine.transform_vec3(jnp.asarray(m), jnp.asarray(v)), atol=1e-3)
    _close(affine.rodrigues(_t(aa)), jaffine.rodrigues(jnp.asarray(aa)))
    _close(affine.rot_z(_t(deg)), jaffine.rot_z(jnp.asarray(deg)))
    center = rng.uniform(-50, 50, (5, 3)).astype(np.float32)
    _close(
        affine.make_look_at_matrix(_t(m), _t(center), _t(deg)),
        jaffine.make_look_at_matrix(jnp.asarray(m), jnp.asarray(center), jnp.asarray(deg)),
        atol=1e-3,
    )


def test_cameras_match_jax():
    rng = np.random.default_rng(1)
    v = rng.uniform(-200, 200, (64, 3)).astype(np.float32)
    v[:, 2] = rng.uniform(-50, 500, 64)
    v[0] = [0.0, 0.0, 300.0]  # on-axis: eps=1e-18 keeps it finite
    coeffs = np.asarray([0.35, 0.27, -0.5, 0.4, 1e-4, -2e-4, 0.0, 0.0], np.float32)
    p = cameras.arctan_project(_t(v))
    assert torch.isfinite(p).all()
    _close(p, jcams.arctan_project(jnp.asarray(v)))
    _close(
        cameras.fisheye62_distort(_t(coeffs), p),
        jcams.fisheye62_distort(jnp.asarray(coeffs), jnp.asarray(p.numpy())),
    )
    t_wfe = _rigid(rng, 1)[0]
    fields = dict(fx=275.0, fy=270.0, cx=319.5, cy=239.5, width=640.0, height=480.0)
    cam = cameras.Fisheye62Camera(
        **{k: torch.tensor(x) for k, x in fields.items()},
        T_world_from_eye=_t(t_wfe), coeffs=_t(coeffs),
    )
    jcam = jcams.Fisheye62Camera(
        **{k: jnp.asarray(x, jnp.float32) for k, x in fields.items()},
        T_world_from_eye=jnp.asarray(t_wfe), coeffs=jnp.asarray(coeffs),
    )
    _close(cam.world_to_window(_t(v)), jcam.world_to_window(jnp.asarray(v)), atol=2e-2)


@pytest.mark.parametrize("mirror", [False, True])
def test_crop_fit_matches_jax(mirror):
    rng = np.random.default_rng(2)
    cam_to_world = np.eye(4, dtype=np.float32)
    cam_to_world[:3, 3] = [30.0, -20.0, -400.0]
    pts = rng.uniform(-60, 60, (63, 3)).astype(np.float32)
    ours = gen_crop_camera_from_points(
        _t(cam_to_world), _t(pts), (96, 96), torch.tensor(mirror), torch.tensor(180.0)
    )
    ref = jfit(jnp.asarray(cam_to_world), jnp.asarray(pts), (96, 96), mirror, 180.0)
    assert bool(ours.valid) and bool(ref.valid)
    _close(ours.intrinsics_matrix(), ref.intrinsics_matrix(), atol=1e-3, rtol=1e-4)
    _close(ours.T_world_from_eye, ref.T_world_from_eye, atol=5e-3, rtol=1e-4)


def test_crop_fit_degenerate_is_invalid_and_finite():
    """Points behind the camera flag the crop invalid instead of raising,
    and the guarded division keeps every field finite, as in the JAX
    package."""
    cam_to_world = np.eye(4, dtype=np.float32)
    pts = np.zeros((21, 3), np.float32)  # all at the camera center: z = 0
    ours = gen_crop_camera_from_points(
        _t(cam_to_world), _t(pts), (96, 96), torch.tensor(False), torch.tensor(0.0)
    )
    ref = jfit(jnp.asarray(cam_to_world), jnp.asarray(pts), (96, 96), False, 0.0)
    assert not bool(ours.valid) and not bool(ref.valid)
    assert torch.isfinite(ours.intrinsics_matrix()).all()
    assert torch.isfinite(ours.T_world_from_eye).all()


# tests/test_geometry.py's camera schemas, copied
FISHEYE_JSON = {
    "ImageSizeX": 640, "ImageSizeY": 480, "DistortionModel": "FishEye62",
    "fx": 275.0, "fy": 275.0, "cx": 319.5, "cy": 239.5,
    "k1": 0.35, "k2": 0.27, "k3": -0.5, "k4": 0.4, "p1": 1e-4, "p2": -2e-4,
    "k5": 0.0, "k6": 0.0,
}
PINHOLE_JSON = {
    "ImageSizeX": 96, "ImageSizeY": 96, "DistortionModel": "PinholePlane",
    "fx": 120.0, "fy": 120.0, "cx": 47.5, "cy": 47.5,
}


@pytest.mark.parametrize("schema", ["fisheye", "pinhole", "nested"])
def test_camera_from_json_matches_jax(schema):
    """The same camera type and fields as the JAX package builds, and the
    same projection of world points through the shared rigid helpers."""
    js = {"fisheye": FISHEYE_JSON, "pinhole": PINHOLE_JSON, "nested": {"Camera": PINHOLE_JSON}}[schema]
    rng = np.random.default_rng(7)
    t_wfe = _rigid(rng, 1)[0]
    t_wfe[:3, 3] *= 0.1
    cam = cameras.camera_from_json(js, t_wfe, device="cpu")
    jcam = jcams.camera_from_json(js, t_wfe)
    assert type(cam).__name__ == type(jcam).__name__
    for name in ("fx", "fy", "cx", "cy", "width", "height", "T_world_from_eye", "f", "c"):
        _close(getattr(cam, name), getattr(jcam, name))
    if schema == "fisheye":
        _close(cam.coeffs, jcam.coeffs)
    pts = rng.uniform(-50, 50, (40, 3)).astype(np.float32) + cam.eye_to_world(
        torch.tensor([0.0, 0.0, 300.0])).numpy()
    _close(cam.world_to_eye(_t(pts)), jcam.world_to_eye(jnp.asarray(pts)), atol=1e-3)
    _close(cam.eye_to_world(_t(pts)), jcam.eye_to_world(jnp.asarray(pts)), atol=1e-3)
    _close(cam.world_to_window(_t(pts)), jcam.world_to_window(jnp.asarray(pts)), atol=2e-2)


def test_camera_from_json_rejects_other_models():
    with pytest.raises(ValueError, match="Kannala"):
        cameras.camera_from_json({**PINHOLE_JSON, "DistortionModel": "Kannala"}, device="cpu")


def test_pinhole_camera_and_unprojections_match_jax():
    """``PinholeCamera`` (window <-> eye, the intrinsics matrix) and the
    perspective and arctan (un)projections against the JAX functions, and
    their round trips."""
    rng = np.random.default_rng(8)
    cam = cameras.camera_from_json(PINHOLE_JSON, device="cpu")
    jcam = jcams.camera_from_json(PINHOLE_JSON)
    assert isinstance(cam, cameras.PinholeCamera)
    _close(cam.uv_to_window_matrix(), jcam.uv_to_window_matrix())
    _close(cam.uv_to_window_matrix(), np.asarray([[120.0, 0, 47.5], [0, 120.0, 47.5], [0, 0, 1]]))
    w = rng.uniform(0, 95, (40, 2)).astype(np.float32)
    eye = cam.window_to_eye(_t(w))
    _close(eye, jcam.window_to_eye(jnp.asarray(w)))
    _close(torch.linalg.vector_norm(eye, dim=-1), np.ones(40, np.float32))
    _close(cam.eye_to_window(eye), w, atol=1e-3)  # project o unproject == id
    _close(cam.eye_to_window(eye * 250.0), jcam.eye_to_window(jnp.asarray(eye.numpy() * 250.0)), atol=1e-3)

    p = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    v = cameras.perspective_unproject(_t(p))
    _close(v, jcams.perspective_unproject(jnp.asarray(p)))
    _close(cameras.perspective_project(v), p, atol=1e-5)
    _close(cameras.perspective_project(v * 3.0), jcams.perspective_project(jnp.asarray(v.numpy() * 3.0)))

    uv = rng.uniform(-1.4, 1.4, (64, 2)).astype(np.float32)
    uv[0] = 0.0  # on-axis: sinc(0) = 1
    rays = cameras.arctan_unproject(_t(uv))
    _close(rays, jcams.arctan_unproject(jnp.asarray(uv)))
    _close(torch.linalg.vector_norm(rays, dim=-1), np.ones(64, np.float32))
    _close(cameras.arctan_project(rays), uv, atol=1e-5)  # arctan o unproject == id
