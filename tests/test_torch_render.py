"""Port parity for the synthetic renderers: ``umetrack_torch/utils/render.py``
(ray grids, ray-capsule intersection, occlusion order, a rendered frame)
and the rendered part of ``utils/synthetic.py`` (``make_labels_dict``, the
stroke style, ``make_torchdata_sample(render=True)``) against the JAX
package on the same seeded inputs."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from umetrack_tpu.utils import render as JR
from umetrack_tpu.utils import synthetic as JS
from umetrack_torch.utils import render as R
from umetrack_torch.utils import synthetic as S
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)


def test_ray_grids_equal_the_jax_package_and_round_trip():
    """Projecting a point along each pixel's ray lands on that pixel."""
    rays = R.fisheye_ray_grid(S.CAM_JS)
    assert rays.shape == (480, 640, 3) and rays.dtype == np.float32
    np.testing.assert_array_equal(rays, JR.fisheye_ray_grid(JS.CAM_JS))
    ys, xs = np.mgrid[40:440:57, 40:600:83]
    pix = S._project_fisheye_np(rays[ys, xs] * 300.0, S.CAM_JS)
    np.testing.assert_allclose(pix[..., 0], xs, atol=1e-3)
    np.testing.assert_allclose(pix[..., 1], ys, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(rays, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(
        S._project_fisheye_np(rays[ys, xs] * 300.0, S.CAM_JS),
        JS._project_fisheye_np(rays[ys, xs] * 300.0, JS.CAM_JS),
    )
    k = np.array([[200.0, 0, 79.5], [0, 200.0, 59.5], [0, 0, 1]])
    pin = R.pinhole_ray_grid(k, 120, 160)
    np.testing.assert_array_equal(pin, JR.pinhole_ray_grid(k, 120, 160))
    pts = pin[34, 101] * 157.0
    np.testing.assert_allclose(pts[0] / pts[2] * 200 + 79.5, 101, atol=1e-4)
    np.testing.assert_allclose(pts[1] / pts[2] * 200 + 59.5, 34, atol=1e-4)


def _cap(d, a, b, r):
    """The port's intersection on a [1, n] grid of rays, as a flat array."""
    return R._ray_capsule(torch.tensor(d)[None], torch.tensor(a), torch.tensor(b), r)[0].numpy()


CAPSULE_CASES = {
    # a == b is a sphere: the straight-ahead ray hits at center_z - r
    "sphere": ([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]], [0.0, 0.0, 100.0], [0.0, 0.0, 100.0], 10.0,
               [90.0, None]),
    # along x at z = 50: a ray down +z hits the body; a ray along the axis misses
    "body_and_parallel": ([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], [-10.0, 0.0, 50.0],
                          [10.0, 0.0, 50.0], 5.0, [45.0, None]),
    # a ray past the body's end hits the cap's sphere; one behind the origin misses
    "cap_and_behind": ([[0.6, 0.0, 0.8], [0.0, 0.0, -1.0]], [0.0, 0.0, 50.0], [30.0, 0.0, 50.0], 8.0,
                       [None, None]),
}


@pytest.mark.parametrize("name", sorted(CAPSULE_CASES))
def test_ray_capsule_cases_match_jax(name):
    d, a, b, r, want = CAPSULE_CASES[name]
    d = np.asarray(d, np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ours = _cap(d, np.asarray(a, np.float32), np.asarray(b, np.float32), r)
    ref = np.asarray(JR._ray_capsule(jnp.asarray(d), jnp.asarray(a, jnp.float32),
                                     jnp.asarray(b, jnp.float32), jnp.asarray(r, jnp.float32)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    for got, w in zip(ours, want):
        if w is not None:
            np.testing.assert_allclose(got, w, rtol=1e-5)
    assert ours[1] >= R.BIG  # every case's second ray misses
    if name == "cap_and_behind":
        assert 50.0 < ours[0] < 70.0


def test_ray_capsule_random_rays_match_jax():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((500, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = np.asarray([-20.0, 10.0, 120.0], np.float32)
    b = np.asarray([25.0, -15.0, 150.0], np.float32)
    ours = _cap(d, a, b, 30.0)
    ref = np.asarray(JR._ray_capsule(jnp.asarray(d), jnp.asarray(a), jnp.asarray(b), jnp.float32(30.0)))
    hit = ref < JR.BIG
    assert 20 < hit.sum() < 480
    np.testing.assert_array_equal(ours < R.BIG, hit)
    np.testing.assert_allclose(ours[hit], ref[hit], rtol=1e-4)


def test_trace_occlusion_order():
    """Two capsules on one ray: the nearer wins whatever their order, with
    its albedo and a normal that faces the camera."""
    rays = torch.tensor([[[0.0, 0.0, 1.0]]])  # [1, 1, 3]
    for order in ([200.0, 100.0], [100.0, 200.0]):
        cap = torch.tensor([[0.0, 0.0, order[0]], [0.0, 0.0, order[1]]])
        albedo = torch.tensor([0.25, 0.75] if order[1] == 100.0 else [0.75, 0.25])
        depth, normal, alb = R._trace(rays, cap, cap, torch.tensor([10.0, 10.0]), albedo)
        np.testing.assert_allclose(float(depth[0, 0]), 90.0, rtol=1e-5)
        np.testing.assert_allclose(float(alb[0, 0]), 0.75)
        np.testing.assert_allclose(normal[0, 0].numpy(), [0.0, 0.0, -1.0], atol=1e-5)
    # a ray that hits nothing keeps BIG
    depth, _, _ = R._trace(torch.tensor([[[0.0, 1.0, 0.0]]]), cap, cap, torch.tensor([10.0, 10.0]), albedo)
    assert float(depth[0, 0]) >= R.BIG
    jdepth, jnormal, jalb = JR._trace(jnp.asarray(rays.numpy()), jnp.asarray(cap.numpy()),
                                      jnp.asarray(cap.numpy()), jnp.asarray([10.0, 10.0]),
                                      jnp.asarray(albedo.numpy()))
    np.testing.assert_allclose(float(jdepth[0, 0]), 90.0, rtol=1e-5)


def test_capsules_from_landmarks_equal_jax():
    lm = np.random.default_rng(1).normal(0, 50, (3, 2, 21, 3)).astype(np.float32)
    ours = R.capsules_from_landmarks(lm, radius_scale=1.1)
    ref = JR.capsules_from_landmarks(lm, radius_scale=1.1)
    c = 2 * len(R.BONES)
    assert ours[0].shape == (3, c, 3) and ours[2].shape == (c,)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert R.BONES == JR.BONES and R.BONE_RADIUS_MM == JR.BONE_RADIUS_MM
    assert R.BONE_ALBEDO == JR.BONE_ALBEDO


def _small_scene(t=2, h=120, w=160):
    labels, bg = JS.make_labels_dict(t, rng_seed=11, render=False)
    lm = JS.tracker_gt_landmarks(labels["hand_model"], labels["joint_angles"], labels["wrist_transforms"])
    cams = [dict(JS.CAM_JS, ImageSizeX=w, ImageSizeY=h, fx=275.0 * w / 640, fy=275.0 * w / 640,
                 cx=(w - 1) / 2, cy=(h - 1) / 2) for _ in range(JS.N_CAMS)]
    step = 640 // w
    return labels, lm, JS.make_camera_poses(), cams, np.ascontiguousarray(bg[:, :, ::step, ::step])


def test_rendered_frames_match_jax_within_one_grey_level():
    """The same landmarks, cameras, background and generator state through
    both tracers (4 cameras x 120 x 160, two frames): every draw is taken in
    the JAX package's order, so both shade alike; pixels may differ by one
    grey level where the shaded value rounds the other way, and a handful at
    capsule boundaries, where a ray's nearest capsule flips, by more."""
    labels, lm, cam_poses, cams, bg = _small_scene()
    ours = R.render_sequence(lm, cam_poses, cams, bg, np.random.default_rng(5), device="cpu")
    ref = JR.render_sequence(lm, cam_poses, cams, bg, np.random.default_rng(5))
    assert ours.shape == ref.shape == bg.shape and ours.dtype == np.uint8
    drawn = ref != bg
    assert drawn.mean() > 0.01  # the hands are there
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    n_off, n_far = int((diff > 0).sum()), int((diff > 1).sum())
    assert n_off <= diff.size * 5e-4, f"{n_off} of {diff.size} pixels differ"
    assert n_far <= 4, f"{n_far} pixels differ by more than one grey level (max {diff.max()})"
    # the generators were left in the same state
    again = R.render_sequence(lm, cam_poses, cams, bg, np.random.default_rng(5), device="cpu")
    np.testing.assert_array_equal(ours, again)
    other = R.render_sequence(lm, cam_poses, cams, bg, np.random.default_rng(6), device="cpu")
    assert (other != ours).any()
    # a tensor background on the tracer's device is taken as it is
    np.testing.assert_array_equal(
        R.render_sequence(lm, cam_poses, cams, torch.from_numpy(bg), np.random.default_rng(5), device="cpu"), ours
    )


def test_render_pinhole_sequence_matches_jax():
    labels, lm, cam_poses, _, bg = _small_scene(t=1, h=60, w=80)
    k = np.asarray([[100.0, 0, 39.5], [0, 100.0, 29.5], [0, 0, 1]], np.float32)
    intr = np.stack([k, k])
    ours = R.render_pinhole_sequence(lm[:, :1], cam_poses[:2], intr, bg[:, :2], np.random.default_rng(3), device="cpu")
    ref = JR.render_pinhole_sequence(lm[:, :1], cam_poses[:2], intr, bg[:, :2], np.random.default_rng(3))
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert (ref != bg[:, :2]).mean() > 0.01
    assert (diff > 1).sum() <= 2 and (diff > 0).sum() <= diff.size * 1e-3


def test_make_labels_dict_labels_equal_jax_and_deterministic():
    """Labels equal the JAX package's key by key for the same seed, mode and
    scale (the images' noise is upsampled by another library: compared by
    shape, type and statistics); the same seed gives the same images."""
    kw = dict(rng_seed=21, mode="hand_hand", hand_scale=0.93)
    labels, images = S.make_labels_dict(2, render_style="strokes", **kw, device="cpu")
    jlabels, jimages = JS.make_labels_dict(2, render_style="strokes", **kw)
    assert list(labels) == list(jlabels)
    for key in jlabels:
        if key == "hand_model":
            assert list(labels[key]) == list(jlabels[key])
            for k2, v in jlabels[key].items():
                np.testing.assert_allclose(np.asarray(labels[key][k2], np.float64),
                                           np.asarray(v, np.float64), rtol=1e-7, err_msg=k2)
        elif key == "cameras":
            assert labels[key] == jlabels[key]
        else:
            np.testing.assert_array_equal(np.asarray(labels[key]), np.asarray(jlabels[key]), err_msg=key)
    assert images.shape == jimages.shape == (2, S.N_CAMS, 480, 640) and images.dtype == np.uint8
    # the same strokes over nearly the same noise
    assert np.abs(images.astype(np.int16) - jimages.astype(np.int16)).mean() < 1.0
    assert ((images > 100) == (jimages > 100)).mean() > 0.999
    _, again = S.make_labels_dict(2, render_style="strokes", **kw, device="cpu")
    np.testing.assert_array_equal(images, again)
    _, plain = S.make_labels_dict(2, render=False, **kw, device="cpu")
    assert (images != plain).mean() > 0.005  # the hands were drawn
    lm = S.tracker_gt_landmarks(labels["hand_model"], labels["joint_angles"], labels["wrist_transforms"])
    np.testing.assert_allclose(
        lm, JS.tracker_gt_landmarks(jlabels["hand_model"], jlabels["joint_angles"],
                                    jlabels["wrist_transforms"]), atol=1e-3)
    with pytest.raises(ValueError, match="render style"):
        S.make_labels_dict(1, render_style="oil", device="cpu")


def test_capsule_labels_dict_draws_the_hands_where_the_landmarks_project():
    assert S.DEFAULT_RENDER_STYLE == JS.DEFAULT_RENDER_STYLE == "capsule"
    labels, images = S.make_labels_dict(1, rng_seed=11, device="cpu")
    _, bg_only = S.make_labels_dict(1, rng_seed=11, render=False, device="cpu")
    lm = S.tracker_gt_landmarks(labels["hand_model"], labels["joint_angles"], labels["wrist_transforms"])
    w2c = np.linalg.inv(np.asarray(labels["camera_to_world_transforms"][0], np.float64))
    touched = total = 0
    for c in range(S.N_CAMS):
        pix = S._project_fisheye_np(lm[0] @ w2c[c, :3, :3].T + w2c[c, :3, 3], labels["cameras"][c])
        for hand in range(2):
            for l in (5, 20):  # wrist, palm center
                x, y = pix[hand, l]
                if 0 <= x < 640 and 0 <= y < 480:
                    total += 1
                    touched += images[0, c, int(y), int(x)] != bg_only[0, c, int(y), int(x)]
    assert total >= 8 and touched / total > 0.7


def test_make_torchdata_sample_rendered():
    mono, labels = S.make_torchdata_sample(rng_seed=2, t=2, h=60, w=80, hand_idx=0, render=True, device="cpu")
    plain, plain_labels = S.make_torchdata_sample(rng_seed=2, t=2, h=60, w=80, hand_idx=0)
    assert mono.shape == plain.shape == (2, 2, 60, 80) and mono.dtype == np.uint8
    assert labels["joint_angles"] == plain_labels["joint_angles"]
    assert labels["enclosing_points"] == plain_labels["enclosing_points"]
    # the hand is drawn around the projection of its wrist
    extr = np.asarray(labels["extrinsics"][0][0])
    k = np.asarray(labels["intrinsics"][0][0])
    wrist_eye = extr[:3, :3] @ np.asarray(labels["wrist"][0])[:3, 3] + extr[:3, 3]
    u, v = (k @ (wrist_eye / wrist_eye[2]))[:2]
    assert 0 <= u < 80 and 0 <= v < 60
    again, _ = S.make_torchdata_sample(rng_seed=2, t=2, h=60, w=80, hand_idx=0, render=True, device="cpu")
    np.testing.assert_array_equal(mono, again)
    # a shaded surface is flat where the noise behind it rolls: around the
    # wrist most pixels share one grey level
    patch = mono[0, 0, int(v) - 3: int(v) + 4, int(u) - 3: int(u) + 4]
    assert np.bincount(patch.ravel()).max() >= 20


@pytest.mark.parametrize("call", [
    lambda: S.make_labels_dict(1, rng_seed=0),
    lambda: S.make_labels_dict(1, rng_seed=0, render=False),
    lambda: S.render_fisheye_sequence(np.zeros((1, 2, 21, 3), np.float32), np.eye(4)[None], [S.CAM_JS], None),
    lambda: S.make_torchdata_sample(rng_seed=0, t=1, h=60, w=80, render=True),
    lambda: R.render_sequence(np.zeros((1, 2, 21, 3), np.float32), np.eye(4)[None], [S.CAM_JS],
                              np.zeros((1, 1, 48, 64), np.uint8), np.random.default_rng(0)),
    lambda: R.render_pinhole_sequence(np.zeros((1, 1, 21, 3), np.float32), np.eye(4)[None],
                                      np.eye(3)[None], np.zeros((1, 1, 48, 64), np.uint8),
                                      np.random.default_rng(0)),
    lambda: S.smooth_images(np.random.default_rng(0), 1, n=1, h=48, w=64),
    lambda: S.our_sequence(*S.make_labels_dict(1, rng_seed=0, render=False, device="cpu")),
], ids=["make_labels_dict", "make_labels_dict_noise", "render_fisheye_sequence",
        "make_torchdata_sample", "render_sequence", "render_pinhole_sequence",
        "smooth_images", "our_sequence"])
def test_generators_render_on_the_card_unless_asked_for_the_cpu(call, monkeypatch):
    """No device given means CUDA: without a card the call raises and never
    renders on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
