"""The port's last small public names against the JAX package's on the CPU:
``kinematics.load_hand_model_json`` and ``data.fs.open_file`` /
``read_bytes``."""
import numpy as np

from conftest import GENERIC_HAND_JSON
from umetrack_tpu.data import fs as jfs
from umetrack_tpu.kinematics import load_hand_model_json as jload_hand
from umetrack_torch.data import fs
from umetrack_torch.kinematics import HandModel, load_hand_model_json


def test_load_hand_model_json_matches_jax():
    ours, ref = load_hand_model_json(GENERIC_HAND_JSON), jload_hand(GENERIC_HAND_JSON)
    assert isinstance(ours, HandModel)
    for name in ("joint_rotation_axes", "joint_rest_positions", "landmark_rest_positions",
                 "landmark_rest_bone_weights", "landmark_rest_bone_indices", "joint_limits"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), name)


def test_open_file_and_read_bytes_match_jax(tmp_path):
    path = str(tmp_path / "blob.bin")
    with fs.open_file(path, "wb") as fp:
        fp.write(bytes(range(200)))
    for start, stop in [(None, None), (0, 10), (5, None), (17, 150), (199, 200)]:
        assert fs.read_bytes(path, start, stop) == jfs.read_bytes(path, start, stop), (start, stop)
    with fs.open_file(path) as a, jfs.open_file(path) as b:
        assert a.read() == b.read()
