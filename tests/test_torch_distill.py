"""The port's distillation app (``umetrack_torch.apps.distill``) on the CPU:
the teacher loads from a state dict of the original UmeTrack model, the
loop trains the student and emits the evaluation metric set, and no
teacher file raises as the JAX package does without the original code."""
import math

import numpy as np
import pytest
import torch

from umetrack_torch.apps import distill
from umetrack_torch.models import ModelConfig, make_model
from umetrack_torch.models.convert import reference_module_names
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

METRICS = ("mpjpe_mm", "mpjpa_deg", "pck_auc", "success_rate", "mean_keypoint_acceleration")


@pytest.fixture(scope="module")
def teacher_file(tmp_path_factory):
    """A ``.torch`` state dict under the original model's module names
    (seeded weights at the full width of ``ModelConfig()``)."""
    model = make_model(ModelConfig(), seed=3)
    names = {ours: ref for ref, ours in reference_module_names().items()}
    sd = {}
    for key, value in model.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        sd[f"{names[path]}.{leaf}"] = value
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.torch")
    torch.save(sd, path)
    return path, model


def test_teacher_round_trip(teacher_file):
    path, model = teacher_file
    teacher = distill.build_teacher(path, device="cpu")
    assert not teacher.training
    loaded = teacher.state_dict()
    for key, value in model.state_dict().items():
        assert torch.equal(loaded[key], value), key


def test_teacher_from_a_checkpoint_directory(teacher_file, tmp_path):
    """An orbax directory (the distillation's own ``ckpt_step_*``) is a
    teacher as well as a file."""
    from umetrack_torch.utils.checkpoints import save_checkpoint

    _, model = teacher_file
    path = save_checkpoint(str(tmp_path / "ckpt_step_0000000"), model.state_dict())
    loaded = distill.build_teacher(path, device="cpu").state_dict()
    for key, value in model.state_dict().items():
        assert torch.equal(loaded[key], value), key


@pytest.mark.parametrize("checkpoint", [None, "/nonexistent/teacher.torch"])
def test_no_teacher_file_raises(checkpoint):
    with pytest.raises(FileNotFoundError, match="teacher"):
        distill.build_teacher(checkpoint, device="cpu")


def test_distillation_runs_and_emits_the_metric_set(teacher_file, tmp_path):
    path, _ = teacher_file
    gaps, final = distill.run_distillation(
        steps=4, batch_size=2, eval_every=2, n_eval_sequences=1, teacher_checkpoint=path,
        out_dir=str(tmp_path), device="cpu",
    )
    assert len(gaps) == 3 and all(math.isfinite(g) for g in gaps)
    assert final["distill_gap_mm"] == gaps
    for key in METRICS:
        assert key in final and np.isfinite(final[key]), (key, final)
    # the JAX app's names: orbax directories ckpt_step_{step:07d}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_step_0000000", "ckpt_step_0000002", "ckpt_step_0000003"]
    assert all((p / "manifest.ocdbt").is_file() for p in tmp_path.iterdir())
