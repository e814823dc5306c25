"""The training driver ``repro_torch.launch.train`` on the rwkv6, zamba2,
VLM, Whisper and MoE (deepseek-v2-lite) smoke configs on the CPU: ``main``
builds each family's step and batches (the VLM's patches, Whisper's
frames), runs its steps under ``TrainerLoop`` and restores from its own
checkpoint (deepseek: the restart's loss equals the uninterrupted run's);
``build`` refuses a VLM sequence that leaves no room for text after the
patches.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402

ARCHS = ("rwkv6-1.6b", "zamba2-1.2b", "internvl2-2b", "whisper-base",
         "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_and_resumes(arch, tmp_path):
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "24", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    out = train.main(argv)
    assert out["step"] == 2 and len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    again = train.main(argv[:4] + ["3"] + argv[5:])
    assert again["step"] == 3 and len(again["losses"]) == 1


def test_vlm_sequence_must_exceed_its_patches():
    with pytest.raises(ValueError, match="patches"):
        train.build("internvl2-2b", True, 2, 8, 1e-3, 2, device="cpu")


def test_moe_train_main_resumes_the_same_losses(tmp_path):
    """deepseek-v2-lite smoke, 3 steps with a checkpoint every 2: a
    second ``main`` on the same directory restores step 2 and runs step 3
    to the uninterrupted run's loss, bit for bit (the batch stream
    restarts at the restored step)."""
    argv = ["--arch", "deepseek-v2-lite-16b", "--smoke", "--steps", "3",
            "--batch", "2", "--seq", "24", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    whole = train.main(argv)
    assert whole["step"] == 3 and len(whole["losses"]) == 3
    again = train.main(argv)
    assert again["step"] == 3 and again["losses"] == whole["losses"][2:]
