"""The training driver ``repro_torch.launch.train`` on the rwkv6, zamba2,
VLM and Whisper smoke configs on the CPU: ``main`` builds each family's
step and batches (the VLM's patches, Whisper's frames), runs its steps
under ``TrainerLoop`` and restores from its own checkpoint; ``build``
refuses a VLM sequence that leaves no room for text after the patches.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402

ARCHS = ("rwkv6-1.6b", "zamba2-1.2b", "internvl2-2b", "whisper-base")


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
